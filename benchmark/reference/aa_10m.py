"""Plain reference of the `aa_10m` configuration: the [A][A] streaming
detector of the upstream FPGA design (docs/aa_preamble_sync_design.md §5-9,
sync_aa.py:421-571), in PyTorch.

Per sample n, over both branches (design doc §5.1, §6): P[n] is the L-sample
window sum of x[k] conj(x[k - L]) (re = i i_d + q q_d, im = q i_d - i q_d)
and R[n] the L-sample window sum of |x[k]|^2 = i^2 + q^2, each summed over
the branches; the samples before the stream are zero.  Both are exact
integers in float64 on 12-bit codes; the configuration states them in
float32, so each is rounded once to float32.  The tracked value |P|^2 and
M = min(|P|^2 / R^2, 1) are stated in float32 too: M is 0 before n = L and
where R <= 1e-6 L (the program's guards), and above = n >= L and
M >= float32(threshold).  Then the gate / peak FSM (`gates.py`) on |P|^2,
tie 'first', unclosed gates emitted; P and M are read at each event's peak,
which gives the CFO angle(P) fs / (2 pi L) and the timing peak - 2L + 1.

The program forms |P|^2 and M in float32 from the same float32 P and R, so
at a sample whose M lies within `KNIFE` of the threshold it may decide
either way, and a gate sample whose |P|^2 lies within `TIE` of the peak's
may take the peak: such samples are ambiguous, and an event that differs
from the reference's is excused where an ambiguous sample lies in or next
to its gate (the count of excused events is reported).  The captures kept
from the timed path (each input's last call) are compared at the
program's own peaks: `capture_gap` is the largest relative error of the
captured P and M, `cfo_gap_hz` the largest difference of the CFO they give.
The control computes the same with P, R, |P|^2 and M stored in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import gates as G
from benchmark.work.counts import gated_samples

#: each number compared, and its limit, with the reason for it (PERF.md
#: section 2 gives the readings: sound runs and the bfloat16 control)
LIMITS = {
    # an event the reference has and the program lacks, or the reverse,
    # with no ambiguous sample in or next to its gate
    "unexcused_events": 0,
    # |P|^2 at a matched peak: float32 rounding of a two-term sum, ~1.2e-7
    # relative; with bfloat16 storage ~1e-2
    "peak_value_gap": 1e-5,
    # P and M captured at the program's peaks: P is bit-equal to the
    # reference's float32 rounding of the exact sums, M differs by its
    # float32 rounding (~2.4e-7); with bfloat16 storage ~2e-2
    "capture_gap": 1e-5,
    # the CFO of a captured P: float32 rounding of P turns its angle by at
    # most ~1.2e-7 rad, 5.7e-4 Hz at fs / (2 pi L) = 4,775 Hz a radian; the
    # limit is 17 times that; bfloat16 storage moves the CFO by 7-10 Hz
    "cfo_gap_hz": 1e-2,
}
#: relative distance of M from the threshold within which the program's
#: float32 |P|^2, R^2 and division may decide either way (a few roundings
#: of 2^-24 each, with room)
KNIFE = 2.0**-20
#: two gate samples whose |P|^2 lie within this relative distance: a
#: rounding of the track could pick either as the peak
TIE = 2.0**-20
#: streams per block of the reference's work (bounds its memory)
ROWS = 64


def _stored(v, precision: str):
    return v.to(torch.float32 if precision == "float32" else torch.bfloat16).double()


def _lag(v, d: int):
    """v delayed by d samples along the last axis, zeros before the start."""
    return torch.nn.functional.pad(v, (d, 0))[..., : v.shape[-1]]


def _window(v, w: int):
    """Causal w-sample window sums along the last axis (float64 cumulative
    sum; exact on integers)."""
    cs = torch.cumsum(v, dim=-1)
    return cs - _lag(cs, w)


def metric(x, det: dict, precision: str = "float32"):
    """x (C, rows, n) codes -> (P_re, P_im, M, track, above, ambiguous),
    each (rows, n); P, M and track in float64 holding ``precision``'s
    values."""
    L = det["half_len"]
    xf = x.to(torch.float64)
    i, q = xf[0::2], xf[1::2]
    i_d, q_d = _lag(i, L), _lag(q, L)
    P_re = _stored(_window((i * i_d + q * q_d).sum(0), L), precision)
    P_im = _stored(_window((q * i_d - i * q_d).sum(0), L), precision)
    R = _stored(_window((i * i + q * q).sum(0), L), precision)
    track = _stored(P_re * P_re + P_im * P_im, precision)
    valid = torch.arange(x.shape[-1], device=x.device) >= L
    live = valid & (R > 1e-6 * L)
    M = _stored(torch.where(live, (track / R.clamp_min(1e-12) ** 2).clamp_max(1.0), 0.0),
                precision)
    thr = float(np.float32(det["threshold"]))
    above = valid & (M >= thr)
    amb = live & ((M - thr).abs() <= KNIFE * thr)
    return P_re, P_im, M, track, above, amb


def detect_block(x, det: dict, precision: str):
    """One block of streams: (table dict of tensors, captured P (rows, 2,
    E) and M (rows, E) at each event's peak, the metric (P_re, P_im, M),
    above, ambiguous samples)."""
    P_re, P_im, M, track, above, amb = metric(x, det, precision)
    table, _, ties = G.gate_events(
        above, track, hysteresis=det["hysteresis"], max_events=det["max_events"],
        valid_from=det["half_len"], tie=det["tie"], emit_unclosed=det["emit_unclosed"],
        tie_tol=TIE * track)
    at = table["peak_idx"].long().clamp(0, x.shape[-1] - 1)
    v = table["valid"]
    P = torch.stack([P_re.gather(-1, at), P_im.gather(-1, at)], dim=1) * v[:, None]
    return table, P, M.gather(-1, at) * v, (P_re, P_im, M), above, amb | ties


def capture_gaps(peak_idx, valid, P, M, ref, fs: float, L: int):
    """(largest relative error of P and M, largest CFO difference in Hz,
    slots compared) of the captures (P (rows, 2, E), M (rows, E)) at the
    slots' own peaks, against the reference's metric ``ref`` = (P_re, P_im,
    M) of the same rows."""
    P_re, P_im, M_ref = ref
    n = P_re.shape[-1]
    at = peak_idx.long()
    use = valid.bool() & (at >= 0) & (at < n)
    if not bool(use.any()):
        return 0.0, 0.0, 0
    at = at.clamp(0, n - 1)
    r_re, r_im, r_m = P_re.gather(-1, at), P_im.gather(-1, at), M_ref.gather(-1, at)
    p_re, p_im, p_m = P[:, 0].double(), P[:, 1].double(), M.double()
    tiny = 1e-30
    dp = torch.hypot(p_re - r_re, p_im - r_im) / torch.hypot(r_re, r_im).clamp_min(tiny)
    dm = (p_m - r_m).abs() / r_m.abs().clamp_min(tiny)
    turn = torch.atan2(p_im * r_re - p_re * r_im, p_re * r_re + p_im * r_im).abs()
    gap = float(torch.maximum(dp, dm)[use].max())
    cfo = float(turn[use].max()) * fs / (2.0 * math.pi * L)
    return gap, cfo, int(use.sum())


def judge(config: dict, record: dict, control: bool = False, want_work: bool = False) -> dict:
    """The numbers compared for one run: {"checks": {name: (value, limit)},
    "failed": answers found wrong, "info": {...}, "gated": per input}."""
    det, fs = config["detector"], config["system"]["sample_rate_hz"]
    L, h = det["half_len"], det["hysteresis"]
    bad_total, gap, cap_gap, cfo_gap, failed = 0, 0.0, 0.0, 0.0, 0
    excused, events, compared, gated = 0, 0, 0, {}
    for i, x in enumerate(record["inputs"]):
        kept = None if control else record["kept"][i]
        parts, c_parts, amb, gated[i] = [], [], [], 0
        in_cap, in_cfo = 0.0, 0.0
        for r in range(0, x.shape[1], ROWS):
            xb = x[:, r: r + ROWS]
            table, _, _, ref_m, above, a = detect_block(xb, det, "float32")
            parts.append(G.to_numpy(table))
            amb += G.ambiguous_positions(a)
            gated[i] += gated_samples(above, h, L)
            if control:
                c_table, c_P, c_M, _, _, _ = detect_block(xb, det, "bfloat16")
                c_parts.append(G.to_numpy(c_table))
                g = capture_gaps(c_table["peak_idx"], c_table["valid"], c_P, c_M, ref_m, fs, L)
            else:
                rows = slice(r, r + ROWS)
                g = capture_gaps(kept["peak_idx"][rows], kept["valid"][rows], kept["P"][rows],
                                 kept["M"][rows], ref_m, fs, L)
            in_cap, in_cfo, compared = max(in_cap, g[0]), max(in_cfo, g[1]), compared + g[2]
        ref = {f: np.concatenate([p[f] for p in parts]) for f in G.FIELDS}
        events += int(ref["valid"].sum())
        cap_gap, cfo_gap = max(cap_gap, in_cap), max(cfo_gap, in_cfo)
        if in_cap > LIMITS["capture_gap"] or in_cfo > LIMITS["cfo_gap_hz"]:
            failed += 1
        outs = ([({f: np.concatenate([p[f] for p in c_parts]) for f in G.FIELDS},
                  record["calls"].get(i, 1))] if control else record["variants"].get(i, []))
        for table, count in outs:
            bad, exc, g = G.compare(table, ref, amb, h)
            bad_total += int(bad.sum())
            excused += exc
            gap = max(gap, g)
            failed += count if bad.any() else 0
    checks = {"unexcused_events": bad_total, "peak_value_gap": gap, "capture_gap": cap_gap,
              "cfo_gap_hz": cfo_gap}
    return {"checks": {k: (v, LIMITS[k]) for k, v in checks.items()}, "failed": failed,
            "gated": gated,
            "info": {"events": events, "excused_events": excused,
                     "variants": sum(len(v) for v in record["variants"].values()),
                     "captures_compared": compared}}
