"""Plain reference of the `zc_v2_cfar` configuration: the ZC-v2 streaming
CFAR detector from IQ (upstream zc_v2.py:119-158, 486-498), in PyTorch.

The matched filter is the full linear convolution of each branch's complex
stream with the planar taps the benchmark hands the program (the
conjugate-reversed PSS, float32), here by one complex128 FFT a stream.
Per branch the power i^2 + q^2 is summed over the ref_len window ending at
each correlation index (zero past the stream's end); each branch's filter
output is scaled by 1 / (ref_norm sqrt(max(E, 1e-12))) and the branches
summed; mag = |sum|, stated in float32.  CFAR: index >= W, mag * 2^frac >=
(W-window sum of mag) * T, and mag >= MIN_CORR_MAG.  Then the gate / peak
FSM (`gates.py`) on mag, tie 'first', unclosed gates emitted.

The program's mag comes from its float32 filter output, which the
comparison lets differ from this one by up to `LIMITS["mf_rel_err"]` of a
stream's filter peak.  Carried through the normalisation, that bounds each
mag's error (`delta`) and each window sum's; a sample whose decision
(CFAR and floor together) could flip within those bounds, or a rival of a
gate's peak within them, is ambiguous, and an event that differs from the
reference's is excused where an ambiguous sample lies in or next to its
gate (the share of excused events is reported).  The control stores the filter
output and mag in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gates as G
from benchmark.work.counts import gated_samples

LIMITS = {"mf_rel_err": 2e-5, "unexcused_events": 0, "peak_value_gap": 1e-4}
#: float32 rounding of the mag chain, relative
ROUND = 2.0**-20
ROWS = 32


def _stored(v, precision: str):
    return v.to(torch.float32 if precision == "float32" else torch.bfloat16).double()


def _window(v, w):
    cs = torch.cumsum(v, dim=-1)
    return cs - torch.nn.functional.pad(cs, (w, 0))[..., :-w] if v.shape[-1] > w else cs


def matched_filter(x, taps):
    """x (C, rows, L) codes, taps planar (2, T) -> planar float64 (C, rows,
    L + T - 1): the full convolution of each branch with the taps."""
    C, rows, L = x.shape
    T = taps.shape[-1]
    Lc = L + T - 1
    N = 1 << (Lc - 1).bit_length()
    h = torch.complex(taps[0].double(), taps[1].double())
    xc = torch.complex(x[0::2].double(), x[1::2].double())
    y = torch.fft.ifft(torch.fft.fft(xc, n=N) * torch.fft.fft(h, n=N), n=N)[..., :Lc]
    return torch.stack([y.real, y.imag], dim=1).reshape(C, rows, Lc)


def metric(mf, x, det: dict, ref_norm: float, precision="float32", mf_eps=None):
    """mf planar (C, rows, Lc) float64, x (C, rows, L) codes -> (mag, above,
    ambiguous samples, tie tolerance), each (rows, Lc)."""
    C, rows, Lc = mf.shape
    R = Lc - x.shape[-1] + 1
    xf = x.double()
    p = torch.nn.functional.pad(xf[0::2] ** 2 + xf[1::2] ** 2, (0, R - 1))
    energy = _stored(_window(p, R), "float32")
    inv = 1.0 / (ref_norm * torch.sqrt(energy.clamp_min(1e-12)))          # (BR, rows, Lc)
    re = (mf[0::2] * inv).sum(0)
    im = (mf[1::2] * inv).sum(0)
    mag = _stored(torch.sqrt(re * re + im * im), precision)
    W, thr = det["corr_window"], float(det["threshold_value"])
    scale, floor = float(1 << det["threshold_frac_bits"]), det["min_corr_mag"]
    ls = _window(mag, W)
    valid = torch.arange(Lc, device=mf.device) >= W
    above = valid & (mag * scale >= ls * thr) & (mag >= floor)
    if mf_eps is None:
        return mag, above, None, None
    peak = mf.abs().amax(dim=(0, 2))                                         # (rows,)
    delta = (np.sqrt(2.0) * mf_eps * peak[:, None] * inv.sum(0) + ROUND * mag)
    dls = _window(delta, W) + ROUND * ls
    m_floor, t_floor = mag - floor, delta + ROUND * floor
    m_cfar, t_cfar = mag * scale - ls * thr, scale * delta + thr * dls
    surely_not = (m_floor < -t_floor) | (m_cfar < -t_cfar)
    surely = (m_floor > t_floor) & (m_cfar > t_cfar)
    return mag, above, valid & ~surely_not & ~surely, 2.0 * delta


def _tables(x, taps, det, ref_norm, precision, kept=None):
    """Tables, each row's ambiguous samples, gated samples, and the largest
    filter error of ``kept`` (the program's filter output of x) over a
    stream's peak."""
    parts, amb, gated, err = [], [], 0, 0.0
    eps = LIMITS["mf_rel_err"]
    for r in range(0, x.shape[1], ROWS):
        xb = x[:, r: r + ROWS]
        mf = matched_filter(xb, taps)
        if kept is not None:
            d = (kept[:, r: r + ROWS].double() - mf).abs().amax(dim=(0, 2))
            err = max(err, float((d / mf.abs().amax(dim=(0, 2)).clamp_min(1e-30)).max()))
        _, above, a, tol = metric(mf, xb, det, ref_norm, mf_eps=eps)
        if precision != "float32":
            mf = _stored(mf, precision)
        mag, above, _, _ = metric(mf, xb, det, ref_norm, precision)
        table, _, ties = G.gate_events(above, mag, hysteresis=det["hysteresis"],
                                       max_events=det["max_events"],
                                       valid_from=det["corr_window"], tie=det["tie"],
                                       emit_unclosed=det["emit_unclosed"], tie_tol=tol)
        parts.append(G.to_numpy(table))
        amb += G.ambiguous_positions(a | ties)
        gated += gated_samples(above, det["hysteresis"], det["corr_window"])
    return {f: np.concatenate([p[f] for p in parts]) for f in G.FIELDS}, amb, gated, err


def judge(config: dict, record: dict, control: bool = False, want_work: bool = False) -> dict:
    det = config["detector"]
    taps = torch.as_tensor(record["taps"], device=record["inputs"][0].device)
    ref_norm = float(torch.sqrt((taps.double() ** 2).sum()))
    bad_total, gap, failed, mf_err, excused, events, gated = 0, 0.0, 0, 0.0, 0, 0, {}
    for i, x in enumerate(record["inputs"]):
        kept = record["kept"].get(i)
        ref, amb, gated[i], err = _tables(x, taps, det, ref_norm, "float32", kept)
        if kept is not None:
            mf_err = max(mf_err, err)
        events += int(ref["valid"].sum())
        if control:
            c_mf_err = 0.0
            for r in range(0, x.shape[1], ROWS):
                mf = matched_filter(x[:, r: r + ROWS], taps)
                d = (_stored(mf, "bfloat16") - mf).abs().amax(dim=(0, 2))
                c_mf_err = max(c_mf_err, float((d / mf.abs().amax(dim=(0, 2))).max()))
            mf_err = max(mf_err, c_mf_err)
            outs = [(_tables(x, taps, det, ref_norm, "bfloat16")[0], record["calls"].get(i, 1))]
        else:
            outs = record["variants"].get(i, [])
        for table, count in outs:
            bad, exc, g = G.compare(table, ref, amb, det["hysteresis"])
            bad_total += int(bad.sum())
            excused += exc
            gap = max(gap, g)
            failed += count if bad.any() else 0
    checks = {"mf_rel_err": mf_err, "unexcused_events": bad_total, "peak_value_gap": gap}
    return {"checks": {k: (v, LIMITS[k]) for k, v in checks.items()}, "failed": failed,
            "gated": gated,
            "info": {"events": events, "excused_events": excused,
                     "variants": sum(len(v) for v in record["variants"].values()),
                     "mf_checked": len(record["kept"])}}
