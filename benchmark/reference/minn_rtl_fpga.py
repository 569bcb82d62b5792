"""Plain reference of the `minn_rtl_fpga` configuration: the Minn-RTL
"adjacent quarter" detector of the upstream FPGA design
(ref/minn_preamble_detector.sv, minn_rtl.py:829-844), in PyTorch.

Per sample, over all branches and I/Q planes: the quarter product
u[n] = sum x[n] x[n-Q] and the power p[n] = sum x[n]^2; corr = max(0, the
2Q-window sum of u), energy = the 3Q-window sum of p (exact integers in
float64 on 12-bit codes); the configuration states them in float32, so both
are rounded once to float32.  The smoothing register s += (corr - s) / 2^shift
runs from sample 3Q - 1 on (held at zero before), here in float64; above =
s * 2^frac >= energy * T.  Then the gate / peak FSM (`gates.py`) on corr.

The program smooths in float32, so at a sample whose threshold margin lies
within `KNIFE` of the threshold's side it may decide either way: such a
sample is ambiguous, and an event that differs from the reference's is
excused where an ambiguous sample lies in or next to its gate (the share
of excused events is reported).  The control computes the same with
corr, energy and the register stored in bfloat16.

`judge` compares what the timed path produced: every batch's table (a
closed loop), or a seeded sample of the live stream's block tables and the
state after its last block.  A block's reference runs the reference step
over the block before it (from a fresh state: the register forgets within
~1,600 samples and the history is 3Q samples) and then over the block.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gates as G
from benchmark.work.counts import gated_samples

#: each number compared, and its limit (PERF.md gives the readings)
LIMITS = {"unexcused_events": 0, "peak_value_gap": 1e-5, "register_gap": 1e-4,
          "state_mismatch": 0}
#: relative threshold margin within which float32 smoothing may decide
#: either way
KNIFE = 1e-5
#: two gate samples within this relative distance of the peak: a rounding
#: of the track could pick either
TIE = 1e-6
#: streams per block of the reference's work (bounds its memory)
ROWS = 64
#: the IIR's block length (one float64 matrix product a block)
IIR_BLOCK = 256


def _shift(x, d):
    return torch.cat([torch.zeros_like(x[..., :d]), x[..., :-d]], dim=-1)


def _window(v, w):
    """Causal w-sample window sums along the last axis (float64 cumulative
    sum; exact on integers)."""
    cs = torch.cumsum(v, dim=-1)
    return cs - _shift(cs, w) if v.shape[-1] > w else cs


def iir(b, a: float, s0=None):
    """s[n] = a s[n-1] + b[n], s[-1] = s0 (0), float64: within blocks by one
    matrix product, across blocks by a log-depth scan of the block ends."""
    rows, n = b.shape
    B = IIR_BLOCK
    nb = -(-n // B)
    bb = torch.nn.functional.pad(b, (0, nb * B - n)).view(rows, nb, B)
    k = torch.arange(B, device=b.device, dtype=torch.float64)
    d = k[:, None] - k[None, :]
    T = torch.where(d >= 0, torch.pow(a, d.clamp_min(0)), torch.zeros_like(d))
    loc = bb @ T.T
    e = torch.zeros((rows, nb), dtype=torch.float64, device=b.device)
    if s0 is not None:
        e[:, 0] = s0
    e[:, 1:] = loc[:, :-1, -1]
    A, step = a ** B, 1
    while step < nb:
        e = torch.cat([e[:, :step], e[:, step:] + A * e[:, :-step]], dim=-1)
        A, step = A * A, step * 2
    s = loc + torch.pow(a, k + 1) * e[:, :, None]
    return s.reshape(rows, nb * B)[:, :n]


def _stored(v, precision: str):
    return v.to(torch.float32 if precision == "float32" else torch.bfloat16).double()


def metric(x, det: dict, *, base=0, hist=None, carry=None, precision="float32"):
    """x (C, rows, n) codes; hist (C, rows, Hh) the samples before sample 0.
    Returns (track, above, ambiguous samples, register after the last sample)."""
    Q = det["quarter_len"]
    xf = x.to(torch.float64)
    H = 0
    if hist is not None:
        H = hist.shape[-1]
        xf = torch.cat([hist.to(torch.float64), xf], dim=-1)
    u = (xf * _shift(xf, Q)).sum(0)
    p = (xf * xf).sum(0)
    corr = _stored(_window(u, 2 * Q).clamp_min(0.0)[:, H:], precision)
    energy = _stored(_window(p, 3 * Q)[:, H:], precision)
    alpha = 1.0 / (1 << det["smooth_shift"])
    n = corr.shape[-1]
    valid = base + torch.arange(n, device=x.device) >= 3 * Q - 1
    s = iir(torch.where(valid, alpha * corr, 0.0), 1.0 - alpha, carry)
    if precision != "float32":
        s = _stored(s, precision)
    lhs = s * float(1 << det["threshold_frac_bits"])
    rhs = energy * float(det["threshold_value"])
    above = valid & (lhs >= rhs)
    amb = valid & ((lhs - rhs).abs() <= KNIFE * rhs)
    return corr, above, amb, s[:, -1]


def _events(det, corr, above, **kw):
    return G.gate_events(above, corr, hysteresis=det["hysteresis"],
                         max_events=det["max_events"], valid_from=3 * det["quarter_len"] - 1,
                         tie=det["tie"], tie_tol=TIE * corr.abs(), **kw)


def detect(x, det: dict, precision="float32"):
    """One-shot tables of x (C, batch, L): (table as NumPy, each row's
    ambiguous samples, gated samples)."""
    parts, amb, gated = [], [], 0
    for r in range(0, x.shape[1], ROWS):
        corr, above, a, _ = metric(x[:, r: r + ROWS], det, precision=precision)
        table, _, ties = _events(det, corr, above, emit_unclosed=det["emit_unclosed"])
        parts.append(G.to_numpy(table))
        amb += G.ambiguous_positions(a | ties)
        gated += gated_samples(above, det["hysteresis"], 3 * det["quarter_len"] - 1)
    return {f: np.concatenate([p[f] for p in parts]) for f in G.FIELDS}, amb, gated


def fresh_state(C: int, rows: int, Q: int, device):
    return (torch.zeros((C, rows, 3 * Q), dtype=torch.float64, device=device),
            torch.zeros(rows, dtype=torch.float64, device=device),
            torch.tensor([[-1, 0]], dtype=torch.int64, device=device).repeat(rows, 1))


def step(chunk, state, base: int, det: dict, horizon: int, precision="float32"):
    """One chunk of the stream detector: the gate carry rule (a gate
    continues iff its last above sample lies within h of the seam), the
    primed metric, the carried FSM against the open-ended horizon with
    every gate emitted, the history roll.  Returns (table, new state,
    ambiguous samples (rows, n))."""
    hist, carry, gate = state
    h = max(int(det["hysteresis"]), 1)
    la = gate[:, 0]
    go = (la >= 0) & (base - la <= h)
    ginit = torch.stack([torch.where(go, la, -1), go.long()], dim=1)
    corr, above, amb, s_last = metric(chunk, det, base=base, hist=hist, carry=carry,
                                      precision=precision)
    table, gate_out, ties = _events(det, corr, above, emit_unclosed=True, base=base,
                                    stream_len=horizon, gate_init=ginit)
    new_hist = torch.cat([hist, chunk.to(torch.float64)], dim=-1)[..., -hist.shape[-1]:]
    return table, (new_hist, s_last, gate_out), amb | ties


def _block_table(ring, k: int, block: int, det, horizon, precision):
    """Block k of the ring's periodic stream: the reference step over
    block k - 1 (from a fresh state), then over block k.  Returns (table,
    state after block k, ambiguous rows)."""
    C, rows, n = ring.shape
    nblk = n // block
    view = lambda j: ring[..., (j % nblk) * block: (j % nblk + 1) * block]  # noqa: E731
    state = fresh_state(C, rows, det["quarter_len"], ring.device)
    if k > 0:
        _, state, _ = step(view(k - 1), state, (k - 1) * block, det, horizon, precision)
    return step(view(k), state, k * block, det, horizon, precision)


def _checks(bad: int, gap: float, extra: dict | None = None) -> dict:
    out = {"unexcused_events": bad, "peak_value_gap": gap, **(extra or {})}
    return {k: (v, LIMITS[k]) for k, v in out.items()}


def judge(config: dict, record: dict, control: bool = False, want_work: bool = False) -> dict:
    """The numbers compared for one run: {"checks": {name: (value, limit)},
    "failed": answers found wrong, "info": {...}, "gated": per input}."""
    det = config["detector"]
    if record["loop"] == "open":
        return _judge_stream(config, record, control, want_work)
    h = det["hysteresis"]
    bad_total, gap, failed, excused, events, gated = 0, 0.0, 0, 0, 0, {}
    for i, x in enumerate(record["inputs"]):
        ref, amb, gated[i] = detect(x, det)
        events += int(ref["valid"].sum())
        outs = ([(detect(x, det, "bfloat16")[0], record["calls"].get(i, 1))] if control
                else record["variants"].get(i, []))
        for table, count in outs:
            bad, exc, g = G.compare(table, ref, amb, h)
            bad_total += int(bad.sum())
            excused += exc
            gap = max(gap, g)
            failed += count if bad.any() else 0
    return {"checks": _checks(bad_total, gap), "failed": failed, "gated": gated,
            "info": {"events": events, "excused_events": excused,
                     "variants": sum(len(v) for v in record["variants"].values())}}


def _judge_stream(config, record, control, want_work):
    det, traffic = config["detector"], record["traffic"]
    ring, block = record["ring"], traffic["block"]
    horizon, h = config["stream"]["horizon"], det["hysteresis"]
    bad_total, gap, failed, excused, events = 0, 0.0, 0, 0, 0
    prec = "bfloat16" if control else "float32"
    for k, table in sorted(record["sampled"].items()):
        ref, _, amb = _block_table(ring, k, block, det, horizon, "float32")
        ref = G.to_numpy(ref)
        events += int(ref["valid"].sum())
        out = (G.to_numpy(_block_table(ring, k, block, det, horizon, prec)[0]) if control
               else table)
        bad, exc, g = G.compare(out, ref, G.ambiguous_positions(amb), h, base=k * block)
        bad_total += int(bad.sum())
        excused += exc
        gap = max(gap, g)
        failed += int(bad.any())
    last = record["blocks"] - 1
    _, (hist, carry, gate), amb = _block_table(ring, last, block, det, horizon, "float32")
    if control:
        _, (p_hist, p_carry, p_gate), _ = _block_table(ring, last, block, det, horizon, prec)
        p_hist, p_carry, p_gate = (t.cpu().numpy() for t in (p_hist, p_carry, p_gate))
    else:
        p_hist, p_carry, p_gate = (record["final"][k] for k in ("hist", "carry", "gate"))
    # the carried gate (last above, clusters) may differ where the block
    # holds an ambiguous sample
    amb = amb.any(dim=-1).cpu().numpy()
    r_hist, r_carry, r_gate = hist.cpu().numpy(), carry.cpu().numpy(), gate.cpu().numpy()
    p_hist = np.asarray(p_hist, np.float64)[..., -r_hist.shape[-1]:]
    same_hist = (p_hist == r_hist).transpose(1, 0, 2).reshape(r_hist.shape[1], -1).all(1)
    same_gate = (np.asarray(p_gate).astype(np.int64) == r_gate).all(1)
    mism = ~same_hist | (~same_gate & ~amb)
    scale = np.maximum(np.abs(r_carry), 1e-6 * max(float(np.abs(r_carry).max()), 1e-30))
    reg = float((np.abs(np.asarray(p_carry, np.float64) - r_carry) / scale).max(initial=0.0))
    return {"checks": _checks(bad_total, gap, {"register_gap": reg,
                                               "state_mismatch": int(mism.sum())}),
            "failed": failed + int(mism.any()),
            "gated": _ring_gated(ring, block, det) if want_work else None,
            "info": {"events": events, "excused_events": excused,
                     "sampled_blocks": len(record["sampled"])}}


def _ring_gated(ring, block, det) -> float:
    """Gated samples per block of the ring's periodic stream, averaged over
    its blocks (the one block before the ring primes the first)."""
    C, rows, n = ring.shape
    ext = torch.cat([ring[..., n - block:], ring], dim=-1)
    total = 0
    for r in range(0, rows, ROWS):
        _, above, _, _ = metric(ext[:, r: r + ROWS], det, base=block)
        total += gated_samples(above[:, block:], det["hysteresis"])
    return total / (n // block)
