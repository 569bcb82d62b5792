"""The gate / hysteresis / peak-tracking detector, plain PyTorch, and the
comparison of event tables.

The reference FSM (upstream `core.py` / `minn_rtl.py` / `zc_v2.py`): a
gate opens at an above sample, closes at the max(h, 1)-th consecutive
below sample, and the peak of the tracked value is kept in between.  In
closed form: gates are clusters of above samples whose gaps are at most h;
a cluster's close is its last above sample + h; its peak is the arg-max of
the track over the gate.  Events fill a table of ``max_events`` slots.  A
chunk of a stream takes global indices (``base``), the stream's close
horizon (``stream_len``) and the gate carried in from the chunk before
(``gate_init`` [last-above index, cluster count]).
"""

from __future__ import annotations

import numpy as np
import torch

I32_MAX = 2**31 - 1
FIELDS = ("valid", "closed", "gate_start", "gate_close", "peak_idx", "peak_value", "count",
          "overflow")


def gate_events(above, track, *, hysteresis, max_events, valid_from=0, tie="first",
                emit_unclosed=True, base=0, stream_len=None, gate_init=None, tie_tol=None):
    """above bool (rows, n), track (rows, n) -> (table dict of tensors,
    gate_out (rows, 2) [last-above, clusters], ties bool (rows, n)).

    ``tie_tol`` (rows, n) or scalar: where a gate holds another sample
    within tie_tol of its peak, those samples are marked in ties (the peak
    index depends on rounding)."""
    rows, n = above.shape
    dev = above.device
    i64 = torch.int64
    h = max(int(hysteresis), 1)
    if gate_init is None:
        la0 = torch.full((rows, 1), -1, dtype=i64, device=dev)
        cnt0 = torch.zeros((rows, 1), dtype=i64, device=dev)
    else:
        la0, cnt0 = gate_init[:, 0:1].to(i64), gate_init[:, 1:2].to(i64)
    Lg = base + n if stream_len is None else int(stream_len)
    end = min(Lg, base + n)
    idx = base + torch.arange(n, dtype=i64, device=dev)
    a = above.bool() & (idx >= valid_from) & (idx < Lg)
    last = torch.maximum(torch.cummax(torch.where(a, idx, -1), dim=-1).values, la0)
    prev = torch.maximum(torch.cat([torch.full((rows, 1), -1, dtype=i64, device=dev),
                                    last[:, :-1]], dim=-1), la0)
    new = a & ((prev < 0) | (idx - prev > h))
    cid = cnt0 + torch.cumsum(new, dim=-1)
    in_gate = (last >= 0) & (idx - last <= h) & (cid >= 1) & (idx < end)
    neg = torch.tensor(float("-inf"), dtype=track.dtype, device=dev)
    starts, vals, pidx, lasts = [], [], [], []
    ties = torch.zeros((rows, n), dtype=torch.bool, device=dev)
    for c in range(1, max_events + 1):
        m = in_gate & (cid == c)
        starts.append(torch.where(m, idx, I32_MAX).amin(dim=-1))
        masked = torch.where(m, track, neg)
        if tie == "last":
            pi = (n - 1) - torch.argmax(masked.flip(-1), dim=-1)
        else:
            pi = torch.argmax(masked, dim=-1)
        pv = masked.gather(-1, pi[:, None])
        vals.append(pv[:, 0])
        pidx.append(torch.where(m.any(dim=-1), base + pi, -1 if tie == "last" else I32_MAX))
        lasts.append(torch.where(a & (cid == c), idx, -1).amax(dim=-1))
        if tie_tol is not None:
            near = m & (masked >= pv - tie_tol)
            ties |= near & (near.sum(dim=-1, keepdim=True) > 1)
    close_raw = torch.stack(lasts, dim=-1) + h
    closed = close_raw <= Lg - 1
    total = cid[:, -1]
    exists = torch.arange(max_events, device=dev) < total[:, None]
    valid = exists & (closed | emit_unclosed)
    zero = torch.zeros((), dtype=i64, device=dev)
    table = {
        "valid": valid,
        "closed": closed & exists,
        "gate_start": torch.where(exists, torch.stack(starts, -1), zero).to(torch.int32),
        "gate_close": torch.where(exists, close_raw.clamp(0, Lg - 1), zero).to(torch.int32),
        "peak_idx": torch.where(exists, torch.stack(pidx, -1), zero).to(torch.int32),
        "peak_value": torch.where(exists, torch.stack(vals, -1),
                                  torch.zeros((), dtype=track.dtype, device=dev)),
        "count": valid.sum(dim=-1, dtype=torch.int32),
        "overflow": total > max_events,
    }
    gate_out = torch.stack([last[:, -1], total], dim=-1)
    return table, gate_out, ties


def to_numpy(table: dict) -> dict:
    return {f: table[f].detach().cpu().numpy() for f in FIELDS}


def ambiguous_positions(mask) -> list:
    """Each row's ambiguous sample indices (NumPy), from a bool (rows, n)
    mask and the global index of its first sample."""
    rows, at = mask.nonzero(as_tuple=True)
    rows, at = rows.cpu().numpy(), at.cpu().numpy()
    return [at[rows == r] for r in range(mask.shape[0])]


def _events(t: dict, r: int) -> dict:
    """Row r's valid slots as {(start, close, peak index, closed): peak value}."""
    out = {}
    for s in np.flatnonzero(t["valid"][r]):
        out[(int(t["gate_start"][r, s]), int(t["gate_close"][r, s]), int(t["peak_idx"][r, s]),
             bool(t["closed"][r, s]))] = float(t["peak_value"][r, s])
    return out


def compare(prog: dict, ref: dict, amb: list, hysteresis: int, base: int = 0):
    """The program's table against the reference's, event by event.

    Rows whose slots agree field for field (the peak value aside) match
    whole.  In any other row the valid events of both sides are matched on
    (start, close, peak index, closed); an event of either side without a
    match is excused where an ambiguous sample (``amb[r]``, indices from
    ``base``) lies within its gate widened by h on both sides, or where the
    row overflowed on a side and holds an ambiguous sample (a cluster made
    or merged there shifts which gates fit).  Returns (unexcused events per
    row, excused events, the largest relative peak-value gap over matched
    events)."""
    rows = len(amb)
    same = np.ones(rows, dtype=bool)
    for f in FIELDS:
        if f == "peak_value":
            continue
        p, r = np.asarray(prog[f]), np.asarray(ref[f])
        if p.shape != r.shape:
            return np.full(rows, 1 << 20), 0, float("inf")
        same &= (p == r).reshape(rows, -1).all(axis=1)
    pv = np.asarray(prog["peak_value"], dtype=np.float64)
    rv = np.asarray(ref["peak_value"], dtype=np.float64)
    mask = np.asarray(ref["valid"], dtype=bool) & same[:, None]
    gap = 0.0
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(pv - rv) / np.maximum(np.abs(rv), 1e-30)
    if mask.any():
        gap = float(np.where(np.isfinite(rel), rel, np.inf)[mask].max())
    bad, excused = np.zeros(rows, dtype=np.int64), 0
    h = max(int(hysteresis), 1)
    for r in np.flatnonzero(~same):
        P, R = _events(prog, r), _events(ref, r)
        for k in P.keys() & R.keys():
            gap = max(gap, abs(P[k] - R[k]) / max(abs(R[k]), 1e-30))
        near = amb[r] + base
        spill = bool(len(near)) and bool(prog["overflow"][r] or ref["overflow"][r])
        for k in P.keys() ^ R.keys():
            lo, hi = k[0] - h - 1, k[1] + h + 1
            if spill or bool(((near >= lo) & (near <= hi)).any()):
                excused += 1
            else:
                bad[r] += 1
    return bad, excused, gap
