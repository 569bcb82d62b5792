"""Gate / hysteresis / peak-tracking detection in closed form
(port of `ofdm_sync_tpu.ops.detect`).

The reference FSMs (gate opens at an above-threshold sample, closes at the
h-th consecutive below sample, peak tracked in between) have a closed
form: gates are clusters of above runs whose gaps are <= h, close = last
above of the cluster + h, peak = argmax of the tracked value over
[gate_start, close].  Clusters come from a running maximum of above
indices and per-slot reductions over a static event capacity.

`extract_gate_events` is the plain PyTorch version of the CUDA gate/event
kernel (`kernels/csrc/gate_events.cu`), and `extract_gate_events_capture`
that of its peak-capture mode; both work on the last axis and broadcast
over leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_I32_MAX = int(np.iinfo(np.int32).max)

_FIELDS = ("valid", "closed", "gate_start", "gate_close", "peak_idx",
           "peak_value", "count", "overflow")


class GateEvents(NamedTuple):
    """Fixed-capacity event table; per-stream fields are (..., max_events)."""

    valid: torch.Tensor       # bool   -- event emitted
    closed: torch.Tensor      # bool   -- gate closed before stream end
    gate_start: torch.Tensor  # int32  -- index where the gate opened
    gate_close: torch.Tensor  # int32  -- h-th-below index (clipped to n-1)
    peak_idx: torch.Tensor    # int32
    peak_value: torch.Tensor  # track dtype
    count: torch.Tensor       # int32 (...)  -- number of valid events
    overflow: torch.Tensor    # bool (...)   -- more gates than capacity

    @classmethod
    def from_numpy(cls, table, device=None) -> "GateEvents":
        """Any table with the GateEvents fields (a JAX `GateEvents`, a dict
        of arrays) -> tensors, so JAX and port tables compare directly."""
        get = (lambda f: table[f]) if isinstance(table, dict) else (
            lambda f: getattr(table, f))
        return cls(*(torch.as_tensor(np.array(get(f)), device=device)
                     for f in _FIELDS))

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {f: getattr(self, f).detach().cpu().numpy() for f in _FIELDS}

    def select(self, i: int) -> "GateEvents":
        """Table of stream ``i`` of a batched table."""
        return GateEvents(*(getattr(self, f)[i] for f in _FIELDS))


def empty_table(lead: tuple, max_events: int, dtype, device) -> GateEvents:
    shape = tuple(lead) + (max_events,)
    zi = torch.zeros(shape, dtype=torch.int32, device=device)
    return GateEvents(
        valid=torch.zeros(shape, dtype=torch.bool, device=device),
        closed=torch.zeros(shape, dtype=torch.bool, device=device),
        gate_start=zi,
        gate_close=zi.clone(),
        peak_idx=zi.clone(),
        peak_value=torch.zeros(shape, dtype=dtype, device=device),
        count=torch.zeros(tuple(lead), dtype=torch.int32, device=device),
        overflow=torch.zeros(tuple(lead), dtype=torch.bool, device=device),
    )


def _last_above(above: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Running index of the most recent above sample (-1 before any)."""
    return torch.cummax(torch.where(above, idx, -1), dim=-1).values


def extract_gate_events(
    above: torch.Tensor,
    track: torch.Tensor,
    *,
    hysteresis: int,
    max_events: int = 8,
    valid_from: int = 0,
    tie: str = "first",
    emit_unclosed: bool = True,
) -> GateEvents:
    """Closed-form equivalent of the reference gate/peak FSMs.

    above: bool (..., n); track: (..., n) value whose in-gate maximum is the
    peak.  The gate closes at the ``max(hysteresis, 1)``-th consecutive below
    sample; samples before ``valid_from`` are skipped.  ``tie='first'``:
    earliest maximum wins; ``'last'``: latest.  ``emit_unclosed``: emit an
    event for a gate still open at end of stream.
    """
    return _extract(above, track, hysteresis=hysteresis, max_events=max_events,
                    valid_from=valid_from, tie=tie, emit_unclosed=emit_unclosed)[0]


def extract_gate_events_capture(
    above: torch.Tensor,
    track: torch.Tensor,
    extras: tuple[torch.Tensor, ...],
    **kw,
) -> tuple[GateEvents, torch.Tensor]:
    """`extract_gate_events` plus each ``extras`` array (..., n) read at every
    slot's peak index: returns (table, captured (..., len(extras), E)),
    zero where the slot holds no gate (``pallas_common.event_finalize``)."""
    table, exists = _extract(above, track, **kw)
    if above.shape[-1] == 0:
        return table, torch.zeros(exists.shape[:-1] + (len(extras),) + exists.shape[-1:],
                                  dtype=track.dtype, device=track.device)
    idx = table.peak_idx.to(torch.int64)
    cap = [torch.where(exists, a.gather(-1, idx), 0.0) for a in extras]
    return table, torch.stack(cap, dim=-2)


def _extract(above, track, *, hysteresis, max_events=8, valid_from=0, tie="first",
             emit_unclosed=True) -> tuple[GateEvents, torch.Tensor]:
    """The table and its ``exists`` mask (slot < gates found)."""
    if tie not in ("first", "last"):
        raise ValueError("tie must be 'first' or 'last'")
    n = above.shape[-1]
    h = max(int(hysteresis), 1)
    lead = tuple(above.shape[:-1])
    dev = above.device
    if n == 0:
        return (empty_table(lead, max_events, track.dtype, dev),
                torch.zeros(lead + (max_events,), dtype=torch.bool, device=dev))
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    above = above.to(torch.bool) & (idx >= valid_from)

    last_above = _last_above(above, idx)
    below_run = idx - last_above
    prev_above = torch.cat(
        [torch.full(lead + (1,), -1, dtype=torch.int64, device=dev),
         last_above[..., :-1]], dim=-1)
    new_cluster = above & ((prev_above < 0) | (idx - prev_above > h))
    cluster_id = torch.cumsum(new_cluster, dim=-1)  # 1-based, int64
    in_gate = (last_above >= 0) & (below_run <= h) & (cluster_id >= 1)

    neg_inf = torch.tensor(float("-inf"), dtype=track.dtype, device=dev)
    starts, pvals, pidxs, lasts = [], [], [], []
    for c in range(1, max_events + 1):
        m = in_gate & (cluster_id == c)
        starts.append(torch.where(m, idx, _I32_MAX).amin(dim=-1))
        # one argmax for value and index together (never `track == max`)
        masked = torch.where(m, track, neg_inf)
        if tie == "last":
            pi = (n - 1) - torch.argmax(masked.flip(-1), dim=-1)
        else:
            pi = torch.argmax(masked, dim=-1)
        pvals.append(masked.gather(-1, pi.unsqueeze(-1)).squeeze(-1))
        any_m = m.any(dim=-1)
        pidxs.append(torch.where(any_m, pi, -1 if tie == "last" else _I32_MAX))
        lasts.append(torch.where(above & (cluster_id == c), idx, -1).amax(dim=-1))
    gate_start = torch.stack(starts, dim=-1)
    peak_val = torch.stack(pvals, dim=-1)
    peak_idx = torch.stack(pidxs, dim=-1)
    close_raw = torch.stack(lasts, dim=-1) + h
    closed = close_raw <= n - 1

    total = cluster_id[..., -1]
    slot = torch.arange(max_events, device=dev)
    exists = slot < total.unsqueeze(-1)
    valid = exists & (closed | emit_unclosed)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    i32 = torch.int32
    return GateEvents(
        valid=valid,
        closed=closed & exists,
        gate_start=torch.where(exists, gate_start, zero).to(i32),
        gate_close=torch.where(exists, close_raw.clamp(0, n - 1), zero).to(i32),
        peak_idx=torch.where(exists, peak_idx, zero).to(i32),
        peak_value=torch.where(exists, peak_val, torch.zeros((), dtype=track.dtype,
                                                             device=dev)),
        count=valid.sum(dim=-1, dtype=i32),
        overflow=total > max_events,
    ), exists


def gate_open_mask(above: torch.Tensor, hysteresis: int,
                   valid_from: int = 0) -> torch.Tensor:
    """Boolean gate-open mask (the reference FSMs' `gate_mask` arrays)."""
    n = above.shape[-1]
    h = max(int(hysteresis), 1)
    idx = torch.arange(n, dtype=torch.int64, device=above.device)
    la = _last_above(above.to(torch.bool) & (idx >= valid_from), idx)
    return (la >= 0) & (idx - la <= h)
