"""Gate / hysteresis / peak-tracking detection in closed form
(port of `ofdm_sync_tpu.ops.detect`).

The reference FSMs (gate opens at an above-threshold sample, closes at the
h-th consecutive below sample, peak tracked in between) have a closed
form: gates are clusters of above runs whose gaps are <= h, close = last
above of the cluster + h, peak = argmax of the tracked value over
[gate_start, close].  Clusters come from a running maximum of above
indices and per-slot reductions over a static event capacity.

`largest_true_run`, `earliest_long_run_end` and `mask_segments` are the
run-segmentation helpers of the plateau and gate-mask pickers.

`extract_gate_events` is the plain PyTorch version of the CUDA gate/event
kernel (`kernels/csrc/gate_events.cu`), and `extract_gate_events_capture`
that of its peak-capture mode; both work on the last axis and broadcast
over leading batch axes.  `extract_gate_events_carried` is that of its
carried-state mode (the chunk of a stream, `pallas_minn.py:_detect_kernel`
with base_index / stream_len_global / shard_init / emit_state).
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
    table, exists, _ = _extract(above, track, **kw)
    return table, _capture(table, exists, extras)


def extract_gate_events_carried(
    above: torch.Tensor,
    track: torch.Tensor,
    extras: tuple[torch.Tensor, ...] = (),
    *,
    base_index: int,
    stream_len_global: int | None = None,
    gate_init: torch.Tensor | None = None,
    **kw,
) -> tuple[GateEvents, torch.Tensor | None, torch.Tensor]:
    """`extract_gate_events[_capture]` on the chunk of a stream whose
    sample 0 has the global index ``base_index``: every index in the table
    is global; ``stream_len_global`` (default: base + n) replaces the length
    in the close rule and masks above samples at or past it; peaks are
    tracked below min(stream_len_global, base + n); ``gate_init`` (..., 2)
    int32 [last-above global index, cluster count] primes the gate state
    (default [-1, 0]).  Returns (table, captured or None, gate_out (..., 2)
    int32 [last-above, cluster count] after the last sample)."""
    table, exists, gate_out = _extract(
        above, track, base_index=base_index, stream_len_global=stream_len_global,
        gate_init=gate_init, **kw)
    return table, (_capture(table, exists, extras, base_index) if extras else None), gate_out


def _capture(table, exists, extras, base_index=0):
    """Each channel of ``extras`` read at every existing slot's peak."""
    n = extras[0].shape[-1]
    if n == 0:
        return torch.zeros(exists.shape[:-1] + (len(extras),) + exists.shape[-1:],
                           dtype=extras[0].dtype, device=exists.device)
    local = table.peak_idx.to(torch.int64) - base_index
    ok = exists & (local >= 0) & (local < n)
    idx = local.clamp(0, n - 1)
    return torch.stack([torch.where(ok, a.gather(-1, idx), 0.0) for a in extras], dim=-2)


def _extract(above, track, *, hysteresis, max_events=8, valid_from=0, tie="first",
             emit_unclosed=True, base_index=0, stream_len_global=None, gate_init=None,
             ) -> tuple[GateEvents, torch.Tensor, torch.Tensor]:
    """The table, its ``exists`` mask (slot < gates found) and the gate
    carry after the last sample (see `extract_gate_events_carried`)."""
    if tie not in ("first", "last"):
        raise ValueError("tie must be 'first' or 'last'")
    n = above.shape[-1]
    h = max(int(hysteresis), 1)
    lead = tuple(above.shape[:-1])
    dev = above.device
    i64 = torch.int64
    if gate_init is None:
        la0 = torch.full(lead + (1,), -1, dtype=i64, device=dev)
        cnt0 = torch.zeros(lead + (1,), dtype=i64, device=dev)
    else:
        la0, cnt0 = gate_init[..., 0:1].to(i64), gate_init[..., 1:2].to(i64)
    if n == 0:
        return (empty_table(lead, max_events, track.dtype, dev),
                torch.zeros(lead + (max_events,), dtype=torch.bool, device=dev),
                torch.cat([la0, cnt0], dim=-1).to(torch.int32))
    Lg = base_index + n if stream_len_global is None else stream_len_global
    track_end = min(Lg, base_index + n)
    idx = base_index + torch.arange(n, dtype=i64, device=dev)
    above = above.to(torch.bool) & (idx >= valid_from) & (idx < Lg)

    last_above = torch.maximum(_last_above(above, idx), la0)
    below_run = idx - last_above
    prev_above = torch.maximum(torch.cat(
        [torch.full(lead + (1,), -1, dtype=i64, device=dev),
         last_above[..., :-1]], dim=-1), la0)
    new_cluster = above & ((prev_above < 0) | (idx - prev_above > h))
    cluster_id = cnt0 + torch.cumsum(new_cluster, dim=-1)  # 1-based, int64
    in_gate = (last_above >= 0) & (below_run <= h) & (cluster_id >= 1) & (idx < track_end)

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
        pidxs.append(torch.where(any_m, base_index + pi, -1 if tie == "last" else _I32_MAX))
        lasts.append(torch.where(above & (cluster_id == c), idx, -1).amax(dim=-1))
    gate_start = torch.stack(starts, dim=-1)
    peak_val = torch.stack(pvals, dim=-1)
    peak_idx = torch.stack(pidxs, dim=-1)
    close_raw = torch.stack(lasts, dim=-1) + h
    closed = close_raw <= Lg - 1

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
        gate_close=torch.where(exists, close_raw.clamp(0, Lg - 1), zero).to(i32),
        peak_idx=torch.where(exists, peak_idx, zero).to(i32),
        peak_value=torch.where(exists, peak_val, torch.zeros((), dtype=track.dtype,
                                                             device=dev)),
        count=valid.sum(dim=-1, dtype=i32),
        overflow=total > max_events,
    ), exists, torch.stack([last_above[..., -1], total], dim=-1).to(i32)


def gate_open_mask(above: torch.Tensor, hysteresis: int,
                   valid_from: int = 0) -> torch.Tensor:
    """Boolean gate-open mask (the reference FSMs' `gate_mask` arrays)."""
    n = above.shape[-1]
    h = max(int(hysteresis), 1)
    idx = torch.arange(n, dtype=torch.int64, device=above.device)
    la = _last_above(above.to(torch.bool) & (idx >= valid_from), idx)
    return (la >= 0) & (idx - la <= h)


# ---------------------------------------------------------------------------
# Run segmentation (plateau / gate-mask post-processing)
# ---------------------------------------------------------------------------

def _runs(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The contiguous True runs of a 1-D bool mask, in order: (first index,
    last index) of each, from its rising and falling edges."""
    d = torch.diff(mask.to(torch.int8), prepend=mask.new_zeros(1, dtype=torch.int8),
                   append=mask.new_zeros(1, dtype=torch.int8))
    return torch.nonzero(d == 1).flatten(), torch.nonzero(d == -1).flatten() - 1


def largest_true_run(mask: torch.Tensor) -> torch.Tensor:
    """Keep only the longest contiguous True run of a 1-D mask (ties: the
    earliest), as the standard-Minn gate cleanup does (reference
    minn.py:157-181)."""
    starts, ends = _runs(mask)
    if starts.numel() == 0:
        return mask
    best = torch.argmax(ends - starts)  # argmax: the first maximum
    idx = torch.arange(mask.shape[-1], device=mask.device)
    return (idx >= starts[best]) & (idx <= ends[best])


def earliest_long_run_end(mask: torch.Tensor, min_run: int) -> torch.Tensor:
    """Last index of the earliest True run of a 1-D mask that is at least
    ``min_run`` long; -1 if none (the segment search of the Schmidl-Cox
    plateau picker, reference sc.py:117-133).  A 0-d int64 tensor."""
    starts, ends = _runs(mask)
    ok = ends - starts + 1 >= min_run
    if not bool(ok.any()):
        return torch.tensor(-1, device=mask.device)
    return ends[torch.argmax(ok.to(torch.uint8))]


def mask_segments(mask) -> list[tuple[int, int]]:
    """Host helper: the contiguous [start, end) True segments of a boolean
    mask (a tensor on any device or an array; reference minn.py:307-319)."""
    m = (mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor)
         else np.asarray(mask)).astype(bool)
    if m.size == 0:
        return []
    d = np.diff(m.astype(np.int8))
    starts = list(np.flatnonzero(d == 1) + 1)
    ends = list(np.flatnonzero(d == -1) + 1)
    if m[0]:
        starts = [0] + starts
    if m[-1]:
        ends = ends + [m.size]
    return [(int(s), int(e)) for s, e in zip(starts, ends)]
