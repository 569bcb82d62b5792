"""Chunked streaming detection with explicit carried state (port of
`ofdm_sync_tpu.kernels.streaming_chunked`).

The RTL detector is a streaming device: it consumes an endless IQ stream
and carries all its state in delay lines, running sums, the smoothing
register and the gate FSM (reference ref/minn_preamble_detector.sv).  This
module carries that state between calls, so a receiver processes an
unbounded stream chunk by chunk, or checkpoints and resumes mid-stream (a
state is a `NamedTuple` of tensors; `torch.save` / `torch.load` round-trip
it):

    state = minn_rtl_fused_stream_init(params, batch, device="cuda")
    for chunk in stream:                     # (2*branches, batch, chunk_len)
        state, table = minn_rtl_fused_stream_step(state, chunk, params=params)
        events += stitch_chunk_tables([table.select(0)], ...)  # or keep the tables

Two families, as in the JAX package:

* `minn_rtl_stream_*` (one stream, (branches, 2, n) chunks): plain PyTorch
  on the state's device, no kernel; the carries are re-derived with tensor
  operations, and `minn_rtl_stream_finalize` gives the event table so far.
* the fused steps `minn_rtl_fused_stream_step`, `aa_fused_stream_step`
  and `zc_cfar_fused_stream_step` (batched): one detect call per chunk,
  kernel A + B, C + B or D + B on a card, whose carried state (smoothing
  register, gate carry) the kernels emit themselves; each chunk gives its
  own table with global indices, and `stitch_chunk_tables` joins them.

``base`` (the global index of the next sample) is a host (CPU) int32
tensor in every state: the step knows it (base + chunk length), so no step
reads a value back from the card.  Global indices are int32: one epoch
spans 2^31 samples (~70 s at 30.72 Msps); `epoch_headroom` checks it and
the ``*_rebase`` helpers start a fresh epoch.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ofdm_sync_tpu_torch.kernels.aa_fused import aa_detect_fused
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import minn_rtl_detect_fused
from ofdm_sync_tpu_torch.kernels.zc_fused import zc_cfar_detect
from ofdm_sync_tpu_torch.ops.detect import GateEvents
from ofdm_sync_tpu_torch.ops.windows import linear_recurrence, running_sum_stream

_I32_MAX = 2**31 - 1
_NEG_INF = float("-inf")

#: Hard bound of one index epoch: global sample indices are int32 and the
#: open-ended fused steps pin the far horizon to 2^31 - 2, so state.base +
#: chunk_len must stay strictly below this (~70 s of stream at 30.72 Msps).
#: Call a ``*_rebase`` helper on a quiet stretch before the headroom runs
#: out; `epoch_headroom` is the host-side check.
EPOCH_HORIZON = 2**31 - 2
_EPOCH_WARN_MARGIN = 1 << 28  # ~268M samples (~8.7 s at 30.72 Msps)


def _base(value: int) -> torch.Tensor:
    """A state's ``base``: a 0-dim int32 tensor on the host."""
    return torch.tensor(value, dtype=torch.int32)


def epoch_headroom(state, *, warn_margin: int = _EPOCH_WARN_MARGIN) -> int:
    """Samples left in the current int32 index epoch (host-side guard).

    Works on any stream state with a ``.base`` field.  Warns when headroom
    drops under ``warn_margin`` and raises once the epoch is exhausted; a
    continuously running receiver calls this between chunks and invokes
    the matching ``*_rebase`` helper on a quiet stretch well before the
    horizon."""
    base = int(state.base)
    headroom = EPOCH_HORIZON - base
    if headroom <= 0:
        raise OverflowError(
            f"int32 index epoch exhausted (base={base} >= {EPOCH_HORIZON}); "
            "indices from further chunks would wrap -- rebase the stream "
            "state (minn_rtl_stream_rebase / *_fused_stream_rebase) on a "
            "quiet stretch before this point")
    if headroom < warn_margin:
        warnings.warn(
            f"index epoch nearly exhausted ({headroom} samples of headroom "
            f"left before {EPOCH_HORIZON}); rebase the stream state on the "
            "next quiet stretch", RuntimeWarning, stacklevel=2)
    return headroom


class MinnRTLStreamParams(NamedTuple):
    quarter_len: int
    smooth_shift: int
    threshold_value: int
    threshold_frac_bits: int
    hysteresis: int
    max_events: int = 8
    tie: str = "last"


class MinnRTLStreamState(NamedTuple):
    """Everything the plain detector carries between chunks."""

    hist: torch.Tensor        # (branches, 2, 3Q) planar IQ tail, float32
    smooth: torch.Tensor      # () float32 -- smoothing register
    base: torch.Tensor        # () int32 on the host -- global index of the next sample
    last_above: torch.Tensor  # () int32 -- global index of last above (-1)
    gate_count: torch.Tensor  # () int32 -- gates opened so far
    ev_start: torch.Tensor    # (E,) int32
    ev_last: torch.Tensor     # (E,) int32 last above per gate
    ev_pidx: torch.Tensor     # (E,) int32
    ev_pval: torch.Tensor     # (E,) float32


def _empty_events(params: MinnRTLStreamParams, device) -> dict:
    E = params.max_events
    i32 = dict(dtype=torch.int32, device=device)
    return dict(
        last_above=torch.full((), -1, **i32),
        gate_count=torch.zeros((), **i32),
        ev_start=torch.full((E,), _I32_MAX, **i32),
        ev_last=torch.full((E,), -1, **i32),
        ev_pidx=torch.full((E,), -1 if params.tie == "last" else _I32_MAX, **i32),
        ev_pval=torch.full((E,), _NEG_INF, dtype=torch.float32, device=device),
    )


def minn_rtl_stream_init(params: MinnRTLStreamParams, branches: int,
                         device: str | torch.device = "cuda") -> MinnRTLStreamState:
    Q = params.quarter_len
    return MinnRTLStreamState(
        hist=torch.zeros((branches, 2, 3 * Q), dtype=torch.float32, device=device),
        smooth=torch.zeros((), dtype=torch.float32, device=device),
        base=_base(0),
        **_empty_events(params, device),
    )


def minn_rtl_stream_step(state: MinnRTLStreamState, chunk: torch.Tensor, *,
                         params: MinnRTLStreamParams) -> MinnRTLStreamState:
    """Consume one planar chunk (branches, 2, n); return the updated state.

    The same algebra as `kernels.streaming.minn_rtl_metric_planar` over
    [hist | chunk] (the window sums from float64 cumulative sums), with the
    carried smoothing register frozen while the metric is not yet valid,
    then the event carry merge of the JAX step (`streaming_chunked.py:
    196-256`): the chunk's clusters continue the carried gate count and
    merge into the per-slot table."""
    Q = params.quarter_len
    H = 3 * Q
    h = max(int(params.hysteresis), 1)
    tie_last = params.tie == "last"
    alpha = 1.0 / (1 << params.smooth_shift) if params.smooth_shift > 0 else 1.0
    valid_from = max(0, 3 * Q - 1)
    n = chunk.shape[-1]
    base = int(state.base)
    dev = state.hist.device

    ext = torch.cat([state.hist, chunk.to(device=dev, dtype=torch.float32)], dim=-1)
    new_hist = ext[..., -H:].clone()
    i, q = ext[..., 0, :], ext[..., 1, :]
    iq_d = torch.nn.functional.pad(ext, (Q, 0))[..., : ext.shape[-1]]
    u = (i * iq_d[..., 0, :] + q * iq_d[..., 1, :]).sum(dim=0)
    p = (i * i + q * q).sum(dim=0)
    corr_pos = running_sum_stream(u, 2 * Q)[H:].clamp_min(0.0)
    energy_total = running_sum_stream(p, 3 * Q)[H:]

    gi = base + torch.arange(n, dtype=torch.int64, device=dev)
    metric_valid = gi >= valid_from
    a = torch.where(metric_valid, torch.tensor(1.0 - alpha, device=dev), torch.ones((), device=dev))
    b = torch.where(metric_valid, alpha * corr_pos, torch.zeros((), device=dev))
    # s[-1] = the carried register: a leading constant map (a = 0, b = smooth)
    smooth = linear_recurrence(torch.cat([torch.zeros(1, device=dev), a]),
                               torch.cat([state.smooth.reshape(1), b]))[1:]
    new_smooth = smooth[-1].clone() if n else state.smooth

    scaled = smooth * float(1 << params.threshold_frac_bits)
    above = metric_valid & (scaled >= energy_total * float(params.threshold_value))

    # --- event carry merge (plain twin of the kernels' gate machinery)
    la0 = state.last_above.to(torch.int64)
    la_local = torch.cummax(torch.where(above, gi, -1), dim=0).values
    last_above = torch.maximum(la_local, la0)
    prev_above = torch.maximum(
        torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev), la_local[:-1]]), la0)
    new_cluster = above & ((prev_above < 0) | (gi - prev_above > h))
    cluster_id = state.gate_count.to(torch.int64) + torch.cumsum(new_cluster, dim=0)
    in_gate = (last_above >= 0) & (gi - last_above <= h) & (cluster_id >= 1)

    ev_start, ev_last = state.ev_start.clone(), state.ev_last.clone()
    ev_pidx, ev_pval = state.ev_pidx.clone(), state.ev_pval.clone()
    neg_inf = torch.tensor(_NEG_INF, device=dev)
    for c in range(1, params.max_events + 1):
        if n == 0:
            break
        m = in_gate & (cluster_id == c)
        bstart = torch.where(m, gi, _I32_MAX).amin()
        masked = torch.where(m, corr_pos, neg_inf)
        ji = (n - 1) - torch.argmax(masked.flip(0)) if tie_last else torch.argmax(masked)
        bpv = masked[ji]
        bidx = torch.where(m.any(), gi[ji], -1 if tie_last else _I32_MAX)
        blast = torch.where(above & (cluster_id == c), gi, -1).amax()
        s = c - 1
        ev_start[s] = torch.minimum(ev_start[s], bstart.to(torch.int32))
        ev_last[s] = torch.maximum(ev_last[s], blast.to(torch.int32))
        cur = ev_pval[s]
        take = (bpv > cur) | ((bpv == cur) & (bpv > neg_inf)) if tie_last else bpv > cur
        ev_pval[s] = torch.maximum(cur, bpv)
        ev_pidx[s] = torch.where(take, bidx.to(torch.int32), ev_pidx[s])

    return MinnRTLStreamState(
        hist=new_hist,
        smooth=new_smooth,
        base=_base(base + n),
        last_above=last_above[-1].to(torch.int32) if n else state.last_above,
        gate_count=cluster_id[-1].to(torch.int32) if n else state.gate_count,
        ev_start=ev_start, ev_last=ev_last, ev_pidx=ev_pidx, ev_pval=ev_pval,
    )


def minn_rtl_stream_rebase(state: MinnRTLStreamState, *,
                           params: MinnRTLStreamParams) -> MinnRTLStreamState:
    """Start a fresh index epoch: clear the event table and restart the
    global sample counter at 3Q - 1 (the stream is warmed up, so every
    later sample stays metric-valid), keeping the IQ tail and the smoothing
    register.  An event index ``gi`` then maps to ``rebase_point + gi -
    (3Q - 1)``.  A gate still open at the rebase point is dropped: rebase on
    a quiet stretch."""
    return MinnRTLStreamState(
        hist=state.hist, smooth=state.smooth,
        base=_base(max(0, 3 * params.quarter_len - 1)),
        **_empty_events(params, state.hist.device),
    )


def minn_rtl_stream_finalize(state: MinnRTLStreamState, *, params: MinnRTLStreamParams,
                             emit_unclosed: bool = False) -> GateEvents:
    """Event table of the stream consumed so far (the state is not
    consumed: finalize mid-stream and keep feeding chunks)."""
    h = max(int(params.hysteresis), 1)
    E = params.max_events
    n = int(state.base)
    dev = state.ev_start.device
    slots = torch.arange(E, device=dev)
    exists = slots < torch.clamp(state.gate_count, max=E)
    close_raw = state.ev_last.to(torch.int64) + h
    closed = (close_raw <= n - 1) & exists
    valid = exists if emit_unclosed else exists & closed
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    return GateEvents(
        valid=valid,
        closed=closed,
        gate_start=torch.where(exists, state.ev_start, zi),
        gate_close=torch.where(exists, close_raw.clamp(0, max(n - 1, 0)).to(torch.int32), zi),
        peak_idx=torch.where(exists, state.ev_pidx, zi),
        peak_value=torch.where(exists, state.ev_pval, torch.zeros((), device=dev)),
        count=valid.sum(dtype=torch.int32),
        overflow=state.gate_count > E,
    )


# ---------------------------------------------------------------------------
# Fused streaming: one detect call per chunk, kernel-emitted carry
# ---------------------------------------------------------------------------

def _gate_carry(batch: int, device) -> torch.Tensor:
    """A fresh gate carry (batch, 2) int32: [last-above -1, count 0]."""
    g = torch.zeros((batch, 2), dtype=torch.int32, device=device)
    g[:, 0] = -1
    return g


def _gate_init(gate: torch.Tensor, base: int, hysteresis: int) -> torch.Tensor:
    """The next chunk's gate_init from the last one's gate_out: the gate
    continues iff the gap from its last above sample to the chunk seam is
    within the hysteresis (`streaming_chunked.py:395-399`); then [la, 1],
    else [-1, 0]."""
    h = max(int(hysteresis), 1)
    la = gate[:, 0]
    flag = ((la >= 0) & (base - la <= h)).to(torch.int32)
    return torch.stack([torch.where(flag > 0, la, -1), flag], dim=1)


def _new_hist(hist: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """The last H samples of [hist | chunk]."""
    H = hist.shape[-1]
    if chunk.shape[-1] >= H:
        return chunk[..., chunk.shape[-1] - H:].contiguous()
    return torch.cat([hist, chunk], dim=-1)[..., -H:].contiguous()


def _hist_width(n: int) -> int:
    """History width rounded up to 128, as the TPU kernels keep it."""
    return max(((n + 127) // 128) * 128, 128)


class MinnRTLFusedStreamState(NamedTuple):
    """Carried state of the fused Minn-RTL streaming receiver.  The
    smoothing register and the gate carry are emitted by kernels A and B
    themselves (`minn_rtl_detect_fused(emit_state=True)`)."""

    hist: torch.Tensor   # (C, batch, H) channel-leading planar IQ tail, float32
    carry: torch.Tensor  # (batch,) float32 -- smoothing register at chunk end
    gate: torch.Tensor   # (batch, 2) int32 -- [last-above global index, cluster count]
    base: torch.Tensor   # () int32 on the host -- global index of the next sample


def minn_rtl_fused_stream_init(params: MinnRTLStreamParams, batch: int, branches: int = 2,
                               device: str | torch.device = "cuda") -> MinnRTLFusedStreamState:
    return MinnRTLFusedStreamState(
        hist=torch.zeros((2 * branches, batch, _hist_width(3 * params.quarter_len)),
                         dtype=torch.float32, device=device),
        carry=torch.zeros((batch,), dtype=torch.float32, device=device),
        gate=_gate_carry(batch, device),
        base=_base(0),
    )


def minn_rtl_fused_stream_step(state: MinnRTLFusedStreamState, chunk: torch.Tensor, *,
                               params: MinnRTLStreamParams):
    """Process one chunk through the fused detector (kernels A + B on a
    card, their plain versions on the CPU).

    chunk: (C, batch, chunk_len) channel-leading planar, converted to
    float32.  Returns ``(new_state, GateEvents)``: the chunk's own event
    table with global indices.  A gate still open at the chunk edge
    surfaces as a trailing event (against the open-ended `EPOCH_HORIZON`
    every gate finalizes "closed", unclipped); the next chunk continues it
    through the gate carry, and `stitch_chunk_tables` joins the pieces and
    decides closed-ness against the stream end."""
    C, batch, Lc = chunk.shape
    chunk = chunk.to(torch.float32).contiguous()
    base = int(state.base)
    table, (carry_out, gate_out) = minn_rtl_detect_fused(
        chunk,
        quarter_len=params.quarter_len,
        smooth_shift=params.smooth_shift,
        threshold_value=params.threshold_value,
        threshold_frac_bits=params.threshold_frac_bits,
        hysteresis=params.hysteresis,
        max_events=params.max_events,
        tie=params.tie,
        emit_unclosed=True,
        base_index=base,
        stream_len_global=EPOCH_HORIZON,
        shard_init=(state.hist, state.carry, _gate_init(state.gate, base, params.hysteresis)),
        emit_state=True,
    )
    return MinnRTLFusedStreamState(
        hist=_new_hist(state.hist, chunk), carry=carry_out, gate=gate_out,
        base=_base(base + Lc)), table


def minn_rtl_fused_stream_rebase(state: MinnRTLFusedStreamState, *,
                                 params: MinnRTLStreamParams) -> MinnRTLFusedStreamState:
    """Fresh index epoch for the fused stream (the contract of
    `minn_rtl_stream_rebase`): the counter restarts at 3Q - 1 and a stale
    gate carry is dropped; IQ tail and smoothing register stay."""
    return MinnRTLFusedStreamState(
        hist=state.hist, carry=state.carry,
        gate=_gate_carry(state.gate.shape[0], state.gate.device),
        base=_base(max(0, 3 * params.quarter_len - 1)))


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def stitch_chunk_tables(tables, *, hysteresis: int, stream_end: int | None = None,
                        emit_unclosed: bool = False, tie_last: bool = True,
                        extras_list=None) -> list[dict]:
    """Host-side stitch of sequential per-chunk tables of ONE stream into
    one event list (NumPy dicts with start, close, pidx, pval, closed and,
    with ``extras_list``, extras).  A chunk's first gate continues the
    previous chunk's trailing gate iff ``start <= prev.close``: with the
    fused steps' unclipped closes (close = last_above + h) this is the exact
    gap test of the gate FSM.  The piece with the higher peak wins (ties by
    ``tie_last``, which must match the kernel's tie mode: ``tie_last=False``
    for the AA / ZC CFAR default ``tie='first'``), and its captures in
    ``extras_list`` (one dict name -> (E,) array per table) follow it.

    ``stream_end``: the total stream length; clips the final close to the
    one-shot semantics (close = min(last_above + h, L - 1), closed iff
    last_above + h <= L - 1).  Slice one stream out of the batched tables
    first (``table.select(b)``).  Warns when a chunk's table overflowed its
    capacity or an index nears `EPOCH_HORIZON`."""
    events: list[dict] = []
    overflowed = []
    for t_i, tb in enumerate(tables):
        if bool(_np(tb.overflow)):
            overflowed.append(t_i)
        count = _np(tb.count)
        if count.ndim != 0:
            raise ValueError(
                "stitch_chunk_tables expects single-stream tables (scalar count); got count "
                f"shape {count.shape} -- slice one stream first: table.select(b)")
        starts, closes = _np(tb.gate_start), _np(tb.gate_close)
        pidxs, pvals = _np(tb.peak_idx), _np(tb.peak_value)
        extras_np = ({name: _np(arr) for name, arr in extras_list[t_i].items()}
                     if extras_list is not None else None)
        for k in range(int(count)):
            ev = {"start": int(starts[k]), "close": int(closes[k]),
                  "pidx": int(pidxs[k]), "pval": float(pvals[k])}
            if extras_np is not None:
                ev["extras"] = {name: arr[k] for name, arr in extras_np.items()}
            if events and ev["start"] <= events[-1]["close"]:
                prev = events[-1]
                better = ev["pval"] > prev["pval"] or (
                    ev["pval"] == prev["pval"]
                    and (ev["pidx"] > prev["pidx"] if tie_last else ev["pidx"] < prev["pidx"]))
                if better:
                    prev["pidx"], prev["pval"] = ev["pidx"], ev["pval"]
                    if "extras" in ev:
                        prev["extras"] = ev["extras"]
                prev["close"] = max(prev["close"], ev["close"])
            else:
                events.append(ev)
    if overflowed:
        warnings.warn(
            f"{len(overflowed)} chunk table(s) (indices {overflowed[:8]}...) overflowed "
            "max_events capacity; events dropped by the kernel are missing from the "
            "stitched list -- raise max_events or shorten chunks", RuntimeWarning, stacklevel=2)
    if events and events[-1]["close"] >= EPOCH_HORIZON - _EPOCH_WARN_MARGIN:
        warnings.warn("event indices approach the int32 EPOCH_HORIZON; rebase the stream "
                      "state (see epoch_headroom)", RuntimeWarning, stacklevel=2)
    for ev in events:
        ev["closed"] = True if stream_end is None else ev["close"] <= stream_end - 1
        if stream_end is not None:
            ev["close"] = min(ev["close"], stream_end - 1)
    if not emit_unclosed:
        events = [e for e in events if e["closed"]]
    return events


class AAFusedStreamState(NamedTuple):
    """Carried state of the fused [A][A] streaming receiver: the 2L-sample
    IQ tail and the gate carry emitted by kernel B (the AA metric has no
    smoothing IIR)."""

    hist: torch.Tensor  # (C, batch, H) channel-leading planar IQ tail, float32
    gate: torch.Tensor  # (batch, 2) int32 -- [last-above global index, cluster count]
    base: torch.Tensor  # () int32 on the host -- global index of the next sample


def aa_fused_stream_init(half_len: int, batch: int, branches: int = 2,
                         device: str | torch.device = "cuda") -> AAFusedStreamState:
    return AAFusedStreamState(
        hist=torch.zeros((2 * branches, batch, _hist_width(2 * half_len)),
                         dtype=torch.float32, device=device),
        gate=_gate_carry(batch, device),
        base=_base(0),
    )


def aa_fused_stream_step(state: AAFusedStreamState, chunk: torch.Tensor, *, half_len: int,
                         threshold: float = 0.15, hysteresis: int = 128, max_events: int = 8,
                         tie: str = "first"):
    """One fused detect call (kernels C + B with peak capture on a card)
    over one [A][A] chunk (C, batch, chunk_len), converted to float32.
    Returns ``(new_state, (GateEvents, P_at_peak (batch, 2, E), M_at_peak
    (batch, E)))`` with global indices; stitch per stream with
    `stitch_chunk_tables(tie_last=False)` and the per-chunk captures as
    ``extras_list`` so the winning piece's CFO capture survives."""
    chunk = chunk.to(torch.float32).contiguous()
    base = int(state.base)
    table, P_pk, M_pk, gate_out = aa_detect_fused(
        chunk, half_len=half_len, threshold=threshold, hysteresis=hysteresis,
        max_events=max_events, tie=tie, emit_unclosed=True, base_index=base,
        stream_len_global=EPOCH_HORIZON,
        shard_init=(state.hist, _gate_init(state.gate, base, hysteresis)), emit_state=True)
    return AAFusedStreamState(hist=_new_hist(state.hist, chunk), gate=gate_out,
                              base=_base(base + chunk.shape[-1])), (table, P_pk, M_pk)


def aa_fused_stream_rebase(state: AAFusedStreamState, *, half_len: int) -> AAFusedStreamState:
    """Fresh index epoch for the fused [A][A] stream: the counter restarts
    past the 2L - 1 warm-up and a stale gate carry is dropped."""
    return AAFusedStreamState(hist=state.hist,
                              gate=_gate_carry(state.gate.shape[0], state.gate.device),
                              base=_base(2 * half_len - 1))


class ZCCFARFusedStreamState(NamedTuple):
    """Carried state of the fused ZC CFAR streaming receiver over
    matched-filter magnitudes: the W-sample magnitude tail and the gate
    carry emitted by kernel B."""

    hist: torch.Tensor  # (batch, H) trailing magnitudes, float32
    gate: torch.Tensor  # (batch, 2) int32 -- [last-above global index, cluster count]
    base: torch.Tensor  # () int32 on the host -- global index of the next sample


def zc_cfar_fused_stream_init(corr_window: int, batch: int,
                              device: str | torch.device = "cuda") -> ZCCFARFusedStreamState:
    return ZCCFARFusedStreamState(
        hist=torch.zeros((batch, _hist_width(corr_window)), dtype=torch.float32,
                         device=device),
        gate=_gate_carry(batch, device),
        base=_base(0),
    )


def zc_cfar_fused_stream_step(state: ZCCFARFusedStreamState, chunk: torch.Tensor, *,
                              corr_window: int = 2048, threshold_value: int | None = None,
                              threshold_frac_bits: int = 15, min_corr_mag: float = 0.3,
                              hysteresis: int = 256, max_events: int = 16,
                              tie: str = "first"):
    """One fused detect call (kernels D + B on a card) over one chunk of
    matched-filter magnitudes (batch, chunk_len), converted to float32.
    Returns ``(new_state, GateEvents)`` with global indices; stitch per
    stream with `stitch_chunk_tables(tie_last=False)`."""
    chunk = chunk.to(torch.float32).contiguous()
    base = int(state.base)
    table, gate_out = zc_cfar_detect(
        chunk, corr_window=corr_window, threshold_value=threshold_value,
        threshold_frac_bits=threshold_frac_bits, min_corr_mag=min_corr_mag,
        hysteresis=hysteresis, max_events=max_events, tie=tie, emit_unclosed=True,
        base_index=base, stream_len_global=EPOCH_HORIZON,
        shard_init=(state.hist, _gate_init(state.gate, base, hysteresis)), emit_state=True)
    return ZCCFARFusedStreamState(hist=_new_hist(state.hist, chunk), gate=gate_out,
                                  base=_base(base + chunk.shape[-1])), table


# a saved state loads back as its class under torch.load's default
# weights_only=True (the fields are tensors)
if hasattr(torch.serialization, "add_safe_globals"):
    torch.serialization.add_safe_globals(
        [MinnRTLStreamState, MinnRTLFusedStreamState, AAFusedStreamState,
         ZCCFARFusedStreamState])
