"""Fused Minn-RTL detection: IQ in, `GateEvents` out.

Port of the TPU kernels `ofdm_sync_tpu/kernels/pallas_minn_tm.py:_tm_kernel`
(`minn_rtl_detect_fused_tm`) and `pallas_minn.py:_detect_kernel`
(`minn_rtl_detect_fused_pallas`).  On the H100 the work is two CUDA
kernels (`csrc/minn_rtl_metric.cu`, `csrc/gate_events.cu`):

* kernel A, `minn_rtl_metric`: per-sample corr_positive and above, one CTA
  per (time chunk, stream), each chunk primed from a left halo;
* kernel B, `gate_events`: one CTA per stream walks its time tiles in order
  and writes the event table.  The [A][A] detector (`kernels.aa_fused`)
  uses it too, through `gate_events_capture`, which also reads side
  channels at each slot's peak.

Each wrapper takes the JAX package's channel-leading layout.  On a CUDA
tensor it launches its kernel (and counts the launch in ``.launches``, see
`kernels.launches`); on a CPU tensor it runs the plain PyTorch version
(`kernels.streaming`, `ops.detect.extract_gate_events`); any other device
raises.  There is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import check_kernel_device
from ofdm_sync_tpu_torch.kernels import build
from ofdm_sync_tpu_torch.kernels.streaming import minn_rtl_metric_planar
from ofdm_sync_tpu_torch.ops.detect import (
    GateEvents,
    empty_table,
    extract_gate_events,
    extract_gate_events_capture,
)

#: output samples per kernel-A CTA
CHUNK = 4096
#: kernel B's event-slot capacity
MAX_EVENTS = 128
#: dynamic shared memory a Hopper CTA may use
_SMEM_LIMIT = 227 * 1024
#: the kernels index samples in int32 and read up to one 2048-sample tile past L
_I32_LIMIT = 2**31 - 2 * 2048


def metric_halo(quarter_len: int, smooth_shift: int) -> int:
    """Left-halo samples that make a time chunk of kernel A independent of
    the samples before it: 3Q of delay-line reach plus the smoothing
    memory after which older terms weigh less than 2^-45 (the truncation
    of the TPU kernel's scan; `parallel/shard.py:_minn_halo_width` without
    its h-sample gate tail, since kernel B walks each stream in order)."""
    alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0
    decay = 1.0 - alpha
    scan_mem, step = 0, 1
    while np.float32(decay**step) > 2.0**-45:
        scan_mem += step
        step *= 2
    return 3 * quarter_len + scan_mem + 1


def _planar_view(x: torch.Tensor) -> torch.Tensor:
    """(C, batch, L) channel-leading -> (batch, C//2, 2, L)."""
    C, batch, L = x.shape
    return x.permute(1, 0, 2).reshape(batch, C // 2, 2, L)


def _check_input(x: torch.Tensor) -> None:
    if x.dim() != 3 or x.shape[0] % 2:
        raise ValueError(f"expected (2*branches, batch, L), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"expected float32 or int16 IQ, got {x.dtype}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def minn_rtl_metric(
    x: torch.Tensor,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel A.  x: (C, batch, L) float32 or int16 -> (corr_positive
    float32, above bool), each (batch, L)."""
    _check_input(x)
    C, batch, L = x.shape
    Q = quarter_len
    if check_kernel_device(x) == "cpu":
        st = minn_rtl_metric_planar(
            _planar_view(x), quarter_len=Q, smooth_shift=smooth_shift,
            threshold_value=threshold_value,
            threshold_frac_bits=threshold_frac_bits)
        return st.corr_positive, st.above_threshold
    if not x.is_contiguous():
        raise ValueError("kernel A needs a contiguous input")
    halo = metric_halo(Q, smooth_shift)
    smem = 2 * (halo + CHUNK) * 8
    if smem > _SMEM_LIMIT:
        raise ValueError(f"quarter_len {Q} needs {smem} B of shared memory")
    if L >= _I32_LIMIT:
        raise ValueError("streams must be shorter than 2^31 samples")
    corr = torch.empty((batch, L), dtype=torch.float32, device=x.device)
    above = torch.empty((batch, L), dtype=torch.uint8, device=x.device)
    if batch and L:
        lib = build.library()
        fn = lib.minn_rtl_metric_f32 if x.dtype == torch.float32 else lib.minn_rtl_metric_i16
        alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0
        err = fn(x.data_ptr(), C, batch, L, Q, halo, CHUNK, alpha, max(0, 3 * Q - 1),
                 float(1 << threshold_frac_bits), float(threshold_value),
                 corr.data_ptr(), above.data_ptr(), _stream(x))
        build.check(err, "minn_rtl_metric")
        minn_rtl_metric.launches += 1
    return corr, above.view(torch.bool)


minn_rtl_metric.launches = 0


def gate_events(
    above: torch.Tensor,
    track: torch.Tensor,
    *,
    hysteresis: int,
    max_events: int = 8,
    valid_from: int = 0,
    tie: str = "first",
    emit_unclosed: bool = True,
) -> GateEvents:
    """Kernel B.  above bool (batch, L), track float32 (batch, L) ->
    `GateEvents` (batch, max_events); same semantics as
    `ops.detect.extract_gate_events`."""
    return _gate_events(above, track, (), hysteresis=hysteresis, max_events=max_events,
                        valid_from=valid_from, tie=tie, emit_unclosed=emit_unclosed)[0]


gate_events.launches = 0


def gate_events_capture(
    above: torch.Tensor,
    track: torch.Tensor,
    extras: tuple[torch.Tensor, ...],
    **kw,
) -> tuple[GateEvents, torch.Tensor]:
    """Kernel B with peak capture: `gate_events` plus each of the up to
    three float32 (batch, L) ``extras`` read at every slot's peak index ->
    (table, captured (batch, len(extras), max_events)), zero where the slot
    holds no gate; same semantics as
    `ops.detect.extract_gate_events_capture`.  Counts on
    ``gate_events.launches``."""
    if not 1 <= len(extras) <= 3:
        raise ValueError("kernel B captures one to three channels")
    return _gate_events(above, track, tuple(extras), **kw)


def _gate_events(above, track, extras, *, hysteresis, max_events=8, valid_from=0,
                 tie="first", emit_unclosed=True):
    if tie not in ("first", "last"):
        raise ValueError("tie must be 'first' or 'last'")
    if not 1 <= max_events <= MAX_EVENTS:
        raise ValueError(f"max_events must be in [1, {MAX_EVENTS}]")
    if above.shape != track.shape or above.dim() != 2:
        raise ValueError("above and track must both be (batch, L)")
    if any(e.shape != track.shape for e in extras):
        raise ValueError("every captured channel must be (batch, L) like track")
    kw = dict(hysteresis=hysteresis, max_events=max_events, valid_from=valid_from,
              tie=tie, emit_unclosed=emit_unclosed)
    if check_kernel_device(above, track, *extras) == "cpu":
        if extras:
            return extract_gate_events_capture(above, track, extras, **kw)
        return extract_gate_events(above, track, **kw), None
    if above.dtype != torch.bool or any(t.dtype != torch.float32 for t in (track, *extras)):
        raise TypeError("kernel B takes bool above and float32 track and channels")
    if not all(t.is_contiguous() for t in (above, track, *extras)):
        raise ValueError("kernel B needs contiguous inputs")
    batch, L = above.shape
    if L >= _I32_LIMIT:
        raise ValueError("streams must be shorter than 2^31 samples")
    dev, E = track.device, max_events
    cap = torch.empty((batch, len(extras), E), dtype=torch.float32, device=dev)
    if batch == 0:
        return empty_table((0,), max_events, track.dtype, dev), (cap if extras else None)
    new = lambda dt, *s: torch.empty(s, dtype=dt, device=dev)  # noqa: E731
    valid, closed = new(torch.uint8, batch, E), new(torch.uint8, batch, E)
    start, close, pidx = (new(torch.int32, batch, E) for _ in range(3))
    pval = new(torch.float32, batch, E)
    count, overflow = new(torch.int32, batch), new(torch.uint8, batch)
    ex = [e.data_ptr() for e in extras] + [None] * (3 - len(extras))
    err = build.library().gate_events_f32(
        above.data_ptr(), track.data_ptr(), batch, L, valid_from, max(int(hysteresis), 1), E,
        int(tie == "last"), int(emit_unclosed), valid.data_ptr(), closed.data_ptr(),
        start.data_ptr(), close.data_ptr(), pidx.data_ptr(), pval.data_ptr(), count.data_ptr(),
        overflow.data_ptr(), *ex, len(extras), cap.data_ptr(), _stream(track))
    build.check(err, "gate_events")
    gate_events.launches += 1
    table = GateEvents(
        valid=valid.view(torch.bool), closed=closed.view(torch.bool),
        gate_start=start, gate_close=close, peak_idx=pidx, peak_value=pval,
        count=count, overflow=overflow.view(torch.bool))
    return table, (cap if extras else None)


def minn_rtl_detect_fused(
    x: torch.Tensor,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    max_events: int = 8,
    tie: str = "last",
    emit_unclosed: bool = False,
) -> GateEvents:
    """Fused Minn-RTL detection on the channel-leading layout.

    x: (2*branches, batch, L) float32 or int16, rows [b0_i, b0_q, b1_i,
    b1_q, ...] (the layout of `minn_rtl_detect_fused_pallas(
    channel_leading=True)`).  Returns `GateEvents` of shape (batch,
    max_events), peak-tracking corr_positive.  CUDA: kernel A then kernel
    B; CPU: the plain versions of both."""
    _check_input(x)
    corr, above = minn_rtl_metric(
        x, quarter_len=quarter_len, smooth_shift=smooth_shift,
        threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits)
    return gate_events(
        above, corr, hysteresis=hysteresis, max_events=max_events,
        valid_from=max(0, 3 * quarter_len - 1), tie=tie,
        emit_unclosed=emit_unclosed)
