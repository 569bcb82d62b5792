"""Fused Minn-RTL detection: IQ in, `GateEvents` out.

Port of the TPU kernels `ofdm_sync_tpu/kernels/pallas_minn_tm.py:_tm_kernel`
(`minn_rtl_detect_fused_tm`, #1), `pallas_minn.py:_detect_kernel`
(`minn_rtl_detect_fused_pallas`, #2, with its carried-state modes),
`pallas_minn.py:_minn_kernel` (`minn_rtl_metric_planar_pallas`, #3) and
`pallas_minn.py:_corr_energy_kernel` (`minn_rtl_corr_energy_planar_pallas`,
#4).  On the H100 the work is two CUDA kernels (`csrc/minn_rtl_metric.cu`,
`csrc/gate_events.cu`):

* kernel A, `minn_rtl_metric`: the per-sample metric.  Each CTA walks a
  span of consecutive tiles of one stream in order, carrying the delay
  line, the window sums and the smoothing register from tile to tile; a
  span primes once, from a left halo or, at the stream's head, from the
  history.  Its output modes: corr_positive and above (#1, #2), the full
  metric with smooth and energy (#3, `minn_rtl_metric_planar_fused`),
  corr_positive and energy without the IIR (#4,
  `minn_rtl_corr_energy_planar_fused`).  int16 codes of up to two branches
  without a history take its exact integer path (window sums in integers,
  corr and energy bit-identical to the float path's).  Primed, it starts
  from the IQ history and smoothing register of the chunk before
  (``base_index``, ``hist_init``, ``carry_init``) and can return the
  register at its last sample (``emit_state``);
* kernel B, `gate_events`: span-parallel.  Per span a summary (first and
  last above index, cluster starts), a scan of the summaries gives the gate
  state entering each span, and each span merges its clusters into the
  stream's slots; where batch alone fills the card one CTA walks each
  stream.  Its carried-state mode takes global indices (``base_index``,
  ``stream_len_global``) and the gate carry in and out (``gate_init``,
  ``emit_state``).  The [A][A] detector (`kernels.aa_fused`) uses it too,
  through `gate_events_capture`, which also reads side channels at each
  slot's peak.

Kernel F, `minn_rtl_step` (`csrc/minn_rtl_step.cu`), is TPU kernel #2 in
its streaming mode as the JAX package's `streaming_chunked.
minn_rtl_fused_stream_step` runs it, one compiled program a chunk: the
gate-carry rule, A's primed metric, B's carried gate walk and the history
roll in one launch, one CTA a stream walking the chunk from its history,
corr and above never in HBM, the table, the register, the gate carry and
the new history in one allocation.  Its plain version,
`minn_rtl_step_plain`, is the same function composed (`gate_continuation`,
`minn_rtl_detect_fused`, `new_history`); on card tensors that composition
launches A and B.

Each wrapper takes the JAX package's channel-leading layout.  On a CUDA
tensor it launches its kernel (and counts the launch in ``.launches``, and
the mode in ``.modes``, see `kernels.launches`); on a CPU tensor it runs the
plain PyTorch version (`kernels.streaming`, `ops.detect`); any other device
raises.  There is no fallback from one to the other.  Under torch.profiler
each wrapper records its spans (`utils.profiling.wrapper_spans`: the call,
and on the card its ``.prep`` with ``.alloc``, then its ``.launch``).
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import check_kernel_device
from ofdm_sync_tpu_torch.kernels import build
from ofdm_sync_tpu_torch.kernels.streaming import (
    MinnRTLFastState,
    minn_rtl_corr_energy_planar,
    minn_rtl_metric_planar,
)
from ofdm_sync_tpu_torch.ops.detect import (
    GateEvents,
    empty_table,
    extract_gate_events_carried,
)
from ofdm_sync_tpu_torch.utils.profiling import NO_SPAN, SPAN_PREFIX, span, wrapper_spans

#: kernel B's event-slot capacity
MAX_EVENTS = 128
#: dynamic shared memory a Hopper CTA may use (less kernel A's static part)
_SMEM_LIMIT = 227 * 1024 - 1024
#: samples per tile of kernel A (256 threads x 4) and of kernel B (256 x 16)
_A_TILE, _B_TILE = 1024, 4096
#: samples per tile of kernel A's exact int16 path (128 threads x 8)
_A_EXACT_TILE = 1024
#: the kernels index samples in int32 and walk up to one tile past the
#: end: base + L stays below this
_I32_LIMIT = 2**31 - 2 * _B_TILE

#: the spans of kernels A, B and F's wrappers (`utils.profiling.span`) and
#: of the batch detector
_A_SPANS = wrapper_spans("minn_rtl_metric")
_B_SPANS = wrapper_spans("gate_events")
_F_SPANS = wrapper_spans("minn_rtl_step")
_DETECT_SPAN = SPAN_PREFIX + "minn_rtl_detect_fused"

#: kernel A's output modes: name -> outputs written
_A_MODES = {
    "corr_above": ("corr", "above"),
    "full": ("corr", "smooth", "energy", "above"),
    "corr_energy": ("corr", "energy"),
}


class MinnMetricRows(NamedTuple):
    """Kernel A's outputs, each (batch, L) (carry_out (batch,)); the fields
    a mode does not produce are None."""

    corr: torch.Tensor
    smooth: torch.Tensor | None
    energy: torch.Tensor | None
    above: torch.Tensor | None
    carry_out: torch.Tensor | None


def metric_halo(quarter_len: int, smooth_shift: int) -> int:
    """Left-halo samples that make a span of kernel A independent of the
    samples before it: 3Q of delay-line reach plus the smoothing memory
    after which older terms weigh less than 2^-45 (the truncation of the
    TPU kernel's scan; `parallel/shard.py:_minn_halo_width` without its
    h-sample gate tail, since kernel B carries the gate across spans)."""
    alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0
    decay = 1.0 - alpha
    scan_mem, step = 0, 1
    while np.float32(decay**step) > 2.0**-45:
        scan_mem += step
        step *= 2
    return 3 * quarter_len + scan_mem + 1


def _exact_smem(C: int, Q: int, mode: str) -> int:
    """Shared memory of kernel A's exact int16 path: the int16 delay line
    and the int32 quarter-product and power rings, 3Q + 1024 entries each
    (rounded up to 8), and a staging buffer for its stores where the mode
    writes more than one float output."""
    ring = -(-(3 * Q + _A_EXACT_TILE) // 8) * 8
    floats = sum(f != "above" for f in _A_MODES[mode])
    return (2 * C + 8) * ring + (4 * _A_EXACT_TILE if floats > 1 else 0)


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


def host_index(base_index) -> int:
    """A global sample index as a host integer: an int, a NumPy integer or
    a CPU tensor.  A CUDA tensor raises: reading it would synchronize."""
    if isinstance(base_index, torch.Tensor):
        if base_index.device.type != "cpu":
            raise ValueError("base_index must live on the host (it is known: base + chunk)")
        return int(base_index)
    return int(base_index)


def check_index_range(base: int, L: int) -> None:
    """The kernels' int32 sample indices hold global indices base .. base + L."""
    if base < 0 or base + L >= _I32_LIMIT:
        raise ValueError(f"base_index {base} + L {L} leaves the int32 index range")


def _history(hist: torch.Tensor | None, lead: tuple, what: str) -> torch.Tensor | None:
    """A right-aligned history as a contiguous float32 tensor (lead..., Hh)."""
    if hist is None:
        return None
    if tuple(hist.shape[:-1]) != lead:
        raise ValueError(f"{what} must be {lead} + (width,), got {tuple(hist.shape)}")
    return hist.to(torch.float32).contiguous()


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _carve(dev, fields) -> dict:
    """One allocation cut into the (name, dtype, shape) fields, each
    starting on a 16-byte boundary: a contiguous view per field (one
    `as_strided` each), or, where dtype is None, the address of ``shape``
    bytes of scratch."""
    at, offsets = 0, []
    for _, dt, shape in fields:
        offsets.append(at)
        at += -(-(shape if dt is None else math.prod(shape) * dt.itemsize) // 16) * 16
    buf = torch.empty(max(at, 16), dtype=torch.uint8, device=dev)
    typed, out = {}, {}
    for (name, dt, shape), o in zip(fields, offsets):
        if dt is None:
            out[name] = buf.data_ptr() + o
            continue
        if dt not in typed:
            typed[dt] = buf.view(dt)
        strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        out[name] = typed[dt].as_strided(shape, strides, o // dt.itemsize)
    return out


def _count(fn, *modes: str) -> None:
    fn.launches += 1
    for m in modes:
        fn.modes[m] += 1


def _minn_metric(
    x: torch.Tensor,
    mode: str,
    *,
    quarter_len: int,
    smooth_shift: int = 0,
    threshold_value: int = 0,
    threshold_frac_bits: int = 0,
    base_index=0,
    hist_init: torch.Tensor | None = None,
    carry_init: torch.Tensor | None = None,
    emit_state: bool = False,
    failed_tiles: torch.Tensor | None = None,
) -> MinnMetricRows:
    """Kernel A in one of its output modes (`_A_MODES`), plain or primed.

    On the card, int16 codes of up to two branches without a history take
    the kernel's exact integer path (mode ``exact_i16``) where its rings fit
    in shared memory (at two branches Q up to 4,480; 4,394 where the mode
    writes more than one float output).  ``failed_tiles``, a one-element int32
    tensor on x's device, gains the tiles that path walked on its float
    route (a code out of its exact range within a tile's reach); the plain
    version leaves it as it is."""
    with span(_A_SPANS.call):
        # prep on the card path only (a CPU tensor runs the plain version)
        with span(_A_SPANS.prep) if x.is_cuda else NO_SPAN:
            _check_input(x)
            C, batch, L = x.shape
            Q = quarter_len
            base = host_index(base_index)
            scan = mode != "corr_energy"
            if not scan and (carry_init is not None or emit_state):
                raise ValueError("the corr/energy mode has no smoothing register")
            hist = _history(hist_init, (C, batch), "hist_init")
            if carry_init is not None and tuple(carry_init.shape) != (batch,):
                raise ValueError(f"carry_init must be ({batch},), got {tuple(carry_init.shape)}")
            metric = dict(quarter_len=Q, smooth_shift=smooth_shift,
                          threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits)
            if check_kernel_device(x, *(t for t in (hist, carry_init) if t is not None)) == "cpu":
                hist_p = None if hist is None else _planar_view(hist)
                if not scan:
                    corr, energy = minn_rtl_corr_energy_planar(_planar_view(x), quarter_len=Q,
                                                               hist_init=hist_p)
                    return MinnMetricRows(corr, None, energy, None, None)
                st = minn_rtl_metric_planar(_planar_view(x), **metric, base_index=base,
                                            hist_init=hist_p, carry_init=carry_init)
                carry_out = None
                if emit_state:
                    carry_out = (st.smooth_metric[:, -1] if L else
                                 torch.zeros(batch) if carry_init is None else carry_init.float())
                wanted = _A_MODES[mode]
                pick = lambda name, t: t if name in wanted else None  # noqa: E731
                return MinnMetricRows(st.corr_positive, pick("smooth", st.smooth_metric),
                                      pick("energy", st.energy_total), st.above_threshold,
                                      carry_out)
            if L > 1 and x.stride(-1) != 1:
                raise ValueError(f"kernel A reads a view with unit stride along time, got "
                                 f"strides {x.stride()}")
            if C > 8:
                raise ValueError(f"kernel A takes at most 4 branches, got {C // 2}")
            ring = lambda n: -(-n // 4) * 4  # noqa: E731
            smem = 4 * (C * ring(Q + _A_TILE) + 2 * ring(3 * Q + _A_TILE))
            if smem > _SMEM_LIMIT:
                raise ValueError(f"quarter_len {Q} needs {smem} B of shared memory")
            check_index_range(base, L)
            if failed_tiles is not None and (failed_tiles.dtype != torch.int32
                                             or failed_tiles.device != x.device
                                             or not failed_tiles.is_contiguous()):
                raise ValueError("failed_tiles must be a contiguous int32 tensor on x's device")
            dev = x.device
            with span(_A_SPANS.alloc):
                out = {name: torch.empty((batch, L), dtype=torch.bool if name == "above"
                                         else torch.float32, device=dev)
                       for name in _A_MODES[mode]}
                carry_out = out["carry_out"] = (torch.empty(batch, device=dev) if emit_state
                                                else None)
            carry = None if carry_init is None else carry_init.to(torch.float32).contiguous()
            alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0
            exact = (x.dtype == torch.int16 and hist is None and C <= 4
                     and _exact_smem(C, Q, mode) <= _SMEM_LIMIT)
        with span(_A_SPANS.launch):
            if emit_state and not L:  # no sample: the register passes through
                if carry is None:
                    carry_out.zero_()
                else:
                    carry_out.copy_(carry)
            if batch and L:
                err = build.library().minn_rtl_metric(
                    int(x.dtype == torch.int16), int(exact), x.data_ptr(), _ptr(hist), _ptr(carry),
                    C, batch, L, x.stride(0), x.stride(1), Q, metric_halo(Q, smooth_shift),
                    0 if hist is None else hist.shape[-1], int(scan), base, alpha,
                    max(0, 3 * Q - 1), float(1 << threshold_frac_bits), float(threshold_value),
                    *(_ptr(out.get(f)) for f in ("corr", "smooth", "energy", "above",
                                                 "carry_out")),
                    _ptr(failed_tiles), _stream(x))
                build.check(err, "minn_rtl_metric")
                primed = hist is not None or carry is not None or base != 0 or emit_state
                _count(minn_rtl_metric, mode, *(("primed",) if primed else ()),
                       *(("strided",) if not x.is_contiguous() else ()),
                       *(("exact_i16",) if exact else ()))
        return MinnMetricRows(out["corr"], out.get("smooth"), out.get("energy"),
                              out.get("above"), carry_out)


def minn_rtl_metric(
    x: torch.Tensor,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    base_index=0,
    hist_init: torch.Tensor | None = None,
    carry_init: torch.Tensor | None = None,
    emit_state: bool = False,
):
    """Kernel A.  x: (C, batch, L) float32 or int16 -> (corr_positive
    float32, above bool), each (batch, L), and with ``emit_state`` the
    smoothing register at the last sample, carry_out (batch,) float32.
    Primed: ``base_index`` (a host integer) is the global index of sample
    0, ``hist_init`` (C, batch, <=H) float32 the samples before it,
    right-aligned, ``carry_init`` (batch,) the register before it.

    x may be a strided view with unit stride along time, such as the block
    subrange ``shard[..., a:b]`` (the counterpart of the TPU kernel's
    ``in_block_stride`` / ``in_block_offset``): the kernel reads it in place,
    and the launch counts as mode ``strided``; any other view raises."""
    o = _minn_metric(x, "corr_above", quarter_len=quarter_len, smooth_shift=smooth_shift,
                     threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits,
                     base_index=base_index, hist_init=hist_init, carry_init=carry_init,
                     emit_state=emit_state)
    return (o.corr, o.above, o.carry_out) if emit_state else (o.corr, o.above)


minn_rtl_metric.launches = 0
minn_rtl_metric.modes = collections.Counter()


def minn_rtl_metric_planar_fused(
    x: torch.Tensor,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    base_index=0,
    hist_init: torch.Tensor | None = None,
    carry_init: torch.Tensor | None = None,
) -> MinnRTLFastState:
    """#3: kernel A's full metric on the channel-leading layout (the
    counterpart of `minn_rtl_metric_planar_pallas(channel_leading=True)`):
    corr_positive, smooth_metric, energy_total float32 and above_threshold
    bool, each (batch, L).  Primed as `minn_rtl_metric`."""
    o = _minn_metric(x, "full", quarter_len=quarter_len, smooth_shift=smooth_shift,
                     threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits,
                     base_index=base_index, hist_init=hist_init, carry_init=carry_init)
    return MinnRTLFastState(corr_positive=o.corr, smooth_metric=o.smooth,
                            energy_total=o.energy, above_threshold=o.above,
                            valid_from=max(0, 3 * quarter_len - 1))


def minn_rtl_corr_energy_planar_fused(
    x: torch.Tensor, *, quarter_len: int, hist_init: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """#4: kernel A without the IIR (the counterpart of
    `minn_rtl_corr_energy_planar_pallas(channel_leading=True)`): x (C,
    batch, L) -> (corr_positive, energy_total), each (batch, L) float32.
    ``hist_init`` (C, batch, <=H): the samples before sample 0."""
    o = _minn_metric(x, "corr_energy", quarter_len=quarter_len, hist_init=hist_init)
    return o.corr, o.energy


def gate_events(
    above: torch.Tensor,
    track: torch.Tensor,
    *,
    hysteresis: int,
    max_events: int = 8,
    valid_from: int = 0,
    tie: str = "first",
    emit_unclosed: bool = True,
    base_index=0,
    stream_len_global: int | None = None,
    gate_init: torch.Tensor | None = None,
    emit_state: bool = False,
):
    """Kernel B.  above bool (batch, L), track float32 (batch, L) ->
    `GateEvents` (batch, max_events); same semantics as
    `ops.detect.extract_gate_events`.  Carried state (`ops.detect.
    extract_gate_events_carried`): sample 0 has the global index
    ``base_index``, ``stream_len_global`` is the global length of the close
    rule, ``gate_init`` (batch, 2) int32 [last-above, cluster count] primes
    the gate; with ``emit_state`` returns (table, gate_out (batch, 2))."""
    table, _, gate_out = _gate_events(
        above, track, (), hysteresis=hysteresis, max_events=max_events, valid_from=valid_from,
        tie=tie, emit_unclosed=emit_unclosed, base_index=base_index,
        stream_len_global=stream_len_global, gate_init=gate_init, emit_state=emit_state)
    return (table, gate_out) if emit_state else table


gate_events.launches = 0
gate_events.modes = collections.Counter()


def gate_events_capture(
    above: torch.Tensor,
    track: torch.Tensor,
    extras: tuple[torch.Tensor, ...],
    *,
    emit_state: bool = False,
    **kw,
):
    """Kernel B with peak capture: `gate_events` plus each of the up to
    three float32 (batch, L) ``extras`` read at every slot's peak index ->
    (table, captured (batch, len(extras), max_events)), zero where the slot
    holds no gate, and gate_out with ``emit_state``; same semantics as
    `ops.detect.extract_gate_events_capture`.  Counts on
    ``gate_events.launches``."""
    if not 1 <= len(extras) <= 3:
        raise ValueError("kernel B captures one to three channels")
    table, cap, gate_out = _gate_events(above, track, tuple(extras), emit_state=emit_state, **kw)
    return (table, cap, gate_out) if emit_state else (table, cap)


def _gate_events(above, track, extras, *, hysteresis, max_events=8, valid_from=0,
                 tie="first", emit_unclosed=True, base_index=0, stream_len_global=None,
                 gate_init=None, emit_state=False):
    with span(_B_SPANS.call):
        # prep on the card path only (a CPU tensor runs the plain version)
        with span(_B_SPANS.prep) if above.is_cuda else NO_SPAN:
            if tie not in ("first", "last"):
                raise ValueError("tie must be 'first' or 'last'")
            if not 1 <= max_events <= MAX_EVENTS:
                raise ValueError(f"max_events must be in [1, {MAX_EVENTS}]")
            if above.shape != track.shape or above.dim() != 2:
                raise ValueError("above and track must both be (batch, L)")
            if any(e.shape != track.shape for e in extras):
                raise ValueError("every captured channel must be (batch, L) like track")
            batch, L = above.shape
            if gate_init is not None and tuple(gate_init.shape) != (batch, 2):
                raise ValueError(f"gate_init must be ({batch}, 2), got {tuple(gate_init.shape)}")
            base = host_index(base_index)
            Lg = base + L if stream_len_global is None else int(stream_len_global)
            kw = dict(hysteresis=hysteresis, max_events=max_events, valid_from=valid_from,
                      tie=tie, emit_unclosed=emit_unclosed)
            carried = (gate_init is not None or base != 0 or stream_len_global is not None
                       or emit_state)
            tensors = (above, track, *extras, *(() if gate_init is None else (gate_init,)))
            if check_kernel_device(*tensors) == "cpu":
                return extract_gate_events_carried(above, track, extras, base_index=base,
                                                   stream_len_global=Lg, gate_init=gate_init,
                                                   **kw)
            if above.dtype != torch.bool or any(t.dtype != torch.float32
                                                for t in (track, *extras)):
                raise TypeError("kernel B takes bool above and float32 track and channels")
            if not all(t.is_contiguous() for t in (above, track, *extras)):
                raise ValueError("kernel B needs contiguous inputs")
            check_index_range(base, L)
            if not 0 <= Lg < 2**31:
                raise ValueError(f"stream_len_global {Lg} leaves the int32 index range")
            dev, E = track.device, max_events
            if batch == 0:
                return (empty_table((0,), max_events, track.dtype, dev),
                        torch.empty((0, len(extras), E), device=dev) if extras else None,
                        torch.empty((0, 2), dtype=torch.int32, device=dev) if emit_state
                        else None)
            ginit = gate_init
            if ginit is not None and (ginit.dtype != torch.int32 or not ginit.is_contiguous()):
                ginit = ginit.to(torch.int32).contiguous()
            # one allocation: the table, the captured channels, gate_out, and the
            # scratch of the span-parallel mode (span summaries, merged slots)
            span_cap = max(1, -(-L // _B_TILE))
            with span(_B_SPANS.alloc):
                o = _carve(dev, [("start", torch.int32, (batch, E)),
                                 ("close", torch.int32, (batch, E)),
                                 ("pidx", torch.int32, (batch, E)),
                                 ("pval", torch.float32, (batch, E)),
                                 ("count", torch.int32, (batch,)),
                                 ("valid", torch.bool, (batch, E)),
                                 ("closed", torch.bool, (batch, E)),
                                 ("overflow", torch.bool, (batch,)),
                                 ("scratch", None, batch * (16 * span_cap + 16 * E + 4))]
                           + [("cap", torch.float32, (batch, len(extras), E))] * bool(extras)
                           + [("gate_out", torch.int32, (batch, 2))] * bool(emit_state))
            ex = [e.data_ptr() for e in extras] + [None] * (3 - len(extras))
        with span(_B_SPANS.launch):
            err = build.library().gate_events_f32(
                above.data_ptr(), track.data_ptr(), batch, L, valid_from,
                max(int(hysteresis), 1), E, int(tie == "last"), int(emit_unclosed),
                o["valid"].data_ptr(), o["closed"].data_ptr(), o["start"].data_ptr(),
                o["close"].data_ptr(), o["pidx"].data_ptr(), o["pval"].data_ptr(),
                o["count"].data_ptr(), o["overflow"].data_ptr(),
                *ex, len(extras), _ptr(o.get("cap")), base, Lg, _ptr(ginit),
                _ptr(o.get("gate_out")), o["scratch"], span_cap, _stream(track))
            build.check(err, "gate_events")
            _count(gate_events, *(("primed",) if carried else ()))
        table = GateEvents(
            valid=o["valid"], closed=o["closed"], gate_start=o["start"], gate_close=o["close"],
            peak_idx=o["pidx"], peak_value=o["pval"], count=o["count"], overflow=o["overflow"])
        return table, o.get("cap"), o.get("gate_out")


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
    base_index=None,
    stream_len_global: int | None = None,
    shard_init: tuple | None = None,
    emit_state: bool = False,
):
    """Fused Minn-RTL detection on the channel-leading layout (#1, #2).

    x: (2*branches, batch, L) float32 or int16, rows [b0_i, b0_q, b1_i,
    b1_q, ...] (the layout of `minn_rtl_detect_fused_pallas(
    channel_leading=True)`).  Returns `GateEvents` of shape (batch,
    max_events), peak-tracking corr_positive.  CUDA: kernel A then kernel
    B; CPU: the plain versions of both.

    Carried state, as `minn_rtl_detect_fused_pallas`: ``base_index`` (a
    host integer) is the global index of sample 0, ``stream_len_global``
    the global length for close/closed semantics, ``shard_init`` =
    (hist_init (C, batch, <=H) float32, carry_init (batch,) float32,
    gate_init (batch, 2) int32 [last-above global index, cluster count])
    primes the chunk (kernel B numbers a carried gate's cluster from that
    count, so a stream step passes 1 where a gate continues into the chunk
    and 0 elsewhere); with ``emit_state`` returns ``(table, (carry_out
    (batch,), gate_out (batch, 2) [last-above, cluster count]))``."""
    with span(_DETECT_SPAN):
        _check_input(x)
        hist, carry, ginit = (None, None, None) if shard_init is None else shard_init
        base = 0 if base_index is None else host_index(base_index)
        corr, above, *carry_out = minn_rtl_metric(
            x, quarter_len=quarter_len, smooth_shift=smooth_shift,
            threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits,
            base_index=base, hist_init=hist, carry_init=carry, emit_state=emit_state)
        out = gate_events(
            above, corr, hysteresis=hysteresis, max_events=max_events,
            valid_from=max(0, 3 * quarter_len - 1), tie=tie, emit_unclosed=emit_unclosed,
            base_index=base, stream_len_global=stream_len_global, gate_init=ginit,
            emit_state=emit_state)
    if emit_state:
        table, gate_out = out
        return table, (carry_out[0], gate_out)
    return out


def minn_rtl_detect_planar_fused(
    x: torch.Tensor,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    max_events: int = 8,
) -> tuple[MinnRTLFastState, GateEvents]:
    """The counterpart of `minn_rtl_detect_planar_pallas` on the
    channel-leading layout: kernel A's full metric (#3), then kernel B on
    its above and corr_positive (tie 'last', closed events only).  Returns
    (MinnRTLFastState, GateEvents) with a leading batch axis."""
    st = minn_rtl_metric_planar_fused(
        x, quarter_len=quarter_len, smooth_shift=smooth_shift,
        threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits)
    table = gate_events(st.above_threshold, st.corr_positive, hysteresis=hysteresis,
                        max_events=max_events, valid_from=st.valid_from, tie="last",
                        emit_unclosed=False)
    return st, table


# ---------------------------------------------------------------------------
# Kernel F: one Minn-RTL stream step in one launch
# ---------------------------------------------------------------------------

def gate_continuation(gate: torch.Tensor, base: int, hysteresis: int) -> torch.Tensor:
    """The next chunk's gate_init from the last one's gate_out (batch, 2):
    the gate continues iff the gap from its last above sample to the chunk
    seam is within the hysteresis (JAX `streaming_chunked.py:395-399`);
    then [la, 1], else [-1, 0]."""
    h = max(int(hysteresis), 1)
    la = gate[:, 0]
    flag = ((la >= 0) & (base - la <= h)).to(torch.int32)
    return torch.stack([torch.where(flag > 0, la, -1), flag], dim=1)


def new_history(hist: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """The last H samples of [hist | chunk], in the history's dtype."""
    H = hist.shape[-1]
    chunk = chunk.to(hist.dtype)
    if chunk.shape[-1] >= H:
        return chunk[..., chunk.shape[-1] - H:].contiguous()
    return torch.cat([hist, chunk], dim=-1)[..., -H:].contiguous()


def minn_rtl_step_plain(chunk, hist, carry, gate, *, base_index, quarter_len: int,
                        smooth_shift: int, threshold_value: int, threshold_frac_bits: int,
                        hysteresis: int, max_events: int = 8, tie: str = "last",
                        stream_len_global: int):
    """Kernel F's function as a composition: the gate rule
    (`gate_continuation`), `minn_rtl_detect_fused` primed with the state
    (``emit_unclosed``, ``emit_state``) and the history roll (`new_history`).
    On CPU tensors every part runs its plain PyTorch version; on card
    tensors the detect launches kernels A (primed) and B (carried), the
    composed step that `bench.block_latency` times beside F."""
    base = host_index(base_index)
    table, (carry_out, gate_out) = minn_rtl_detect_fused(
        chunk, quarter_len=quarter_len, smooth_shift=smooth_shift,
        threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits,
        hysteresis=hysteresis, max_events=max_events, tie=tie, emit_unclosed=True,
        base_index=base, stream_len_global=stream_len_global,
        shard_init=(hist, carry, gate_continuation(gate, base, hysteresis)), emit_state=True)
    return table, carry_out, gate_out, new_history(hist, chunk)


def minn_rtl_step(chunk, hist, carry, gate, *, base_index, quarter_len: int, smooth_shift: int,
                  threshold_value: int, threshold_frac_bits: int, hysteresis: int,
                  max_events: int = 8, tie: str = "last", stream_len_global: int):
    """Kernel F.  chunk (C, batch, L) float32 or int16 codes (a view with
    unit stride along time is read in place), the state's hist (C, batch,
    H) float32 right-aligned, carry (batch,) float32 and gate (batch, 2)
    int32 [last-above global index, cluster count]; ``base_index`` (a host
    integer) the global index of sample 0, ``stream_len_global`` the close
    horizon.  Returns (table `GateEvents` (batch, max_events) with global
    indices, every gate that exists valid; carry_out (batch,); gate_out
    (batch, 2); the new history (C, batch, H) float32)."""
    with span(_F_SPANS.call):
        # prep on the card path only (a CPU tensor runs the plain version)
        with span(_F_SPANS.prep) if chunk.is_cuda else NO_SPAN:
            _check_input(chunk)
            C, batch, L = chunk.shape
            if tuple(hist.shape[:-1]) != (C, batch) or hist.dim() != 3:
                raise ValueError(f"hist must be ({C}, {batch}, H), got {tuple(hist.shape)}")
            if tuple(carry.shape) != (batch,) or tuple(gate.shape) != (batch, 2):
                raise ValueError(f"carry must be ({batch},) and gate ({batch}, 2), got "
                                 f"{tuple(carry.shape)} and {tuple(gate.shape)}")
            if tie not in ("first", "last"):
                raise ValueError("tie must be 'first' or 'last'")
            if not 1 <= max_events <= MAX_EVENTS:
                raise ValueError(f"max_events must be in [1, {MAX_EVENTS}]")
            kw = dict(base_index=base_index, quarter_len=quarter_len,
                      smooth_shift=smooth_shift, threshold_value=threshold_value,
                      threshold_frac_bits=threshold_frac_bits, hysteresis=hysteresis,
                      max_events=max_events, tie=tie, stream_len_global=stream_len_global)
            if check_kernel_device(chunk, hist, carry, gate) == "cpu":
                return minn_rtl_step_plain(chunk, hist, carry, gate, **kw)
            if (hist.dtype, carry.dtype, gate.dtype) != (torch.float32, torch.float32,
                                                         torch.int32):
                raise TypeError("kernel F takes a float32 hist and carry and an int32 gate")
            if not (hist.is_contiguous() and carry.is_contiguous() and gate.is_contiguous()):
                raise ValueError("kernel F needs a contiguous hist, carry and gate")
            if L > 1 and chunk.stride(-1) != 1:
                raise ValueError(f"kernel F reads a chunk with unit stride along time, got "
                                 f"strides {chunk.stride()}")
            if C > 8:
                raise ValueError(f"kernel F takes at most 4 branches, got {C // 2}")
            Q = quarter_len
            ring = lambda n: -(-n // 4) * 4  # noqa: E731
            smem = 4 * (C * (ring(Q) + _A_TILE) + 2 * (ring(3 * Q) + _A_TILE))
            if smem > _SMEM_LIMIT:
                raise ValueError(f"quarter_len {Q} needs {smem} B of shared memory")
            base = host_index(base_index)
            check_index_range(base, L)
            Lg = int(stream_len_global)
            if not 0 <= Lg < 2**31:
                raise ValueError(f"stream_len_global {Lg} leaves the int32 index range")
            H, E, dev = hist.shape[-1], max_events, chunk.device
            with span(_F_SPANS.alloc):
                o = _carve(dev, [("start", torch.int32, (batch, E)),
                                 ("close", torch.int32, (batch, E)),
                                 ("pidx", torch.int32, (batch, E)),
                                 ("pval", torch.float32, (batch, E)),
                                 ("count", torch.int32, (batch,)),
                                 ("valid", torch.bool, (batch, E)),
                                 ("closed", torch.bool, (batch, E)),
                                 ("overflow", torch.bool, (batch,)),
                                 ("carry_out", torch.float32, (batch,)),
                                 ("gate_out", torch.int32, (batch, 2)),
                                 ("hist", torch.float32, (C, batch, H))])
            alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0
        with span(_F_SPANS.launch):
            if batch:
                err = build.library().minn_rtl_step(
                    int(chunk.dtype == torch.int16), chunk.data_ptr(), chunk.stride(0),
                    chunk.stride(1), hist.data_ptr(), H, carry.data_ptr(), gate.data_ptr(), C,
                    batch, L, Q, base, alpha, max(0, 3 * Q - 1), float(1 << threshold_frac_bits),
                    float(threshold_value), max(int(hysteresis), 1), E, int(tie == "last"), Lg,
                    *(o[f].data_ptr() for f in ("valid", "closed", "start", "close", "pidx",
                                                "pval", "count", "overflow", "carry_out",
                                                "gate_out", "hist")),
                    _stream(chunk))
                build.check(err, "minn_rtl_step")
                _count(minn_rtl_step, *(("int16",) if chunk.dtype == torch.int16 else ()))
        table = GateEvents(
            valid=o["valid"], closed=o["closed"], gate_start=o["start"], gate_close=o["close"],
            peak_idx=o["pidx"], peak_value=o["pval"], count=o["count"], overflow=o["overflow"])
        return table, o["carry_out"], o["gate_out"], o["hist"]


minn_rtl_step.launches = 0
minn_rtl_step.modes = collections.Counter()
