"""Fused [A][A] detection: IQ in, event table with P and M at each peak out.

Port of the TPU kernels `ofdm_sync_tpu/kernels/pallas_aa.py:_aa_metric_kernel`
(`aa_metric_planar_pallas`, #5) and `pallas_aa.py:_aa_kernel`
(`aa_detect_fused_pallas`, #6).  On the H100 the work is two CUDA kernels,
and on int16 codes a third:

* kernel C, `aa_metric` (`csrc/aa_metric.cu`): the lag-L correlation P and
  window power R, branch-combined.  Each CTA walks a span of consecutive
  tiles of one stream in order, keeping the last 2L samples and more of
  every plane in a shared ring and the three window sums as running values;
  a span primes once from its 2L-sample left halo (the metric has no IIR),
  or at the stream's head from the history.  Two paths, picked from the
  input (`exact_route`): int16 codes of up to two branches without a
  history take the exact integer path (int32 increments, int64 window sums,
  mode ``exact_i16``); float32 input and every history the float path
  (float64 window sums).  Both round the same exact sums once to float32,
  so their outputs are the same bits.  Metric mode returns (P_re, P_im, R);
  detect mode returns P_re, P_im, M, the tracked |P|^2 and the gate input
  ``above``, or the last two alone (see below);
* kernel B, `gate_events` (`csrc/gate_events.cu`), shared with the
  Minn-RTL detector: the event table, in its capture mode plus (P_re,
  P_im, M) read at each slot's peak;
* the peak capture, `aa_peak_capture` (`csrc/aa_metric.cu`, kernel C's
  source, its own wrapper and counters): (P_re, P_im, M) formed again at
  each slot's peak from the codes.

`aa_detect_fused` chooses its route from the input (`gate_input_route`).
On int16 codes without a history every window sum is an exact integer, so
kernel C (on its exact path where `exact_route` allows) writes only B's
gate input (track and above, 5 B a sample instead of 17), B runs in its
plain mode, and the peak capture forms P and M at the peaks with the same
bits as kernel C's.  Everything else (float32 input, a history, a CPU
tensor) runs C's float path in full detect mode and B with capture.

Both routes take the carried state of a stream's chunk
(`pallas_aa.py:_aa_kernel` with base_index / stream_len_global / shard_init
/ emit_state): kernel C reads the IQ history before sample 0 and compares
global indices (the metric has no IIR, so the history alone primes it),
kernel B takes the gate carry in and gives it out.

`sc_metric_planar` and `minn_metric_planar` are the thin re-indexings of
`pallas_aa.py:144-218`: the Schmidl-Cox and standard-Minn metrics are AA
windows at other taps.

Each wrapper takes the channel-leading layout (2*branches, batch, L), rows
[b0_i, b0_q, b1_i, b1_q, ...].  On a CUDA tensor it launches its kernel
(counting the launch in ``.launches`` and its modes in ``.modes``, see
`kernels.launches`); on a CPU tensor
it runs the plain PyTorch version (`kernels.streaming.aa_metric_planar` /
`aa_detect_step` / `aa_peak_capture_plain`, `ops.detect.
extract_gate_events_capture`); any other device raises.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from ofdm_sync_tpu_torch.device import check_kernel_device
from ofdm_sync_tpu_torch.kernels import build
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import (
    _SMEM_LIMIT,
    _check_input,
    _count,
    _gate_events,
    _history,
    _planar_view,
    _ptr,
    _stream,
    check_index_range,
    gate_events_capture,
    host_index,
)
from ofdm_sync_tpu_torch.kernels.streaming import (
    aa_detect_step,
    aa_metric_planar as _plain,
    aa_peak_capture_plain,
)
from ofdm_sync_tpu_torch.ops.detect import GateEvents
from ofdm_sync_tpu_torch.utils.profiling import NO_SPAN, SPAN_PREFIX, span, wrapper_spans

#: the spans of kernel C's wrapper and of the peak capture's
#: (`utils.profiling.span`), and of the batch detector
_C_SPANS = wrapper_spans("aa_metric")
_CAP_SPANS = wrapper_spans("aa_peak_capture")
_DETECT_SPAN = SPAN_PREFIX + "aa_detect_fused"

#: the largest C x lag whose window sums of int16 codes kernel C carries
#: exactly (each |sum| and each difference of two below C/2 x 2 x 2 x
#: 2^30 x lag <= 2^53)
_EXACT_C_LAG = 2**21
#: samples per tile of kernel C's exact int16 path (128 threads x 8); its
#: ring holds round8(2 lag) + 3 tiles of codes a plane, beside a tile of
#: float32 store staging
_C_EXACT_TILE = 1024


class AAMetricRows(NamedTuple):
    """Kernel C's outputs, each (batch, L); the fields a mode does not
    produce are None (metric mode: M, track, above; detect mode: R; the gate
    input alone: P_re, P_im, R, M)."""

    P_re: torch.Tensor | None
    P_im: torch.Tensor | None
    R: torch.Tensor | None
    M: torch.Tensor | None
    track: torch.Tensor | None
    above: torch.Tensor | None


def gate_input_route(x: torch.Tensor, hist_init: torch.Tensor | None, half_len: int) -> bool:
    """Whether `aa_detect_fused` may take its lean route on the card: x is
    int16 codes without a history, so kernel C's window sums are exact
    integers (within `_EXACT_C_LAG`) and P and M can be formed again at the
    peaks with the same bits (`aa_peak_capture`).  Kernel C itself then
    runs its exact integer path where `exact_route` allows (up to two
    branches), its float path beyond."""
    return (x.dtype == torch.int16 and hist_init is None
            and x.shape[0] * half_len <= _EXACT_C_LAG)


def exact_route(x: torch.Tensor, hist_init: torch.Tensor | None, half_len: int) -> bool:
    """Whether kernel C takes its exact int16 path for x: int16 codes of up
    to two branches without a history, the ring of codes within a CTA's
    shared memory (lag up to 12,672 at two branches, so C x lag stays
    within `_EXACT_C_LAG` and the float path's sums are exact too).  Any
    other input takes the float path, with the same bits where both may
    run."""
    C = x.shape[0]
    ring = -(-2 * half_len // 8) * 8 + 3 * _C_EXACT_TILE
    return (x.dtype == torch.int16 and hist_init is None and C <= 4
            and 2 * C * ring + 4 * _C_EXACT_TILE <= _SMEM_LIMIT)


def aa_metric(x: torch.Tensor, *, half_len: int, threshold: float | None = None,
              base_index=0, hist_init: torch.Tensor | None = None,
              failed_tiles: torch.Tensor | None = None) -> AAMetricRows:
    """Kernel C.  x: (C, batch, L) float32 or int16.  ``threshold`` None:
    metric mode (P_re, P_im, R); a float: detect mode (P_re, P_im, M, track,
    above) with ``above = n >= L & M >= float32(threshold)``.  Primed:
    ``base_index`` (a host integer) is the global index of sample 0 (valid
    from ``base + n >= L``), ``hist_init`` (C, batch, <=H) float32 the
    samples before it, right-aligned.  On the card, int16 codes take the
    exact path where `exact_route` allows (mode ``exact_i16``);
    ``failed_tiles``, a one-element int32 tensor on x's device, gains the
    tiles that path walked on its wide route (a code out of [-2048, 2048)
    within a tile's reach); the float path and the plain version leave it as
    it is."""
    return _aa_metric(x, half_len=half_len, threshold=threshold, base_index=base_index,
                      hist_init=hist_init, failed_tiles=failed_tiles)


def _aa_metric(x, *, half_len, threshold, base_index, hist_init, gate_input=False,
               failed_tiles=None):
    """`aa_metric`; with ``gate_input`` (detect mode) only track and above
    are written (mode ``gate_input``)."""
    with span(_C_SPANS.call):
        # prep on the card path only (a CPU tensor runs the plain version)
        with span(_C_SPANS.prep) if x.is_cuda else NO_SPAN:
            _check_input(x)
            C, batch, L = x.shape
            lag = half_len
            if lag < 1:
                raise ValueError("half_len must be positive")
            base = host_index(base_index)
            hist = _history(hist_init, (C, batch), "hist_init")
            detect = threshold is not None
            if gate_input and not detect:
                raise ValueError("the gate input needs a threshold")
            if check_kernel_device(x, *(() if hist is None else (hist,))) == "cpu":
                st = _plain(_planar_view(x), lag, base_index=base,
                            hist=None if hist is None else _planar_view(hist))
                if not detect:
                    return AAMetricRows(st.P_re, st.P_im, st.R, None, None, None)
                track, M, above = aa_detect_step(st.P_re, st.P_im, st.R, lag, threshold, base)
                if gate_input:
                    return AAMetricRows(None, None, None, None, track, above)
                return AAMetricRows(st.P_re, st.P_im, None, M, track, above)
            if not x.is_contiguous():
                raise ValueError("kernel C needs a contiguous input")
            check_index_range(base, L)
            if failed_tiles is not None and (failed_tiles.dtype != torch.int32
                                             or failed_tiles.device != x.device
                                             or not failed_tiles.is_contiguous()):
                raise ValueError("failed_tiles must be a contiguous int32 tensor on x's device")
            exact = exact_route(x, hist, lag)
            new = lambda dt: torch.empty((batch, L), dtype=dt, device=x.device)  # noqa: E731
            with span(_C_SPANS.alloc):
                p_re, p_im = ((None, None) if gate_input
                              else (new(torch.float32), new(torch.float32)))
                r = None if detect else new(torch.float32)
                m = new(torch.float32) if detect and not gate_input else None
                track, above = ((new(torch.float32), new(torch.uint8)) if detect
                                else (None, None))
        with span(_C_SPANS.launch):
            if batch and L:
                err = build.library().aa_metric(
                    int(x.dtype == torch.int16), int(exact), x.data_ptr(), _ptr(hist), C,
                    batch, L, lag, 0 if hist is None else hist.shape[-1], base, 1e-6 * lag,
                    threshold if detect else 0.0, _ptr(p_re), _ptr(p_im), _ptr(r),
                    _ptr(track), _ptr(m), _ptr(above),
                    _ptr(failed_tiles), _stream(x))
                build.check(err, "aa_metric")
                _count(aa_metric, *(("detect",) if detect else ()),
                       *(("gate_input",) if gate_input else ()),
                       *(("primed",) if hist is not None or base != 0 else ()),
                       *(("exact_i16",) if exact else ()))
        return AAMetricRows(p_re, p_im, r, m, track,
                            None if above is None else above.view(torch.bool))


aa_metric.launches = 0
aa_metric.modes = collections.Counter()


def aa_peak_capture(x: torch.Tensor, peak_idx: torch.Tensor, *, half_len: int,
                    base_index=0) -> torch.Tensor:
    """The peak capture.  x: (C, batch, L) int16 codes without a history,
    ``peak_idx`` (batch, E) int32 global indices (a table's) -> (batch, 3,
    E) float32 [P_re, P_im, M] of kernel C's detect mode at each peak, zero
    where ``peak_idx - base_index`` lies outside [0, L)."""
    with span(_CAP_SPANS.call):
        with span(_CAP_SPANS.prep) if x.is_cuda else NO_SPAN:
            _check_input(x)
            C, batch, L = x.shape
            lag = half_len
            if x.dtype != torch.int16:
                raise TypeError("the peak capture reads int16 codes")
            if lag < 1 or C * lag > _EXACT_C_LAG:
                raise ValueError(f"half_len {lag} leaves the exact range at {C} planes")
            if peak_idx.dim() != 2 or peak_idx.shape[0] != batch:
                raise ValueError(f"peak_idx must be ({batch}, E), got {tuple(peak_idx.shape)}")
            base = host_index(base_index)
            E = peak_idx.shape[1]
            if check_kernel_device(x, peak_idx) == "cpu":
                return aa_peak_capture_plain(_planar_view(x), peak_idx, lag, base_index=base)
            if not x.is_contiguous():
                raise ValueError("the peak capture needs a contiguous input")
            check_index_range(base, L)
            pidx = peak_idx
            if pidx.dtype != torch.int32 or not pidx.is_contiguous():
                pidx = pidx.to(torch.int32).contiguous()
            with span(_CAP_SPANS.alloc):
                cap = torch.empty((batch, 3, E), dtype=torch.float32, device=x.device)
        with span(_CAP_SPANS.launch):
            if batch and E:
                err = build.library().aa_peak_capture(
                    x.data_ptr(), pidx.data_ptr(), C, batch, L, lag, E, base, 1e-6 * lag,
                    cap.data_ptr(), _stream(x))
                build.check(err, "aa_peak_capture")
                _count(aa_peak_capture, *(("primed",) if base != 0 else ()))
        return cap


aa_peak_capture.launches = 0
aa_peak_capture.modes = collections.Counter()


def aa_metric_planar(x: torch.Tensor, *, half_len: int):
    """#5: the full per-sample (P_re, P_im, R), each (batch, L) float32."""
    o = aa_metric(x, half_len=half_len)
    return o.P_re, o.P_im, o.R


def aa_detect_fused(
    x: torch.Tensor,
    *,
    half_len: int,
    threshold: float = 0.15,
    hysteresis: int = 128,
    max_events: int = 8,
    tie: str = "first",
    emit_unclosed: bool = True,
    base_index=None,
    stream_len_global: int | None = None,
    shard_init: tuple | None = None,
    emit_state: bool = False,
):
    """#6: fused [A][A] detection on the channel-leading layout.

    Gates at ``M >= threshold`` (valid from n >= L), tracks the peak on
    ``|P|^2`` and captures (P_re, P_im, M) at each slot's peak.  Returns
    (`GateEvents` (batch, E), P_at_peak (batch, 2, E) planar float32,
    M_at_peak (batch, E)): everything a receiver needs for timing
    (peak - 2L + 1) and CFO (angle(P) fs / (2 pi L)).

    On the card, int16 codes without a history (`gate_input_route`) run
    kernel C on the gate input alone, kernel B plain and the peak capture;
    any other input runs C in detect mode and B with capture.  Both give the
    same bits.

    Carried state, as `aa_detect_fused_pallas`: ``base_index`` (a host
    integer), ``stream_len_global``, ``shard_init`` = (hist_init (C, batch,
    <=H) float32, gate_init (batch, 2) int32 [last-above, open-gate
    flag]); with ``emit_state`` a fourth value, gate_out (batch, 2)
    [last-above, cluster count]."""
    with span(_DETECT_SPAN):
        hist, ginit = (None, None) if shard_init is None else shard_init
        base = 0 if base_index is None else host_index(base_index)
        gate = dict(hysteresis=hysteresis, max_events=max_events, valid_from=0, tie=tie,
                    emit_unclosed=emit_unclosed, base_index=base,
                    stream_len_global=stream_len_global, gate_init=ginit,
                    emit_state=emit_state)
        if x.is_cuda and gate_input_route(x, hist, half_len):
            o = _aa_metric(x, half_len=half_len, threshold=threshold, base_index=base,
                           hist_init=None, gate_input=True)
            table, _, g = _gate_events(o.above, o.track, (), **gate)
            cap = aa_peak_capture(x, table.peak_idx, half_len=half_len, base_index=base)
            gate_out = (g,) if emit_state else ()
        else:
            o = aa_metric(x, half_len=half_len, threshold=threshold, base_index=base,
                          hist_init=hist)
            table, cap, *gate_out = gate_events_capture(o.above, o.track,
                                                        (o.P_re, o.P_im, o.M), **gate)
    return (table, cap[:, :2], cap[:, 2], *gate_out)


def sc_metric_planar(x: torch.Tensor, *, n_fft: int):
    """Schmidl-Cox metric (reference sc.py:42-78) as a re-indexing of #5:
    ``P_sc(d) = conj(P_aa(d + N - 1))``, ``R_sc(d) = R_aa(d + N - 1)``.
    Returns (M, P planar (batch, 2, out), R), out = L - N + 1."""
    P_re, P_im, R = aa_metric_planar(x, half_len=n_fft // 2)
    out_len = max(P_re.shape[-1] - n_fft + 1, 0)
    sl = slice(n_fft - 1, n_fft - 1 + out_len)
    P_re, P_im, R = P_re[..., sl], -P_im[..., sl], R[..., sl]
    Rc = R.clamp_min(1e-12)
    M = (P_re * P_re + P_im * P_im) / (Rc * Rc)
    return M, torch.stack([P_re, P_im], dim=-2), R


def minn_metric_planar(x: torch.Tensor, *, n_fft: int):
    """Standard-Minn metric (reference minn.py:59-112) as a re-indexing of
    #5 at lag Q = N/4: ``P(d) = conj(P_aa(d+2Q-1) + P_aa(d+4Q-1))``,
    ``R(d) = R_aa(d+2Q-1) + R_aa(d+3Q-1) + R_aa(d+4Q-1)``.  Returns
    (M, P planar (batch, 2, out), R), out = L - N + 1."""
    Q = n_fft // 4
    P_re, P_im, R_aa = aa_metric_planar(x, half_len=Q)
    out_len = max(P_re.shape[-1] - n_fft + 1, 0)

    def tap(a, off):
        return a[..., off - 1: off - 1 + out_len]

    Pr = tap(P_re, 2 * Q) + tap(P_re, 4 * Q)
    Pi = -(tap(P_im, 2 * Q) + tap(P_im, 4 * Q))
    R = tap(R_aa, 2 * Q) + tap(R_aa, 3 * Q) + tap(R_aa, 4 * Q)
    aligned = Pr.clamp_min(0.0)
    Rc = R.clamp_min(1e-12)
    return aligned * aligned / (Rc * Rc), torch.stack([Pr, Pi], dim=-2), R
