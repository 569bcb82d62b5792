"""Fused [A][A] detection: IQ in, event table with P and M at each peak out.

Port of the TPU kernels `ofdm_sync_tpu/kernels/pallas_aa.py:_aa_metric_kernel`
(`aa_metric_planar_pallas`, #5) and `pallas_aa.py:_aa_kernel`
(`aa_detect_fused_pallas`, #6).  On the H100 the work is two CUDA kernels:

* kernel C, `aa_metric` (`csrc/aa_metric.cu`): the lag-L correlation P and
  window power R, branch-combined.  Each CTA walks a span of consecutive
  tiles of one stream in order, keeping the last 2L + 1024 samples of every
  plane in a shared ring and the three window sums as running float64
  values; a span primes once from its 2L-sample left halo (the metric has
  no IIR), or at the stream's head from the history.  Metric mode returns
  (P_re, P_im, R); detect mode returns P_re, P_im, M, the tracked |P|^2 and
  the gate input ``above``;
* kernel B, `gate_events` (`csrc/gate_events.cu`), shared with the
  Minn-RTL detector, in its capture mode: the event table plus (P_re,
  P_im, M) read at each slot's peak.

Both take the carried state of a stream's chunk (`pallas_aa.py:_aa_kernel`
with base_index / stream_len_global / shard_init / emit_state): kernel C
reads the IQ history before sample 0 and compares global indices (the
metric has no IIR, so the history alone primes it), kernel B takes the gate
carry in and gives it out.

`sc_metric_planar` and `minn_metric_planar` are the thin re-indexings of
`pallas_aa.py:144-218`: the Schmidl-Cox and standard-Minn metrics are AA
windows at other taps.

Each wrapper takes the channel-leading layout (2*branches, batch, L), rows
[b0_i, b0_q, b1_i, b1_q, ...].  On a CUDA tensor it launches its kernel
(counting the launch in ``.launches``, see `kernels.launches`); on a CPU
tensor it runs the plain PyTorch version (`kernels.streaming.
aa_metric_planar` / `aa_detect_step`, `ops.detect.
extract_gate_events_capture`); any other device raises.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from ofdm_sync_tpu_torch.device import check_kernel_device
from ofdm_sync_tpu_torch.kernels import build
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import (
    _check_input,
    _count,
    _history,
    _planar_view,
    _ptr,
    _stream,
    check_index_range,
    gate_events_capture,
    host_index,
)
from ofdm_sync_tpu_torch.kernels.streaming import aa_detect_step, aa_metric_planar as _plain
from ofdm_sync_tpu_torch.ops.detect import GateEvents


class AAMetricRows(NamedTuple):
    """Kernel C's outputs, each (batch, L); the fields a mode does not
    produce are None (metric mode: M, track, above; detect mode: R)."""

    P_re: torch.Tensor
    P_im: torch.Tensor
    R: torch.Tensor | None
    M: torch.Tensor | None
    track: torch.Tensor | None
    above: torch.Tensor | None


def aa_metric(x: torch.Tensor, *, half_len: int, threshold: float | None = None,
              base_index=0, hist_init: torch.Tensor | None = None) -> AAMetricRows:
    """Kernel C.  x: (C, batch, L) float32 or int16.  ``threshold`` None:
    metric mode (P_re, P_im, R); a float: detect mode (P_re, P_im, M, track,
    above) with ``above = n >= L & M >= float32(threshold)``.  Primed:
    ``base_index`` (a host integer) is the global index of sample 0 (valid
    from ``base + n >= L``), ``hist_init`` (C, batch, <=H) float32 the
    samples before it, right-aligned."""
    _check_input(x)
    C, batch, L = x.shape
    lag = half_len
    if lag < 1:
        raise ValueError("half_len must be positive")
    base = host_index(base_index)
    hist = _history(hist_init, (C, batch), "hist_init")
    if check_kernel_device(x, *(() if hist is None else (hist,))) == "cpu":
        st = _plain(_planar_view(x), lag, base_index=base,
                    hist=None if hist is None else _planar_view(hist))
        if threshold is None:
            return AAMetricRows(st.P_re, st.P_im, st.R, None, None, None)
        track, M, above = aa_detect_step(st.P_re, st.P_im, st.R, lag, threshold, base)
        return AAMetricRows(st.P_re, st.P_im, None, M, track, above)
    if not x.is_contiguous():
        raise ValueError("kernel C needs a contiguous input")
    check_index_range(base, L)
    new = lambda dt: torch.empty((batch, L), dtype=dt, device=x.device)  # noqa: E731
    detect = threshold is not None
    p_re, p_im = new(torch.float32), new(torch.float32)
    r = None if detect else new(torch.float32)
    m, track, above = ((new(torch.float32), new(torch.float32), new(torch.uint8))
                       if detect else (None, None, None))
    if batch and L:
        err = build.library().aa_metric(
            int(x.dtype == torch.int16), x.data_ptr(), _ptr(hist), C, batch, L, lag,
            0 if hist is None else hist.shape[-1], base, 1e-6 * lag,
            threshold if detect else 0.0, _ptr(p_re), _ptr(p_im), _ptr(r), _ptr(track),
            _ptr(m), _ptr(above), _stream(x))
        build.check(err, "aa_metric")
        _count(aa_metric, *(("primed",) if hist is not None or base != 0 else ()))
    return AAMetricRows(p_re, p_im, r, m, track,
                        None if above is None else above.view(torch.bool))


aa_metric.launches = 0
aa_metric.modes = collections.Counter()


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

    Carried state, as `aa_detect_fused_pallas`: ``base_index`` (a host
    integer), ``stream_len_global``, ``shard_init`` = (hist_init (C, batch,
    <=H) float32, gate_init (batch, 2) int32 [last-above, open-gate
    flag]); with ``emit_state`` a fourth value, gate_out (batch, 2)
    [last-above, cluster count]."""
    hist, ginit = (None, None) if shard_init is None else shard_init
    base = 0 if base_index is None else host_index(base_index)
    o = aa_metric(x, half_len=half_len, threshold=threshold, base_index=base, hist_init=hist)
    table, cap, *gate_out = gate_events_capture(
        o.above, o.track, (o.P_re, o.P_im, o.M), hysteresis=hysteresis,
        max_events=max_events, valid_from=0, tie=tie, emit_unclosed=emit_unclosed,
        base_index=base, stream_len_global=stream_len_global, gate_init=ginit,
        emit_state=emit_state)
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
