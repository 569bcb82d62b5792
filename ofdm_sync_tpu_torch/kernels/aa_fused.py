"""Fused [A][A] detection: IQ in, event table with P and M at each peak out.

Port of the TPU kernels `ofdm_sync_tpu/kernels/pallas_aa.py:_aa_metric_kernel`
(`aa_metric_planar_pallas`, #5) and `pallas_aa.py:_aa_kernel`
(`aa_detect_fused_pallas`, #6).  On the H100 the work is two CUDA kernels:

* kernel C, `aa_metric` (`csrc/aa_metric.cu`): the lag-L correlation P and
  window power R, branch-combined, one CTA per (time chunk, stream), each
  chunk independent given a 2L - 1 sample left halo (the metric has no
  IIR).  Metric mode returns (P_re, P_im, R); detect mode returns P_re,
  P_im, M, the tracked |P|^2 and the gate input ``above``;
* kernel B, `gate_events` (`csrc/gate_events.cu`), shared with the
  Minn-RTL detector, in its capture mode: the event table plus (P_re,
  P_im, M) read at each slot's peak.

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

from typing import NamedTuple

import torch

from ofdm_sync_tpu_torch.device import check_kernel_device
from ofdm_sync_tpu_torch.kernels import build
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import (
    _I32_LIMIT,
    _SMEM_LIMIT,
    _check_input,
    _planar_view,
    _stream,
    gate_events_capture,
)
from ofdm_sync_tpu_torch.kernels.streaming import aa_detect_step, aa_metric_planar as _plain
from ofdm_sync_tpu_torch.ops.detect import GateEvents

#: output samples per kernel-C CTA
CHUNK = 4096
#: kernel C's grid runs streams along gridDim.y
_MAX_BATCH = 65535


class AAMetricRows(NamedTuple):
    """Kernel C's outputs, each (batch, L); the fields a mode does not
    produce are None (metric mode: M, track, above; detect mode: R)."""

    P_re: torch.Tensor
    P_im: torch.Tensor
    R: torch.Tensor | None
    M: torch.Tensor | None
    track: torch.Tensor | None
    above: torch.Tensor | None


def smem_bytes(half_len: int) -> int:
    """Kernel C's dynamic shared memory: three float64 prefix arrays."""
    return 3 * (half_len + CHUNK) * 8


def aa_metric(x: torch.Tensor, *, half_len: int, threshold: float | None = None) -> AAMetricRows:
    """Kernel C.  x: (C, batch, L) float32 or int16.  ``threshold`` None:
    metric mode (P_re, P_im, R); a float: detect mode (P_re, P_im, M, track,
    above) with ``above = n >= L & M >= float32(threshold)``."""
    _check_input(x)
    C, batch, L = x.shape
    lag = half_len
    if lag < 1:
        raise ValueError("half_len must be positive")
    if check_kernel_device(x) == "cpu":
        st = _plain(_planar_view(x), lag)
        if threshold is None:
            return AAMetricRows(st.P_re, st.P_im, st.R, None, None, None)
        track, M, above = aa_detect_step(st.P_re, st.P_im, st.R, lag, threshold)
        return AAMetricRows(st.P_re, st.P_im, None, M, track, above)
    if not x.is_contiguous():
        raise ValueError("kernel C needs a contiguous input")
    if smem_bytes(lag) > _SMEM_LIMIT:
        raise ValueError(f"half_len {lag} needs {smem_bytes(lag)} B of shared memory, "
                         f"more than the {_SMEM_LIMIT} B a Hopper CTA has")
    if L >= _I32_LIMIT or batch > _MAX_BATCH:
        raise ValueError(f"kernel C takes < 2^31 samples and <= {_MAX_BATCH} streams")
    new = lambda dt: torch.empty((batch, L), dtype=dt, device=x.device)  # noqa: E731
    detect = threshold is not None
    p_re, p_im = new(torch.float32), new(torch.float32)
    r = None if detect else new(torch.float32)
    m, track, above = ((new(torch.float32), new(torch.float32), new(torch.uint8))
                       if detect else (None, None, None))
    if batch and L:
        lib = build.library()
        fn = lib.aa_metric_f32 if x.dtype == torch.float32 else lib.aa_metric_i16
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = fn(x.data_ptr(), C, batch, L, lag, CHUNK, 1e-6 * lag,
                 threshold if detect else 0.0, ptr(p_re), ptr(p_im), ptr(r), ptr(track),
                 ptr(m), ptr(above), _stream(x))
        build.check(err, "aa_metric")
        aa_metric.launches += 1
    return AAMetricRows(p_re, p_im, r, m, track,
                        None if above is None else above.view(torch.bool))


aa_metric.launches = 0


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
) -> tuple[GateEvents, torch.Tensor, torch.Tensor]:
    """#6: fused [A][A] detection on the channel-leading layout.

    Gates at ``M >= threshold`` (valid from n >= L), tracks the peak on
    ``|P|^2`` and captures (P_re, P_im, M) at each slot's peak.  Returns
    (`GateEvents` (batch, E), P_at_peak (batch, 2, E) planar float32,
    M_at_peak (batch, E)): everything a receiver needs for timing
    (peak - 2L + 1) and CFO (angle(P) fs / (2 pi L))."""
    o = aa_metric(x, half_len=half_len, threshold=threshold)
    table, cap = gate_events_capture(
        o.above, o.track, (o.P_re, o.P_im, o.M), hysteresis=hysteresis,
        max_events=max_events, valid_from=0, tie=tie, emit_unclosed=emit_unclosed)
    return table, cap[:, :2], cap[:, 2]


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
