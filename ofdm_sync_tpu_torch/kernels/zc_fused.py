"""Fused Zadoff-Chu CFAR detection: correlation magnitude or matched-filter
output + IQ in, `GateEvents` out.

Port of the TPU kernels `ofdm_sync_tpu/kernels/pallas_zc.py:_zc_kernel`
(`zc_cfar_detect_pallas`, #7), `pallas_zc.py:_zc_iq_kernel`
(`zc_iq_cfar_detect_pallas`, #8) and `pallas_zc_tm.py:_zc_iq_tm_kernel`
(`zc_iq_cfar_detect_tm`, #9).  On the H100 the work is two CUDA kernels:

* kernel D, `zc_metric` (`csrc/zc_cfar.cu`): the CFAR gate input, one CTA
  per (chunk of 16384 outputs, stream), each chunk independent given a
  left halo.  Magnitude mode reads the correlation magnitude and writes
  ``above``; IQ mode reads the planar matched-filter output and the planar
  IQ (float32 or int16 ADC codes), forms the normalized branch-summed
  magnitude and writes it with ``above``;
* kernel B, `gate_events` (`csrc/gate_events.cu`), shared with the other
  detectors, with ``valid_from = W``.

The magnitude mode takes the carried state of a stream's chunk
(`pallas_zc.py:_zc_kernel` with base_index / stream_len_global /
shard_init / emit_state): kernel D reads the magnitude history before
sample 0 and compares global indices, kernel B takes the gate carry in and
gives it out.

The arrays are never padded: the kernels mask the ragged edge themselves,
so no padded row or stream can wake kernel B (the trap of
`pallas_zc_tm.py:264-272`, where a zero magnitude passes ``0 >= 0 * T``).
On a CUDA tensor each wrapper launches its kernel (counting the launch in
``.launches``, see `kernels.launches`); on a CPU tensor it runs the plain
PyTorch version (`kernels.streaming.zc_cfar_planar` / `zc_iq_planar`,
`ops.detect.extract_gate_events`); any other device raises.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from ofdm_sync_tpu_torch.device import check_kernel_device
from ofdm_sync_tpu_torch.kernels import build
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import (
    _SMEM_LIMIT,
    _count,
    _history,
    _ptr,
    _stream,
    check_index_range,
    gate_events,
    host_index,
)
from ofdm_sync_tpu_torch.kernels.streaming import zc_cfar_planar, zc_iq_planar
from ofdm_sync_tpu_torch.ops.detect import GateEvents

#: output samples per kernel-D CTA: the IQ-mode halo of R - 1 + W - 1 =
#: 4094 samples costs 25% extra reads here, 100% at 4096
CHUNK = 16384
#: kernel D's threads per CTA, the tile of its prefix-sum rings
_THREADS = 512
#: kernel D's grid runs streams along gridDim.y; it takes 1 to 4 branches
_MAX_BATCH = 65535
_MAX_BRANCHES = 4


class ZCMetricRows(NamedTuple):
    """Kernel D's outputs, each (batch, L): the tracked magnitude (the
    input itself in magnitude mode) and the gate input."""

    mag: torch.Tensor
    above: torch.Tensor


def default_threshold(corr_window: int, threshold_frac_bits: int = 15) -> int:
    """The reference's 4x-local-mean threshold as a fixed-point factor on
    the W-window local SUM (`pallas_zc.py:306-309`)."""
    return int(4.0 * (1 << threshold_frac_bits) / corr_window)


def _ring_len(n: int) -> int:
    """Length of one of kernel D's prefix rings: a power of two >= n + 512
    (`csrc/zc_cfar.cu:ring_len`)."""
    return 1 << (n + _THREADS - 1).bit_length()


def smem_bytes(corr_window: int, ref_len: int = 0, branches: int = 0) -> int:
    """Kernel D's dynamic shared memory: float64 rings of the magnitude
    prefix and of each branch's energy prefix."""
    return 8 * (_ring_len(corr_window) + branches * _ring_len(ref_len))


def zc_metric(
    x: torch.Tensor,
    iq: torch.Tensor | None = None,
    *,
    ref_len: int | None = None,
    ref_norm: float | None = None,
    corr_window: int = 2048,
    threshold_value: int | None = None,
    threshold_frac_bits: int = 15,
    min_corr_mag: float = 0.3,
    base_index=0,
    hist_init: torch.Tensor | None = None,
) -> ZCMetricRows:
    """Kernel D.  Magnitude mode (``iq`` None): x is corr_mag float32
    (batch, L); primed, ``base_index`` (a host integer) is the global index
    of sample 0 (valid from ``base + n >= W``) and ``hist_init`` (batch,
    <=H) float32 the magnitudes before it, right-aligned.  IQ mode: x is
    the planar matched-filter output mf (2*BR, batch, Lc) float32 and iq the
    planar IQ (2*BR, batch, L_iq), float32 or int16, rows [b0_i, b0_q, b1_i,
    ...]; ``ref_len`` and ``ref_norm`` = ||ref||_2 are required.  Returns
    (mag, above), each (batch, L or Lc)."""
    W = corr_window
    if W < 1:
        raise ValueError("corr_window must be positive")
    T = default_threshold(W, threshold_frac_bits) if threshold_value is None else threshold_value
    cfar = dict(corr_window=W, threshold_value=T, threshold_frac_bits=threshold_frac_bits,
                min_corr_mag=min_corr_mag)
    base = host_index(base_index)
    hist = None
    if iq is None:
        if x.dim() != 2 or x.dtype != torch.float32:
            raise ValueError(f"expected corr_mag float32 (batch, L), got {tuple(x.shape)} "
                             f"{x.dtype}")
        hist = _history(hist_init, tuple(x.shape[:1]), "hist_init")
        tensors, branches = (x, *(() if hist is None else (hist,))), 0
    else:
        if base or hist_init is not None:
            raise ValueError("kernel D takes a carried state in magnitude mode only")
        if ref_len is None or ref_norm is None or ref_len < 1:
            raise ValueError("IQ mode needs ref_len >= 1 and ref_norm")
        if x.dim() != 3 or x.shape[0] % 2 or x.dtype != torch.float32:
            raise ValueError(f"expected mf float32 (2*branches, batch, Lc), got "
                             f"{tuple(x.shape)} {x.dtype}")
        if iq.dim() != 3 or iq.shape[:2] != x.shape[:2]:
            raise ValueError(f"iq {tuple(iq.shape)} does not match mf {tuple(x.shape)}")
        if iq.dtype not in (torch.float32, torch.int16):
            raise TypeError(f"expected float32 or int16 IQ, got {iq.dtype}")
        tensors, branches = (x, iq), x.shape[0] // 2
    if check_kernel_device(*tensors) == "cpu":
        if iq is None:
            return ZCMetricRows(x, zc_cfar_planar(x, **cfar, base_index=base, hist=hist))
        return ZCMetricRows(*zc_iq_planar(x, iq, ref_len=ref_len, ref_norm=ref_norm, **cfar))

    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel D needs contiguous inputs")
    smem = smem_bytes(W, ref_len or 0, branches)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"corr_window {W} / ref_len {ref_len} need {smem} B of shared memory, "
                         f"more than the {_SMEM_LIMIT} B a Hopper CTA has")
    if branches > _MAX_BRANCHES:
        raise ValueError(f"kernel D takes at most {_MAX_BRANCHES} branches")
    batch, L = x.shape[-2:]
    if batch > _MAX_BATCH:
        raise ValueError(f"kernel D takes <= {_MAX_BATCH} streams")
    check_index_range(base, L)
    above = torch.empty((batch, L), dtype=torch.uint8, device=x.device)
    mag = x if iq is None else torch.empty((batch, L), dtype=torch.float32, device=x.device)
    if batch and L:
        lib = build.library()
        args = (CHUNK, W) if iq is None else (CHUNK, ref_len, W, float(ref_norm))
        thr = (float(1 << threshold_frac_bits), float(T), float(min_corr_mag))
        if iq is None:
            err = lib.zc_cfar_mag_f32(x.data_ptr(), _ptr(hist), batch, L, *args,
                                      0 if hist is None else hist.shape[-1], base, *thr,
                                      above.data_ptr(), _stream(x))
        else:
            fn = lib.zc_cfar_iq_f32 if iq.dtype == torch.float32 else lib.zc_cfar_iq_i16
            err = fn(x.data_ptr(), iq.data_ptr(), x.shape[0], batch, L, iq.shape[-1], *args,
                     *thr, mag.data_ptr(), above.data_ptr(), _stream(x))
        build.check(err, "zc_metric")
        _count(zc_metric, *(("primed",) if hist is not None or base != 0 else ()))
    return ZCMetricRows(mag, above.view(torch.bool))


zc_metric.launches = 0
zc_metric.modes = collections.Counter()


def zc_cfar_detect(
    corr_mag: torch.Tensor,
    *,
    corr_window: int = 2048,
    threshold_value: int | None = None,
    threshold_frac_bits: int = 15,
    min_corr_mag: float = 0.3,
    hysteresis: int = 256,
    max_events: int = 16,
    tie: str = "first",
    emit_unclosed: bool = True,
    base_index=None,
    stream_len_global: int | None = None,
    shard_init: tuple | None = None,
    emit_state: bool = False,
):
    """#7: CFAR threshold + gate/peak events over matched-filter magnitudes
    (the counterpart of `zc_cfar_detect_pallas`, same defaults).  corr_mag:
    float32 (batch, L) or (L,); the table is (batch, max_events) or
    (max_events,).  CUDA: kernel D in magnitude mode, then kernel B.

    Carried state, as `zc_cfar_detect_pallas` (batched input): ``base_index``
    (a host integer), ``stream_len_global``, ``shard_init`` = (hist_init
    (batch, <=H) float32 trailing magnitudes, gate_init (batch, 2) int32
    [last-above, open-gate flag]); with ``emit_state`` returns (table,
    gate_out (batch, 2) [last-above, cluster count])."""
    squeeze = corr_mag.dim() == 1
    if squeeze and (shard_init is not None or emit_state):
        raise ValueError("the carried-state mode takes batched (batch, L) magnitudes")
    x = corr_mag.unsqueeze(0) if squeeze else corr_mag
    hist, ginit = (None, None) if shard_init is None else shard_init
    base = 0 if base_index is None else host_index(base_index)
    o = zc_metric(x, corr_window=corr_window, threshold_value=threshold_value,
                  threshold_frac_bits=threshold_frac_bits, min_corr_mag=min_corr_mag,
                  base_index=base, hist_init=hist)
    out = gate_events(o.above, o.mag, hysteresis=hysteresis, max_events=max_events,
                      valid_from=corr_window, tie=tie, emit_unclosed=emit_unclosed,
                      base_index=base, stream_len_global=stream_len_global, gate_init=ginit,
                      emit_state=emit_state)
    return out.select(0) if squeeze else out


def zc_iq_cfar_detect(
    mf: torch.Tensor,
    iq: torch.Tensor,
    *,
    ref_len: int,
    ref_norm: float,
    corr_window: int = 2048,
    threshold_value: int | None = None,
    threshold_frac_bits: int = 15,
    min_corr_mag: float = 0.3,
    hysteresis: int = 256,
    max_events: int = 16,
    tie: str = "first",
    emit_unclosed: bool = True,
) -> GateEvents:
    """#8 / #9: from-IQ ZC detection (the counterpart of
    `zc_iq_cfar_detect_pallas` and `zc_iq_cfar_detect_tm_planar`, same
    defaults).  mf: (2*BR, batch, Lc) float32 planar 'full'-convolution
    matched-filter rows, Lc = L + ref_len - 1; iq: (2*BR, batch, L) float32
    or int16 planar IQ in the same row order.  Event indices cover the
    correlation axis Lc.  CUDA: kernel D in IQ mode, then kernel B."""
    o = zc_metric(mf, iq, ref_len=ref_len, ref_norm=ref_norm, corr_window=corr_window,
                  threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits,
                  min_corr_mag=min_corr_mag)
    return gate_events(o.above, o.mag, hysteresis=hysteresis, max_events=max_events,
                       valid_from=corr_window, tie=tie, emit_unclosed=emit_unclosed)
