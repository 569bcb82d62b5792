"""Fused Zadoff-Chu CFAR detection: correlation magnitude or matched-filter
output + IQ in, `GateEvents` out.

Port of the TPU kernels `ofdm_sync_tpu/kernels/pallas_zc.py:_zc_kernel`
(`zc_cfar_detect_pallas`, #7), `pallas_zc.py:_zc_iq_kernel`
(`zc_iq_cfar_detect_pallas`, #8) and `pallas_zc_tm.py:_zc_iq_tm_kernel`
(`zc_iq_cfar_detect_tm`, #9).  On the H100 the work is two CUDA kernels:

* kernel D, `zc_metric` (`csrc/zc_cfar.cu`): the CFAR gate input.  Each CTA
  walks a span of consecutive tiles of one stream in order, carrying the
  energies and the local sum as running float64 values and the last R + 1024
  branch powers and W + 1024 magnitudes in shared rings; a span primes once
  from its left halo, or at the stream's head from the history.  Magnitude
  mode reads the correlation magnitude and writes ``above``; IQ mode reads
  the planar matched-filter output and the planar IQ (float32 or int16 ADC
  codes), forms the normalized branch-summed magnitude and writes it with
  ``above``;
* kernel B, `gate_events` (`csrc/gate_events.cu`), shared with the other
  detectors, with ``valid_from = W``.

Both modes take the carried state of a stream's chunk or shard, with global
indices (``base_index``, ``stream_len_global``) and kernel B's gate carry.
Magnitude mode (`pallas_zc.py:_zc_kernel` with shard_init / emit_state):
kernel D reads the magnitude history before sample 0.  IQ mode (the shard
mode of `pallas_zc_tm.py:zc_iq_cfar_detect_tm`): kernel D pushes the left
neighbour's mf and IQ halos through its own datapath and writes kernel B's
``gate_init`` from the halo's last h CFAR decisions, on the card.

The arrays are never padded: the kernels mask the ragged edge themselves,
so no padded row or stream can wake kernel B (the trap of
`pallas_zc_tm.py:264-272`, where a zero magnitude passes ``0 >= 0 * T``).
On a CUDA tensor each wrapper launches its kernel (counting the launch in
``.launches``, see `kernels.launches`); on a CPU tensor it runs the plain
PyTorch version (`kernels.streaming.zc_cfar_planar` / `zc_iq_planar` /
`zc_iq_planar_primed`, `ops.detect.extract_gate_events`); any other device
raises.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from ofdm_sync_tpu_torch.device import check_kernel_device
from ofdm_sync_tpu_torch.kernels import build
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import (
    _A_TILE,
    _SMEM_LIMIT,
    _count,
    _history,
    _ptr,
    _stream,
    check_index_range,
    gate_events,
    host_index,
)
from ofdm_sync_tpu_torch.kernels.streaming import (
    zc_cfar_planar,
    zc_iq_planar,
    zc_iq_planar_primed,
)
from ofdm_sync_tpu_torch.ops.detect import GateEvents
from ofdm_sync_tpu_torch.utils.profiling import NO_SPAN, SPAN_PREFIX, span, wrapper_spans

#: kernel D takes 1 to 4 branches
_MAX_BRANCHES = 4
#: the spans of kernel D's wrapper (`utils.profiling.span`) and of the
#: detector from IQ
_D_SPANS = wrapper_spans("zc_metric")
_ZC_DETECT_SPAN = SPAN_PREFIX + "zc_iq_cfar_detect"


class ZCMetricRows(NamedTuple):
    """Kernel D's outputs, each (batch, L): the tracked magnitude (the
    input itself in magnitude mode) and the gate input; in primed IQ mode
    also kernel B's gate carry from the halo, gate_init (batch, 2) int32."""

    mag: torch.Tensor
    above: torch.Tensor
    gate_init: torch.Tensor | None = None


def default_threshold(corr_window: int, threshold_frac_bits: int = 15) -> int:
    """The reference's 4x-local-mean threshold as a fixed-point factor on
    the W-window local SUM (`pallas_zc.py:306-309`)."""
    return int(4.0 * (1 << threshold_frac_bits) / corr_window)


def zc_tm_halo_rows(ref_len: int, corr_window: int, hysteresis: int) -> int:
    """Samples of the left neighbour's mf and IQ that prime a shard exactly
    (`pallas_zc_tm.py:zc_tm_halo_rows`): the oldest CFAR decision of the
    gate carry sits h back, its local sum reaches W further, and the oldest
    magnitude in that sum needs ref_len - 1 samples of energy, rounded up to
    8 with 8 more."""
    h = max(int(hysteresis), 1)
    return -(-(ref_len - 1 + corr_window + h) // 8) * 8 + 8


def smem_bytes(corr_window: int, ref_len: int = 0, branches: int = 0) -> int:
    """Kernel D's dynamic shared memory: a float64 ring of the last
    round4(R) + 1024 powers of each branch and a float32 ring of the last
    round4(W) + 1024 magnitudes."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    return 8 * branches * (r4(ref_len) + _A_TILE) + 4 * (r4(corr_window) + _A_TILE)


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
    hist_init=None,
    hysteresis: int = 256,
) -> ZCMetricRows:
    """Kernel D.  Magnitude mode (``iq`` None): x is corr_mag float32
    (batch, L); primed, ``base_index`` (a host integer) is the global index
    of sample 0 (valid from ``base + n >= W``) and ``hist_init`` (batch,
    <=H) float32 the magnitudes before it, right-aligned.  IQ mode: x is
    the planar matched-filter output mf (2*BR, batch, Lc) float32 and iq the
    planar IQ (2*BR, batch, L_iq), float32 or int16, rows [b0_i, b0_q, b1_i,
    ...]; ``ref_len`` and ``ref_norm`` = ||ref||_2 are required.  Primed IQ
    mode: ``hist_init`` = (mf_halo, iq_halo), each (2*BR, batch, Hh)
    right-aligned (the trailing samples of the left neighbour's mf and IQ,
    zeros for a stream's first shard; Hh = `zc_tm_halo_rows` primes
    exactly), and the result's gate_init holds [la, la >= 0], la the largest
    global index among the halo's last max(hysteresis, 1) samples whose CFAR
    decision is true (-1: none).  Returns (mag, above[, gate_init]), each
    (batch, L or Lc)."""
    with span(_D_SPANS.call):
        # prep on the card path only (a CPU tensor runs the plain version)
        with span(_D_SPANS.prep) if x.is_cuda else NO_SPAN:
            W = corr_window
            if W < 1:
                raise ValueError("corr_window must be positive")
            T = (default_threshold(W, threshold_frac_bits) if threshold_value is None
                 else threshold_value)
            cfar = dict(corr_window=W, threshold_value=T, threshold_frac_bits=threshold_frac_bits,
                        min_corr_mag=min_corr_mag)
            base = host_index(base_index)
            hist = iq_hist = None
            if iq is None:
                if x.dim() != 2 or x.dtype != torch.float32:
                    raise ValueError(f"expected corr_mag float32 (batch, L), got "
                                     f"{tuple(x.shape)} {x.dtype}")
                hist = _history(hist_init, tuple(x.shape[:1]), "hist_init")
                tensors, branches = (x, *(() if hist is None else (hist,))), 0
            else:
                if ref_len is None or ref_norm is None or ref_len < 1:
                    raise ValueError("IQ mode needs ref_len >= 1 and ref_norm")
                if x.dim() != 3 or x.shape[0] % 2 or x.dtype != torch.float32:
                    raise ValueError(f"expected mf float32 (2*branches, batch, Lc), got "
                                     f"{tuple(x.shape)} {x.dtype}")
                if iq.dim() != 3 or iq.shape[:2] != x.shape[:2]:
                    raise ValueError(f"iq {tuple(iq.shape)} does not match mf {tuple(x.shape)}")
                if iq.dtype not in (torch.float32, torch.int16):
                    raise TypeError(f"expected float32 or int16 IQ, got {iq.dtype}")
                if hist_init is not None:
                    mf_halo, iq_halo = hist_init
                    hist = _history(mf_halo, tuple(x.shape[:2]), "mf_halo")
                    if iq_halo.shape != hist.shape:
                        raise ValueError(f"iq_halo {tuple(iq_halo.shape)} must match mf_halo "
                                         f"{tuple(hist.shape)}")
                    iq_hist = iq_halo.to(iq.dtype).contiguous()
                tensors = (x, iq, *(() if hist is None else (hist, iq_hist)))
                branches = x.shape[0] // 2
            if check_kernel_device(*tensors) == "cpu":
                if iq is None:
                    return ZCMetricRows(x, zc_cfar_planar(x, **cfar, base_index=base, hist=hist))
                if hist is None:
                    return ZCMetricRows(*zc_iq_planar(x, iq, ref_len=ref_len, ref_norm=ref_norm,
                                                      **cfar, base_index=base))
                return ZCMetricRows(*zc_iq_planar_primed(x, iq, hist, iq_hist, ref_len=ref_len,
                                                         ref_norm=ref_norm, base_index=base,
                                                         hysteresis=hysteresis, **cfar))

            if not all(t.is_contiguous() for t in tensors):
                raise ValueError("kernel D needs contiguous inputs")
            if branches > _MAX_BRANCHES:
                raise ValueError(f"kernel D takes at most {_MAX_BRANCHES} branches")
            smem = smem_bytes(W, ref_len or 0, branches)
            if smem > _SMEM_LIMIT:
                raise ValueError(f"corr_window {W} / ref_len {ref_len} need {smem} B of shared "
                                 f"memory, more than the {_SMEM_LIMIT} B a Hopper CTA has")
            batch, L = x.shape[-2:]
            check_index_range(base, L)
            primed_iq = iq is not None and hist is not None
            dev = x.device
            with span(_D_SPANS.alloc):
                above = torch.empty((batch, L), dtype=torch.uint8, device=dev)
                mag = x if iq is None else torch.empty((batch, L), dtype=torch.float32, device=dev)
                gate = torch.empty((batch, 2), dtype=torch.int32, device=dev) if primed_iq else None
            hist_len = 0 if hist is None else hist.shape[-1]
            thr = (float(1 << threshold_frac_bits), float(T), float(min_corr_mag))
        with span(_D_SPANS.launch):
            if batch and (L or primed_iq):
                lib = build.library()
                if iq is None:
                    err = lib.zc_cfar_mag_f32(x.data_ptr(), _ptr(hist), batch, L, W, hist_len,
                                              base, *thr, above.data_ptr(), _stream(x))
                else:
                    err = lib.zc_cfar_iq(int(iq.dtype == torch.int16), x.data_ptr(),
                                         iq.data_ptr(), _ptr(hist), _ptr(iq_hist), x.shape[0],
                                         batch, L, iq.shape[-1], ref_len, W, hist_len, base,
                                         max(int(hysteresis), 1), float(ref_norm), *thr,
                                         mag.data_ptr(), above.data_ptr(), _ptr(gate), _stream(x))
                build.check(err, "zc_metric")
                primed = hist is not None or base != 0
                _count(zc_metric, *(("primed_iq" if iq is not None else "primed",)
                                    if primed else ()))
        return ZCMetricRows(mag, above.view(torch.bool), gate)


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
    base_index=None,
    stream_len_global: int | None = None,
    shard_init: tuple | None = None,
) -> GateEvents:
    """#8 / #9: from-IQ ZC detection (the counterpart of
    `zc_iq_cfar_detect_pallas` and `zc_iq_cfar_detect_tm_planar`, same
    defaults).  mf: (2*BR, batch, Lc) float32 planar 'full'-convolution
    matched-filter rows, Lc = L + ref_len - 1; iq: (2*BR, batch, L) float32
    or int16 planar IQ in the same row order.  Event indices cover the
    correlation axis Lc.  CUDA: kernel D in IQ mode, then kernel B.

    Shard mode, as `zc_iq_cfar_detect_tm`: ``base_index`` (a host integer)
    is the global correlation-output position of the shard's first sample,
    ``stream_len_global`` the global length for close/validity semantics,
    ``shard_init`` = (mf_halo, iq_halo), each (2*BR, batch, <=Wh),
    right-aligned: the trailing samples of the left neighbour's mf and of
    its IQ (zero-padded to Lc), zeros for shard 0, Wh = `zc_tm_halo_rows(
    ref_len, corr_window, hysteresis)`.  Kernel D pushes the halo through
    its own datapath and primes kernel B's gate from it; indices are then
    global."""
    with span(_ZC_DETECT_SPAN):
        base = 0 if base_index is None else host_index(base_index)
        o = zc_metric(mf, iq, ref_len=ref_len, ref_norm=ref_norm, corr_window=corr_window,
                      threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits,
                      min_corr_mag=min_corr_mag, base_index=base, hist_init=shard_init,
                      hysteresis=hysteresis)
        return gate_events(o.above, o.mag, hysteresis=hysteresis, max_events=max_events,
                           valid_from=corr_window, tie=tie, emit_unclosed=emit_unclosed,
                           base_index=base, stream_len_global=stream_len_global,
                           gate_init=o.gate_init)
