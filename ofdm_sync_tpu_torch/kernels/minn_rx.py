"""The batched Minn-RTL receive's two CUDA kernels, around its one FFT
(`pipelines.fused_rx.receive_minn_rtl_frames` on a card).

* `minn_rx_front` (kernel G, `csrc/minn_rx_front.cu`): each slot of a
  batch's event tables -> its frame's start and valid flag, the CP CFO over
  the pilot's CP, and the pilot and data symbols turned back by that CFO on
  the frame's local index and averaged over the branches, complex64
  ``(batch, K, 2, N)``, read in place from the codes;
* then ``torch.fft.fft`` over the last axis;
* `minn_rx_back` (kernel H, `csrc/minn_rx_back.cu`): the used bins of those
  spectra -> the LS estimate on the pilot, the equalized data aligned by
  its LS gain, the gain and the EVM of each slot.

Both run on a card only.  Their plain version is the receive's plain body
(`pipelines.fused_rx.receive_minn_rtl_frames_plain`), which a CPU tensor
takes there; these wrappers raise for one.  Both take any numerology that
`params.SystemParams` admits, and codes of any strides.  Every check
raises before a launch.  Each launch counts in ``.launches`` and in
``.modes``: ``int16`` or ``float32``, the type of the codes the slots
were read from.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from ofdm_sync_tpu_torch.device import check_kernel_device
from ofdm_sync_tpu_torch.kernels import build
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import _count, _stream
from ofdm_sync_tpu_torch.ops.detect import GateEvents
from ofdm_sync_tpu_torch.utils.profiling import NO_SPAN, span, wrapper_spans

#: the launch mode, by the type of the codes
_MODES = {torch.int16: "int16", torch.float32: "float32"}

_FRONT_SPANS = wrapper_spans("minn_rx_front")
_BACK_SPANS = wrapper_spans("minn_rx_back")


class RxFront(NamedTuple):
    """Kernel G's outputs; every field but ``comb`` is zero in a slot that
    is not valid, and ``comb`` is not written there."""

    starts: torch.Tensor  # (batch, K) int32: the frame's first sample in the stream
    valid: torch.Tensor   # (batch, K) bool
    cfo_hz: torch.Tensor  # (batch, K) float32
    comb: torch.Tensor    # (batch, K, 2, N) complex64: pilot and data, corrected and combined


def _need(t: torch.Tensor, dtype: torch.dtype, shape: tuple, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")


def _on_card(what: str, *tensors: torch.Tensor) -> None:
    """One CUDA device: the last check before a launch."""
    if check_kernel_device(*tensors) != "cuda":
        raise ValueError(f"{what} runs on a card; a CPU tensor takes the receive's plain body "
                         "(pipelines.fused_rx.receive_minn_rtl_frames_plain)")


def minn_rx_front(x: torch.Tensor, table: GateEvents, *, n_fft: int, cp_len: int,
                  pilot_cp: int, offset: int, max_frames: int,
                  sample_rate_hz: float) -> RxFront:
    """Kernel G over the first K = min(max_frames, E) slots of each row.

    x: planar channel-leading ``(2*branches, batch, L)`` int16 or float32
    codes, one to four branches, any strides (a stride along time, or runs
    beyond the shared memory, read in place); table: their event table,
    fields ``(batch, E)``.  A frame opens at ``peak_idx + offset`` clipped
    to ``[0, L - frame_len]``, frame_len = pilot_cp + 2 (n_fft + cp_len),
    with the pilot's CP at local offset ``pilot_cp``.  No slot (K = 0)
    launches nothing."""
    with span(_FRONT_SPANS.call):
        with span(_FRONT_SPANS.prep) if x.is_cuda else NO_SPAN:
            if x.dim() != 3 or x.shape[0] not in (2, 4, 6, 8):
                raise ValueError(f"expected (2*branches, batch, L) with 1 to 4 branches, got "
                                 f"{tuple(x.shape)}")
            if x.dtype not in _MODES:
                raise TypeError(f"expected int16 or float32 codes, got {x.dtype}")
            C, batch, L = x.shape
            if table.peak_idx.dim() != 2:
                raise ValueError(f"the table's fields must be (batch, E), got "
                                 f"{tuple(table.peak_idx.shape)}")
            E = table.peak_idx.shape[1]
            _need(table.peak_idx, torch.int32, (batch, E), "the table's peak_idx")
            _need(table.valid, torch.bool, (batch, E), "the table's valid")
            _need(table.count, torch.int32, (batch,), "the table's count")
            if n_fft < 1 or cp_len < 0:
                raise ValueError(f"n_fft {n_fft} must be at least 1 and cp_len {cp_len} not "
                                 "negative")
            frame_len = pilot_cp + 2 * (n_fft + cp_len)
            if pilot_cp < 0 or frame_len > L:
                raise ValueError(f"frame_len {frame_len} exceeds the stream length {L}")
            if max_frames < 0:
                raise ValueError(f"max_frames {max_frames} must not be negative")
            _on_card("minn_rx_front", x, table.peak_idx, table.valid, table.count)
            peak_idx, tvalid, count = (t.contiguous() for t in (
                table.peak_idx, table.valid, table.count))
            K = min(max_frames, E)
            with span(_FRONT_SPANS.alloc):
                dev = x.device
                out = RxFront(torch.empty((batch, K), dtype=torch.int32, device=dev),
                              torch.empty((batch, K), dtype=torch.bool, device=dev),
                              torch.empty((batch, K), dtype=torch.float32, device=dev),
                              torch.empty((batch, K, 2, n_fft), dtype=torch.complex64,
                                          device=dev))
        with span(_FRONT_SPANS.launch):
            if batch and K:
                err = build.library().minn_rx_front(
                    int(x.dtype == torch.int16), x.data_ptr(), C, batch, L, *x.stride(),
                    peak_idx.data_ptr(), tvalid.data_ptr(), count.data_ptr(),
                    E, K, n_fft, cp_len, pilot_cp, offset, float(sample_rate_hz),
                    *(t.data_ptr() for t in out), _stream(x))
                build.check(err, "minn_rx_front")
                _count(minn_rx_front, _MODES[x.dtype])
        return out


minn_rx_front.launches = 0
minn_rx_front.modes = collections.Counter()


def minn_rx_back(bins: torch.Tensor, valid: torch.Tensor, pilot_used: torch.Tensor,
                 data_used: torch.Tensor, *, num_active: int, codes_dtype: torch.dtype):
    """Kernel H: bins ``(batch, K, 2, N)`` complex64, contiguous, the
    spectra of kernel G's pilot and data symbols; valid ``(batch, K)``;
    pilot_used / data_used ``(num_active,)`` complex64, the known values of
    the used bins -> (evm_rms, evm_db ``(batch, K)`` float32, gain ``(batch,
    K)`` complex64, eq ``(batch, K, num_active)`` complex64), zero where not
    valid.  ``codes_dtype``, the codes' type, names the launch's mode."""
    with span(_BACK_SPANS.call):
        with span(_BACK_SPANS.prep) if bins.is_cuda else NO_SPAN:
            if bins.dim() != 4 or bins.shape[2] != 2:
                raise ValueError(f"expected bins (batch, K, 2, N), got {tuple(bins.shape)}")
            if bins.dtype != torch.complex64:
                raise TypeError(f"expected complex64 bins, got {bins.dtype}")
            if not bins.is_contiguous():
                raise ValueError("minn_rx_back takes contiguous bins")
            if codes_dtype not in _MODES:
                raise TypeError(f"codes_dtype must be int16 or float32, got {codes_dtype}")
            batch, K, _, N = bins.shape
            if not (0 <= num_active <= N and num_active % 2 == 0):
                raise ValueError(f"num_active {num_active} must be even, in [0, {N}]")
            _need(valid, torch.bool, (batch, K), "valid")
            _need(pilot_used, torch.complex64, (num_active,), "pilot_used")
            _need(data_used, torch.complex64, (num_active,), "data_used")
            _on_card("minn_rx_back", bins, valid, pilot_used, data_used)
            valid, pilot_used, data_used = (t.contiguous() for t in (valid, pilot_used,
                                                                     data_used))
            with span(_BACK_SPANS.alloc):
                dev = bins.device
                evm_rms = torch.empty((batch, K), dtype=torch.float32, device=dev)
                evm_db = torch.empty((batch, K), dtype=torch.float32, device=dev)
                gain = torch.empty((batch, K), dtype=torch.complex64, device=dev)
                eq = torch.empty((batch, K, num_active), dtype=torch.complex64, device=dev)
        with span(_BACK_SPANS.launch):
            slots = batch * K
            if slots:
                err = build.library().minn_rx_back(
                    bins.data_ptr(), valid.data_ptr(), pilot_used.data_ptr(),
                    data_used.data_ptr(), slots, N, num_active, eq.data_ptr(),
                    evm_rms.data_ptr(), evm_db.data_ptr(), gain.data_ptr(), _stream(bins))
                build.check(err, "minn_rx_back")
                _count(minn_rx_back, _MODES[codes_dtype])
        return evm_rms, evm_db, gain, eq


minn_rx_back.launches = 0
minn_rx_back.modes = collections.Counter()
