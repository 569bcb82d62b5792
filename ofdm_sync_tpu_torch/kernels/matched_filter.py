"""The matched filter: full linear convolution of planar complex streams.

Port of the TPU kernel `ofdm_sync_tpu/kernels/pallas_mf.py:_mf_kernel`
(`matched_filter_mxu`, #10), which feeds the from-IQ ZC detector.  On the
H100 it is kernel E (`csrc/matched_filter.cu`): the overlap-save blocking
of the TPU kernel kept in the time domain (one CTA per tile of 2048
outputs reading the T - 1 input samples before it), each tile computed in
direct form with float32 FMAs.  The plain version is the FFT convolution
`ops.channel.fft_convolve_full` in complex64.

On a CUDA tensor `matched_filter_ols` launches kernel E and counts the
launch in ``.launches`` (see `kernels.launches`); on a CPU tensor it runs
the plain version; any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import check_kernel_device
from ofdm_sync_tpu_torch.kernels import build
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import _I32_LIMIT, _stream
from ofdm_sync_tpu_torch.ops.channel import fft_convolve_full

#: the longest template kernel E takes (the TPU kernel's limit; the PSS
#: template is 2048 taps)
MAX_TAPS = 2049
#: kernel E's grid runs (branch, stream) pairs along gridDim.y
_MAX_STREAMS = 65535


def planar_taps(taps, device) -> torch.Tensor:
    """Complex (T,) taps or planar (2, T) [re; im] taps (NumPy or tensor)
    -> planar float32 (2, T) on ``device``."""
    t = torch.as_tensor(np.asarray(taps) if not isinstance(taps, torch.Tensor) else taps,
                        device=device)
    if t.is_complex():
        t = torch.stack([t.real, t.imag])
    if t.dim() != 2 or t.shape[0] != 2:
        raise ValueError(f"expected taps (T,) or planar (2, T), got {tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def matched_filter_plain(x: torch.Tensor, taps: torch.Tensor, out_len: int) -> torch.Tensor:
    """Kernel E's plain version: complex64 FFT convolution of the plane
    pairs of x (C, batch, L) with planar taps (2, T) -> (C, batch, out_len)
    float32, zero past L + T - 1."""
    xc = torch.complex(x[0::2], x[1::2])
    tc = torch.complex(taps[0], taps[1])
    y = fft_convolve_full(xc, tc)
    y = torch.nn.functional.pad(y, (0, max(out_len - y.shape[-1], 0)))[..., :out_len]
    return torch.stack([y.real, y.imag], dim=1).reshape((x.shape[0],) + y.shape[1:])


def matched_filter_ols(x: torch.Tensor, taps, out_len: int | None = None) -> torch.Tensor:
    """Full linear convolution of planar complex streams with ``taps``.

    x: (C, batch, L) float32, C even: (re, im) plane pairs, e.g. the
    [b0_re, b0_im, b1_re, b1_im] rows of the from-IQ pipeline.  taps: at
    most `MAX_TAPS` complex taps, or planar (2, T) float32 (for a matched
    filter, the conjugate-reversed template).  Returns (C, batch, Lc)
    float32 planes, Lc = L + T - 1 or ``out_len`` (zero past L + T - 1),
    history before sample 0 zero."""
    if x.dim() != 3 or x.shape[0] % 2 or x.dtype != torch.float32:
        raise ValueError(f"expected float32 (re, im) plane pairs (C, batch, L), got "
                         f"{tuple(x.shape)} {x.dtype}")
    h = planar_taps(taps, x.device)
    C, batch, L = x.shape
    T = h.shape[-1]
    if not 1 <= T <= MAX_TAPS:
        raise ValueError(f"matched_filter_ols takes 1 to {MAX_TAPS} taps (got {T})")
    Lc = L + T - 1 if out_len is None else int(out_len)
    if check_kernel_device(x, h) == "cpu":
        return matched_filter_plain(x, h, Lc)
    if not x.is_contiguous():
        raise ValueError("kernel E needs a contiguous input")
    if max(L, Lc) >= _I32_LIMIT or C // 2 * batch > _MAX_STREAMS:
        raise ValueError(f"kernel E takes < 2^31 samples and <= {_MAX_STREAMS} complex streams")
    out = torch.empty((C, batch, Lc), dtype=torch.float32, device=x.device)
    if out.numel():
        err = build.library().matched_filter_f32(x.data_ptr(), h.data_ptr(), C, batch, L, T, Lc,
                                                 out.data_ptr(), _stream(x))
        build.check(err, "matched_filter_ols")
        matched_filter_ols.launches += 1
    return out


matched_filter_ols.launches = 0
