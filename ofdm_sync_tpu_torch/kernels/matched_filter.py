"""The matched filter: full linear convolution of planar complex streams.

Port of the TPU kernel `ofdm_sync_tpu/kernels/pallas_mf.py:_mf_kernel`
(`matched_filter_mxu`, #10), which feeds the from-IQ ZC detector.  On the
H100 it is kernel E (`csrc/matched_filter.cu`): overlap-save with a fixed
2048-sample discard, each `FFT_SIZE`-point block read once from HBM,
transformed by a radix-16 FFT in shared memory and registers (float32),
multiplied by the taps spectrum and transformed back in the same CTA, its
valid outputs written once.  The taps spectrum and the twiddle table are
made here, in float64, as the TPU wrapper makes its ``Hf`` outside its
``pallas_call``.  The plain version is the monolithic FFT convolution
`ops.channel.fft_convolve_full` in complex64.

On a CUDA tensor `matched_filter_ols` launches kernel E and counts the
launch in ``.launches`` (see `kernels.launches`); on a CPU tensor it runs
the plain version; any other device raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import check_kernel_device
from ofdm_sync_tpu_torch.kernels import build
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import _I32_LIMIT, _stream
from ofdm_sync_tpu_torch.ops.channel import fft_convolve_full
from ofdm_sync_tpu_torch.utils.profiling import NO_SPAN, span, wrapper_spans

#: kernel E's overlap: block k of a stream reads samples [kV - DISCARD,
#: kV + V) and writes outputs [kV, kV + V), V = FFT_SIZE - DISCARD
DISCARD = 2048
#: the longest template kernel E takes (the TPU kernel's limit; the PSS
#: template is 2048 taps)
MAX_TAPS = DISCARD + 1
#: kernel E's block transform size: 512 threads of 16 points, one CTA a SM
#: (16384 would need 1024 threads of at most 64 registers, and spills)
FFT_SIZE = 8192
#: the TPU kernel's matmul precisions (`pallas_mf.py:276-280`)
PRECISIONS = ("highest", "bf16x3", "default")
#: the spans of kernel E's wrapper, also an entry point (`utils.profiling.span`)
_E_SPANS = wrapper_spans("matched_filter_ols")
#: taps spectra kept on their devices, most recent first: (host taps,
#: device, spectrum)
_SPECTRA: list = []
_SPECTRA_KEEP = 8


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


@functools.lru_cache(maxsize=None)
def spectrum_order() -> np.ndarray:
    """The spectral index kernel E's forward passes leave in register slot k
    of thread t, at ``k * F/16 + t``: the passes consume the index digits of
    weight F/16, 32, 2 (radix 16) and 1 (radix 2, across lanes) and leave
    them reversed, k = d0 + 16 d1 + 256 d2 + 4096 d3, with thread
    t = d3 + 2 (d1 + 16 d0) and slot d2."""
    t = np.arange(FFT_SIZE // 16)[None, :]
    d3, d1, d0 = t % 2, (t // 2) % 16, t // 32
    return (d0 + 16 * d1 + 256 * np.arange(16)[:, None] + 4096 * d3).reshape(-1)


@functools.lru_cache(maxsize=None)
def twiddle_table(device: torch.device) -> torch.Tensor:
    """(F/2, 2) float32 [re, im] of exp(-2 pi i e / F), computed in float64:
    kernel E loads W^b, W^2b, W^4b, W^8b of a pass's base b from it (8b <
    F/2 in every pass) and forms the other powers by at most two products."""
    w = np.exp(-2j * np.pi * np.arange(FFT_SIZE // 2) / FFT_SIZE)
    return torch.as_tensor(np.stack([w.real, w.imag], axis=1), dtype=torch.float32,
                           device=device)


def taps_spectrum(h: torch.Tensor) -> torch.Tensor:
    """FFT_F of planar taps (2, T) zero-padded to F, over F, computed in
    complex128, in kernel E's order (`spectrum_order`): (F, 2) float32."""
    H = torch.fft.fft(torch.complex(h[0].double(), h[1].double()), n=FFT_SIZE) / FFT_SIZE
    order = torch.as_tensor(spectrum_order(), device=h.device)
    return torch.view_as_real(H[order].to(torch.complex64)).contiguous()


def _host_spectrum(h: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`taps_spectrum` of host taps on ``device``, cached: the ZC detector
    builds the same template on every call.  Entries are found by comparing
    the taps (cheaper than hashing them)."""
    for i, (taps, dev, spec) in enumerate(_SPECTRA):
        if dev == device and taps.shape == h.shape and torch.equal(taps, h):
            _SPECTRA.insert(0, _SPECTRA.pop(i))
            return spec
    spec = taps_spectrum(h).to(device)
    _SPECTRA.insert(0, (h.clone(), device, spec))
    del _SPECTRA[_SPECTRA_KEEP:]
    return spec


def matched_filter_ols(x: torch.Tensor, taps, out_len: int | None = None, *,
                       precision: str = "bf16x3", nb: int = 4) -> torch.Tensor:
    """Full linear convolution of planar complex streams with ``taps``.

    x: (C, batch, L) float32, C even: (re, im) plane pairs, e.g. the
    [b0_re, b0_im, b1_re, b1_im] rows of the from-IQ pipeline.  taps: at
    most `MAX_TAPS` complex taps, or planar (2, T) float32 (for a matched
    filter, the conjugate-reversed template).  Returns (C, batch, Lc)
    float32 planes, Lc = L + T - 1 or ``out_len`` (exactly zero past
    L + T - 1), history before sample 0 zero.

    ``precision`` takes the TPU kernel's names ('highest', 'bf16x3',
    'default'), which chose its matmul-DFT precision there.  On the H100
    all three run the same float32 FFT kernel, within ~3e-7 of the output
    peak of a complex128 convolution, where a TF32 or BF16 DFT stage would
    add error.  ``nb`` (>= 1) is the number of overlap-save blocks one CTA
    walks in order, the GPU reading of the TPU's sub-blocks per grid step
    (4: on the H100 nb >= 2 ran a few percent faster than 1 at 64 x
    262,144 x 2 streams, and larger nb leaves short inputs fewer CTAs).
    Every block is computed on its own, so every ``precision`` and ``nb``
    gives bit-identical output."""
    with span(_E_SPANS.call):
        # prep on the card path only (a CPU tensor runs the plain version)
        with span(_E_SPANS.prep) if x.is_cuda else NO_SPAN:
            if precision not in PRECISIONS:
                raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
            if nb < 1:
                raise ValueError(f"nb must be >= 1, got {nb}")
            if x.dim() != 3 or x.shape[0] % 2 or x.dtype != torch.float32:
                raise ValueError(f"expected float32 (re, im) plane pairs (C, batch, L), got "
                                 f"{tuple(x.shape)} {x.dtype}")
            host_taps = not isinstance(taps, torch.Tensor) or taps.device.type == "cpu"
            h = planar_taps(taps, "cpu" if host_taps else x.device)
            C, batch, L = x.shape
            T = h.shape[-1]
            if not 1 <= T <= MAX_TAPS:
                raise ValueError(f"matched_filter_ols takes 1 to {MAX_TAPS} taps (got {T})")
            Lc = L + T - 1 if out_len is None else int(out_len)
            if (check_kernel_device(x) if host_taps else check_kernel_device(x, h)) == "cpu":
                return matched_filter_plain(x, h, Lc)
            if not x.is_contiguous():
                raise ValueError("kernel E needs a contiguous input")
            V = FFT_SIZE - DISCARD
            if max(L, Lc) >= _I32_LIMIT or C // 2 * batch * -(-Lc // (V * nb)) >= _I32_LIMIT:
                raise ValueError("kernel E takes < 2^31 samples a stream and < 2^31 CTAs")
            with span(_E_SPANS.alloc):
                out = torch.empty((C, batch, Lc), dtype=torch.float32, device=x.device)
            if out.numel():
                spec = _host_spectrum(h, x.device) if host_taps else taps_spectrum(h)
                tw = twiddle_table(x.device)
        with span(_E_SPANS.launch):
            if out.numel():
                err = build.library().matched_filter_f32(x.data_ptr(), spec.data_ptr(),
                                                         tw.data_ptr(), C, batch, L, T, Lc, nb,
                                                         out.data_ptr(), _stream(x))
                build.check(err, "matched_filter_ols")
                matched_filter_ols.launches += 1
        return out


matched_filter_ols.launches = 0
