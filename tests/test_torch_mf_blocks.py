"""The matched filter's block forms: the port's `fft_convolve_full_ols`, the
`block=` / `mxu=` routes of `ops.metrics.matched_filter`, the modes of
`matched_filter_ols`, and a plain-torch model of kernel E's block walk,
each against the JAX package on the same NumPy inputs.

Kernel E (`kernels/csrc/matched_filter.cu`) runs only on a card; here its
arithmetic is modelled pass for pass: the fixed 2048-sample discard
(V = F - 2048 outputs a block, zero history, exact zeros past L + T - 1),
the three radix-16 passes with their twiddles built from the port's
`twiddle_table`, the lane pass, and the taps
spectrum in the port's `spectrum_order`.  The model and the kernel are held
to JAX's `matched_filter_mxu(precision="highest")` in Pallas interpret mode
within 1e-5 of the output peak (the kernel's card checks are in
tests/test_torch_cuda.py and chip_smoke.py).  The wrapper's three
precisions are held to a float64 golden at the tolerances
tests/test_pallas_mf.py:74-76 gives the TPU kernel's modes.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels.pallas_mf import matched_filter_mxu  # noqa: E402
from ofdm_sync_tpu.ops import channel as JC  # noqa: E402
from ofdm_sync_tpu.ops import metrics as JM  # noqa: E402
from ofdm_sync_tpu_torch.kernels import matched_filter as MF  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import launch_counts, reset_launch_counts  # noqa: E402
from ofdm_sync_tpu_torch.ops import channel as TC  # noqa: E402
from ofdm_sync_tpu_torch.ops import metrics as TM  # noqa: E402

MF_RTOL = 1e-5
#: the TPU kernel's modes against a float64 golden (tests/test_pallas_mf.py:74-76)
PRECISION_RTOL = {"highest": 2e-6, "bf16x3": 1e-4, "default": 5e-3}
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _no_compile_cache_writes():
    """The JAX calls here compile shapes of their own: keep them out of the
    persistent compile cache that tests/conftest.py points at
    tests/.jax_cache (entries are still read)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, old)


def _cnoise(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want, rtol=MF_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# ops.channel.fft_convolve_full_ols


@pytest.mark.parametrize("block", [8192, 16384])
@pytest.mark.parametrize("T", [1, 62, 2048, 2049])
def test_fft_convolve_full_ols_matches_jax(rng, T, block):
    step = block - T + 1
    x = _cnoise(rng, (2, 2 * step + 37))  # a ragged third block
    taps = _cnoise(rng, T)
    got = TC.fft_convolve_full_ols(torch.from_numpy(x), torch.from_numpy(taps), block)
    _close(got.numpy(), JC.fft_convolve_full_ols(jnp.asarray(x), jnp.asarray(taps), block))


@pytest.mark.parametrize("L", [8192 - 199 - 1, 8192 - 199, 8192 - 199 + 1, 5000])
def test_fft_convolve_full_ols_block_seams(rng, L):
    """Lengths at a block step (block 8192, T = 200) and below one block,
    against JAX's form and the port's monolithic form."""
    x, taps = _cnoise(rng, (3, L)), _cnoise(rng, 200)
    got = TC.fft_convolve_full_ols(torch.from_numpy(x), torch.from_numpy(taps), 8192).numpy()
    _close(got, JC.fft_convolve_full_ols(jnp.asarray(x), jnp.asarray(taps), 8192))
    _close(got, TC.fft_convolve_full(torch.from_numpy(x), torch.from_numpy(taps)[None]).numpy())


def test_fft_convolve_full_ols_rejects_what_jax_rejects():
    x = torch.zeros((2, 100), dtype=torch.complex64)
    with pytest.raises(ValueError, match="1-D taps"):
        TC.fft_convolve_full_ols(x, torch.zeros((2, 8), dtype=torch.complex64))
    with pytest.raises(ValueError, match="too small"):
        TC.fft_convolve_full_ols(x, torch.zeros(4097, dtype=torch.complex64), 8192)


# ---------------------------------------------------------------------------
# ops.metrics.matched_filter(block=, mxu=)


@pytest.mark.parametrize("route", [dict(mxu=True), dict(block=8192)])
def test_metrics_matched_filter_routes(rng, route):
    """The routes against the monolithic form (tests/test_pallas_mf.py:166-181)
    and against JAX's same route."""
    ref, x = _cnoise(rng, 500), _cnoise(rng, (2, 20000))
    mono = TM.matched_filter(torch.from_numpy(x), ref)
    got = TM.matched_filter(torch.from_numpy(x), ref, **route)
    assert got.dtype == torch.complex64
    _close(got.numpy(), mono.numpy(), 1e-4)
    _close(got.numpy(), JM.matched_filter(jnp.asarray(x), jnp.asarray(ref), **route), 1e-4)


# ---------------------------------------------------------------------------
# matched_filter_ols: its modes and a model of kernel E


def _golden(x: np.ndarray, taps: np.ndarray, out_len: int) -> np.ndarray:
    """float64 full convolution of the plane pairs of x with planar taps,
    zero past L + T - 1."""
    xc = x[0::2].astype(np.float64) + 1j * x[1::2]
    tc = taps[0].astype(np.float64) + 1j * taps[1]
    n = 1 << (x.shape[-1] + tc.size - 2).bit_length()
    y = np.fft.ifft(np.fft.fft(xc, n) * np.fft.fft(tc, n))[..., : x.shape[-1] + tc.size - 1]
    y = np.pad(y, [(0, 0), (0, 0), (0, max(0, out_len - y.shape[-1]))])[..., :out_len]
    out = np.empty((x.shape[0],) + y.shape[1:])
    out[0::2], out[1::2] = y.real, y.imag
    return out


@pytest.mark.parametrize("precision", MF.PRECISIONS)
def test_wrapper_precisions_match_float64(rng, precision):
    """Each mode within its TPU tolerance of float64; all modes and nb
    values give the same output."""
    x = rng.standard_normal((2, 1, 20000)).astype(np.float32)
    taps = _cnoise(rng, 512)
    y = MF.matched_filter_ols(torch.from_numpy(x), taps, precision=precision)
    planar = np.stack([taps.real, taps.imag])
    _close(y.numpy(), _golden(x, planar, y.shape[-1]), PRECISION_RTOL[precision])
    for nb in (2, 4):
        assert torch.equal(y, MF.matched_filter_ols(torch.from_numpy(x), taps, nb=nb,
                                                    precision="highest"))


def test_wrapper_rejects_bad_modes_and_counts_no_cpu_launch():
    x = torch.zeros((2, 1, 300))
    for bad in ("HIGHEST", "tf32", None):
        with pytest.raises(ValueError, match="precision"):
            MF.matched_filter_ols(x, np.ones(8, np.complex64), precision=bad)
    for nb in (0, -1):
        with pytest.raises(ValueError, match="nb"):
            MF.matched_filter_ols(x, np.ones(8, np.complex64), nb=nb)
    reset_launch_counts()
    MF.matched_filter_ols(x, np.ones(8, np.complex64), nb=4, precision="default")
    assert launch_counts()["matched_filter_ols"] == 0


def _twiddles(tw: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """W^(b k), k < 16, as kernel E forms them: table values W^b, W^2b,
    W^4b, W^8b and at most two products on top; (n, 16)."""
    w1, w2, w4, w8 = (tw[m * b] for m in (1, 2, 4, 8))
    w3, w12 = w1 * w2, w8 * w4
    ws = [torch.ones_like(w1), w1, w2, w3, w4, w4 * w1, w4 * w2, w4 * w3, w8, w8 * w1, w8 * w2,
          w8 * w3, w12, w12 * w1, w12 * w2, w12 * w3]
    return torch.stack(ws, dim=-1)


def _kernel_e_blocks(xb: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """Kernel E's in-block passes on blocks xb (B, 8192) complex64, thread t
    holding slots k of (B, 512, 16): forward radix-16 passes over the index
    digits of weight 512, 32, 2 with twiddles, the radix-2 lane pass, the
    product with the spectrum, and the same passes transposed."""
    F = MF.FFT_SIZE
    TH = F // 16
    t, k = torch.arange(TH), torch.arange(16)
    tw = torch.view_as_complex(MF.twiddle_table(CPU))
    c2, d3, d1, d0 = t % 32, t % 2, (t // 2) % 16, t // 32
    p1 = t[:, None] + TH * k
    p2 = (c2 + TH * d0)[:, None] + 32 * k
    p3 = (d3 + 32 * d1 + TH * d0)[:, None] + 2 * k
    passes = ((p1, _twiddles(tw, t)), (p2, _twiddles(tw, 16 * c2)), (p3, _twiddles(tw, 256 * d3)))
    sm = xb.clone()
    for p, w in passes:
        v = torch.fft.fft(sm[:, p], dim=-1) * w
        sm[:, p] = v
    lanes = torch.fft.fft(v.reshape(-1, TH // 2, 2, 16), dim=2)
    v = lanes.reshape(-1, TH, 16) * torch.view_as_complex(spec).reshape(16, TH).T
    v = (torch.fft.ifft(v.reshape(-1, TH // 2, 2, 16), dim=2) * 2).reshape(-1, TH, 16)
    for i, (p, w) in enumerate(reversed(passes)):
        if i:
            v = sm[:, p]
        v = torch.fft.ifft(v * w.conj(), dim=-1) * 16
        sm[:, p] = v
    return sm


def _kernel_e_model(x: np.ndarray, taps: np.ndarray, out_len: int | None = None) -> np.ndarray:
    """Kernel E's block walk: block j reads samples [jV - 2048, jV + V)
    (zero outside the stream) and writes outputs [jV, jV + V); exact zeros
    past L + T - 1."""
    C, batch, L = x.shape
    T = taps.shape[-1]
    V, Lz = MF.FFT_SIZE - MF.DISCARD, L + T - 1
    Lc = Lz if out_len is None else out_len
    nblk = -(-Lc // V)
    xc = torch.from_numpy(x[0::2] + 1j * x[1::2]).to(torch.complex64).reshape(-1, L)
    padded = torch.zeros((xc.shape[0], MF.DISCARD + nblk * V), dtype=torch.complex64)
    n = min(L, nblk * V)
    padded[:, MF.DISCARD: MF.DISCARD + n] = xc[:, :n]
    blocks = padded.unfold(-1, MF.FFT_SIZE, V).reshape(-1, MF.FFT_SIZE)
    spec = MF.taps_spectrum(torch.from_numpy(taps))
    y = _kernel_e_blocks(blocks, spec)[:, MF.DISCARD:].reshape(xc.shape[0], -1)[:, :Lc]
    y = y.reshape(C // 2, batch, Lc)
    y[..., Lz:] = 0
    return torch.stack([y.real, y.imag], dim=1).reshape(C, batch, Lc).numpy()


def test_spectrum_order_and_twiddles():
    F = MF.FFT_SIZE
    assert sorted(MF.spectrum_order().tolist()) == list(range(F))
    tw = torch.view_as_complex(MF.twiddle_table(CPU)).numpy()
    assert tw.shape == (F // 2,)
    np.testing.assert_allclose(tw, np.exp(-2j * np.pi * np.arange(F // 2) / F), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("T", [1, 2049])
def test_kernel_e_passes_are_the_block_convolution(rng, T):
    """The modelled passes equal a complex128 circular convolution of each
    block with the taps (the discarded head included)."""
    F = MF.FFT_SIZE
    xb = torch.from_numpy(_cnoise(rng, (3, F)))
    taps = rng.standard_normal((2, T)).astype(np.float32)
    got = _kernel_e_blocks(xb, MF.taps_spectrum(torch.from_numpy(taps))).numpy()
    h = taps[0].astype(np.float64) + 1j * taps[1]
    want = np.fft.ifft(np.fft.fft(xb.numpy().astype(np.complex128)) * np.fft.fft(h, F))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("T,L,out_len", [
    (1, 5000, None),                  # one block
    (62, 6144 - 1, None),             # at V's seam
    (2048, 6144 + 1, 4000),           # out_len shorter than L
    (2049, 2 * 6144 + 37, 2 * 6144 + 37 + 2048 + 6000),  # longer: zero blocks
    (2049, 14336 + 1, None),          # across the TPU kernel's block seam
    (300, 9000, 9500),
])
def test_kernel_e_model_matches_jax(rng, T, L, out_len):
    x = rng.standard_normal((4, 2, L)).astype(np.float32)
    taps = rng.standard_normal((2, T)).astype(np.float32)
    got = _kernel_e_model(x, taps, out_len)
    kw = {} if out_len is None else dict(out_len=out_len)
    want = np.asarray(matched_filter_mxu(jnp.asarray(x), taps, precision="highest",
                                         interpret=True, **kw))
    _close(got, want)
    assert not got[..., L + T - 1:].any()
    _close(got, _golden(x, taps, got.shape[-1]), 1e-6)


def test_kernel_e_model_walk_geometry():
    """43 blocks of 6144 outputs cover L + T - 1 = 264,191 at the headline;
    the fixed discard covers the longest template."""
    assert math.ceil(((1 << 18) + 2047) / (MF.FFT_SIZE - MF.DISCARD)) == 43
    assert MF.MAX_TAPS - 1 == MF.DISCARD
