"""Port's ZC metric ops vs the JAX package: `build_pss_symbol`,
`matched_filter`, `sliding_energy_full`, both normalized correlations, and
`estimate_timing_offset_from_phase_slope` with its `unwrap`.

The same NumPy inputs (seeded) go through both.  Tolerances: the PSS
symbol is built by the same NumPy code and must be equal; the matched
filter (complex64 FFT in both) within 1e-5 of the output peak.  JAX takes
the sliding energy as differences of a float32 cumulative sum over the
whole stream, the port from a float64 one: the energies agree within 1e-5
of their peak plus 1e-6 of the stream's total energy (the float32 drift),
and the port alone is held to 1e-6 of the peak against float64 NumPy.  The
normalized correlations agree within 1e-5 of the peak magnitude where the
R-sample window lies inside the stream, and within 1e-4 at the head and
tail, where the window holds fewer samples and the normalization divides
those rounding errors by a small energy.  The phase slope agrees within
1e-5 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.ops import estimate as JE  # noqa: E402
from ofdm_sync_tpu.ops import metrics as JM  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_pss_symbol as j_pss  # noqa: E402
from ofdm_sync_tpu.params import SYS_30M72, SystemParams  # noqa: E402
from ofdm_sync_tpu_torch.ops import estimate as TE  # noqa: E402
from ofdm_sync_tpu_torch.ops import metrics as TM  # noqa: E402
from ofdm_sync_tpu_torch.ops.waveforms import build_pss_symbol  # noqa: E402

SMALL = SystemParams(n_fft=256, num_active=144, cp_len=64)


def _rx(rng, branches=2, L=5000, pos=1800, ref=None):
    """complex64 (branches, L): the template at ``pos`` (0.7x on the second
    branch) in complex noise of amplitude 0.05."""
    rx = 0.05 * (rng.standard_normal((branches, L)) + 1j * rng.standard_normal((branches, L)))
    if ref is not None:
        for b in range(branches):
            rx[b, pos: pos + ref.size] += (0.7 ** b) * ref
    return rx.astype(np.complex64)


def _close(out, ref, rtol=1e-5):
    out = out.numpy() if hasattr(out, "numpy") else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("sys_p,include_cp", [(SYS_30M72, False), (SYS_30M72, True),
                                              (SMALL, False)])
def test_pss_symbol_equal(sys_p, include_cp):
    np.testing.assert_array_equal(build_pss_symbol(sys_p, include_cp=include_cp),
                                  j_pss(sys_p, include_cp=include_cp))


def test_matched_filter_matches_jax(rng):
    ref = j_pss(SMALL)
    rx = _rx(rng, ref=ref)
    _close(TM.matched_filter(torch.from_numpy(rx), ref),
           JM.matched_filter(jnp.asarray(rx), jnp.asarray(ref, jnp.complex64)))


@pytest.mark.parametrize("window", [1, 256, 2048])
def test_sliding_energy_full_matches_jax(rng, window):
    rx = _rx(rng, L=7000)
    out = TM.sliding_energy_full(torch.from_numpy(rx), window).numpy()
    assert out.shape == (2, 7000 + window - 1)
    p = np.abs(rx.astype(np.complex128)) ** 2
    exact = np.stack([np.convolve(row, np.ones(window)) for row in p])
    np.testing.assert_allclose(out, exact, rtol=0, atol=1e-6 * exact.max())
    jout = np.asarray(JM.sliding_energy_full(jnp.asarray(rx), window))
    np.testing.assert_allclose(out, jout, rtol=0,
                               atol=1e-5 * exact.max() + 1e-6 * p.sum(axis=-1).max())


def test_sliding_energy_full_one_dim_and_short():
    """(L,) input is one branch; a window longer than the stream still
    gives L + W - 1 samples."""
    x = torch.ones(10, dtype=torch.complex64)
    out = TM.sliding_energy_full(x, 16)
    assert out.shape == (1, 25)
    assert out[0, :10].tolist() == list(range(1, 11))
    assert float(out.max()) == 10.0


@pytest.mark.parametrize("branches", [1, 2])
def test_normalized_correlations_match_jax(rng, branches):
    ref = j_pss(SMALL)
    rx = _rx(rng, branches=branches, ref=ref)
    ref_j = jnp.asarray(ref, jnp.complex64)
    corr, mag = TM.zc_normalized_correlation(torch.from_numpy(rx), ref)
    jcorr, jmag = JM.zc_normalized_correlation(jnp.asarray(rx), ref_j)
    pb = TM.zc_normalized_correlation_per_branch(torch.from_numpy(rx), ref)
    jpb = JM.zc_normalized_correlation_per_branch(jnp.asarray(rx), ref_j)
    inside = slice(ref.size - 1, rx.shape[-1])  # the window lies in the stream
    for out, want in ((corr, jcorr), (mag, jmag), (pb, jpb)):
        _close(out[inside], np.asarray(want)[inside])
        _close(out, want, rtol=1e-4)
    assert int(mag.argmax()) == int(jnp.argmax(jmag)) == 1800 + ref.size - 1


def test_zero_signal_correlation_is_finite():
    ref = j_pss(SMALL)
    corr, mag = TM.zc_normalized_correlation(torch.zeros((2, 900), dtype=torch.complex64), ref)
    pb = TM.zc_normalized_correlation_per_branch(torch.zeros((2, 900), dtype=torch.complex64),
                                                 ref)
    assert torch.isfinite(mag).all() and torch.isfinite(pb.abs()).all()
    assert float(mag.max()) == 0.0


def test_unwrap_matches_numpy(rng):
    phase = np.cumsum(rng.uniform(-3.0, 3.0, (3, 400)), axis=-1).astype(np.float32)
    wrapped = np.angle(np.exp(1j * phase)).astype(np.float32)
    np.testing.assert_allclose(TE.unwrap(torch.from_numpy(wrapped)).numpy(),
                               np.unwrap(wrapped), rtol=0, atol=1e-3)


@pytest.mark.parametrize("delay", [0.0, 3.7, -41.25])
def test_phase_slope_sto_matches_jax(rng, delay):
    """A pure delay d gives H(k) = exp(-j 2 pi k d / N): STO ~ d."""
    sys_p = SYS_30M72
    k = np.concatenate([np.arange(-600, 0), np.arange(1, 601)])
    h = np.exp(-2j * np.pi * k * delay / sys_p.n_fft) * (
        1 + 0.05 * (rng.standard_normal(k.size) + 1j * rng.standard_normal(k.size)))
    h = h.astype(np.complex64)
    ts, tt = TE.estimate_timing_offset_from_phase_slope(torch.from_numpy(h), sys_p.n_fft,
                                                        sys_p.num_active)
    js, jt = JE.estimate_timing_offset_from_phase_slope(jnp.asarray(h), sys_p.n_fft,
                                                        sys_p.num_active)
    assert abs(float(ts) - float(js)) <= 1e-5 * max(abs(float(js)), 1e-3)
    assert abs(float(tt) - float(jt)) <= 1e-5 * max(abs(float(jt)), 1e-2)
    assert abs(float(tt) - delay) < 0.05
