"""Port vs JAX: the [A][A] metric (`ops.windows.delayed_product`,
`ops.metrics.aa_metric`, `kernels.streaming.aa_metric_planar` /
`aa_detect_step`) and the reference's own published traces.

Inputs are made with NumPy from a seed and fed to both packages.  JAX sums
windows from float32 cumsums, the port from float64 cumsums, so metric
arrays agree within ``2e-5 * max|R|`` (P and R) and 1e-4 on M, the
tolerances of tests/test_pallas_aa.py:142-154.  Against the golden traces
the tolerances are those of tests/test_golden_vectors.py:36-78.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.conformance.vectors import (  # noqa: E402
    VECTOR_CFO_HZ,
    VECTOR_FS_HZ,
    VECTOR_L,
    golden_stimulus,
    load_golden_vectors,
)
from ofdm_sync_tpu.kernels import streaming as jstream  # noqa: E402
from ofdm_sync_tpu.ops import metrics as jmet  # noqa: E402
from ofdm_sync_tpu.ops import windows as jwin  # noqa: E402
from ofdm_sync_tpu_torch.kernels import streaming as tstream  # noqa: E402
from ofdm_sync_tpu_torch.ops import metrics as tmet  # noqa: E402
from ofdm_sync_tpu_torch.ops import windows as twin  # noqa: E402

ATOL_R = 2e-5   # times max|R|
ATOL_M = 1e-4


def _c64(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _aa_stream(rng, branches=2, n=3000, L=128, pos=900):
    """Noise plus an [A][A] block (two identical halves of length L)."""
    x = 0.3 * _c64(rng, (branches, n))
    A = _c64(rng, (branches, L))
    x[:, pos: pos + L] += A
    x[:, pos + L: pos + 2 * L] += A
    return x


def _assert_metric_close(P_re, P_im, R, M, jP_re, jP_im, jR, jM):
    scale = float(np.abs(np.asarray(jR)).max())
    for name, o, r in (("P_re", P_re, jP_re), ("P_im", P_im, jP_im), ("R", R, jR)):
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=0,
                                   atol=ATOL_R * scale, err_msg=name)
    np.testing.assert_allclose(np.asarray(M), np.asarray(jM), rtol=0, atol=ATOL_M)


@pytest.mark.parametrize("delay", [0, 5, 64, 4000])
def test_delayed_product_matches_jax(rng, delay):
    x = _c64(rng, (2, 3000))
    out = twin.delayed_product(torch.from_numpy(x), delay)
    ref = jwin.delayed_product(jnp.asarray(x), delay)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("branches,L", [(1, 64), (2, 128), (2, 512)])
def test_aa_metric_matches_jax(rng, branches, L):
    x = _aa_stream(rng, branches, n=4 * L + 2000, L=L, pos=2 * L)
    ref = jmet.aa_metric(jnp.asarray(x if branches > 1 else x[0]), L)
    out = tmet.aa_metric(torch.from_numpy(x if branches > 1 else x[0]), L)
    P, jP = out.P.numpy(), np.asarray(ref.P)
    _assert_metric_close(P.real, P.imag, out.R, out.M, jP.real, jP.imag, ref.R, ref.M)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert float(out.M.max()) > 0.7  # the [A][A] block is found


def test_aa_metric_zero_signal_is_finite():
    out = tmet.aa_metric(torch.zeros((2, 700), dtype=torch.complex64), 128)
    assert torch.isfinite(out.M).all() and float(out.M.abs().max()) == 0.0


@pytest.mark.parametrize("batch,L", [((), 64), ((3,), 128)])
def test_aa_metric_planar_matches_jax(rng, batch, L):
    x = np.stack([_aa_stream(np.random.default_rng(s), 2, n=3000, L=L, pos=500 + 300 * s)
                  for s in range(int(np.prod(batch)))]).reshape(batch + (2, 3000))
    iq = np.stack([x.real, x.imag], axis=-2).astype(np.float32)  # (..., BR, 2, n)
    ref = jstream.aa_metric_planar(jnp.asarray(iq), L)
    out = tstream.aa_metric_planar(torch.from_numpy(iq), L)
    _assert_metric_close(out.P_re, out.P_im, out.R, out.M, ref.P_re, ref.P_im, ref.R, ref.M)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))


def test_aa_detect_step_matches_fused_gate_input(rng):
    """track = P_re^2 + P_im^2, M and above as `pallas_aa.py:302-313`
    computes them, from the same (P_re, P_im, R)."""
    L, thr = 128, 0.15
    x = _aa_stream(rng, 2, L=L)
    iq = np.stack([x.real, x.imag], axis=-2).astype(np.float32)
    st = tstream.aa_metric_planar(torch.from_numpy(iq), L)
    track, M, above = tstream.aa_detect_step(st.P_re, st.P_im, st.R, L, thr)
    pr, pi, r = (a.numpy() for a in (st.P_re, st.P_im, st.R))
    n = np.arange(pr.shape[-1])
    p_sq = pr * pr + pi * pi
    valid = n >= L
    m_ref = np.where(valid & (r > np.float32(1e-6 * L)),
                     np.minimum(p_sq / np.maximum(r, np.float32(1e-12)) ** 2, 1.0), 0.0)
    np.testing.assert_array_equal(track.numpy(), p_sq)
    np.testing.assert_array_equal(M.numpy(), m_ref.astype(np.float32))
    np.testing.assert_array_equal(above.numpy(), valid & (m_ref >= np.float32(thr)))
    np.testing.assert_array_equal(M.numpy(), st.M.numpy())


def test_clean_golden_trace():
    """Per-sample (M, P, R) against the reference's published clean trace."""
    g = load_golden_vectors()
    st = tmet.aa_metric(torch.from_numpy(golden_stimulus(cfo_hz=0.0)).to(torch.complex64),
                        VECTOR_L)
    P = st.P.numpy()[g.clean_samples]
    M = st.M.numpy()[g.clean_samples]
    R = st.R.numpy()[g.clean_samples]
    np.testing.assert_allclose(P.real, g.clean_P.real, atol=0.02)
    np.testing.assert_allclose(P.imag, g.clean_P.imag, atol=0.02)
    np.testing.assert_allclose(R, g.clean_R, atol=0.02)
    np.testing.assert_allclose(M, g.clean_M, atol=1e-5)
    np.testing.assert_allclose(np.abs(P) ** 2, g.clean_P_mag_sq, rtol=1e-4, atol=0.05)
    i = np.where(g.clean_samples == 1523)[0][0]
    assert abs(M[i] - 1.0) < 1e-5


def test_cfo_golden_trace():
    """CFO = 500 Hz trace: angle(P) settles at 2 pi 500 L / fs."""
    g = load_golden_vectors()
    st = tmet.aa_metric(
        torch.from_numpy(golden_stimulus(cfo_hz=VECTOR_CFO_HZ)).to(torch.complex64), VECTOR_L)
    P = st.P.numpy()[g.cfo_samples]
    M = st.M.numpy()[g.cfo_samples]
    np.testing.assert_allclose(P.real, g.cfo_P.real, atol=0.05)
    np.testing.assert_allclose(P.imag, g.cfo_P.imag, atol=0.05)
    np.testing.assert_allclose(M, g.cfo_M, atol=1e-5)
    angle = np.angle(P)
    sig = np.abs(P) > 1.0
    np.testing.assert_allclose(angle[sig], g.cfo_angle[sig], atol=1e-4)
    i = np.where(g.cfo_samples == 1523)[0][0]
    np.testing.assert_allclose(angle[i], 2 * np.pi * VECTOR_CFO_HZ * VECTOR_L / VECTOR_FS_HZ,
                               atol=1e-4)


def test_planar_metric_matches_golden_trace():
    """The plain version of kernel C on the planar golden stimulus."""
    g = load_golden_vectors()
    stim = golden_stimulus(cfo_hz=0.0).astype(np.complex64)
    iq = np.stack([stim.real, stim.imag])[None].astype(np.float32)  # (1 branch, 2, n)
    st = tstream.aa_metric_planar(torch.from_numpy(iq), VECTOR_L)
    s = g.clean_samples
    np.testing.assert_allclose(st.P_re.numpy()[s], g.clean_P.real, atol=0.02)
    np.testing.assert_allclose(st.P_im.numpy()[s], g.clean_P.imag, atol=0.02)
    np.testing.assert_allclose(st.R.numpy()[s], g.clean_R, atol=0.02)
    np.testing.assert_allclose(st.M.numpy()[s], g.clean_M, atol=1e-5)
