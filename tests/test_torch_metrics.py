"""Port vs JAX: window primitives, the Minn-RTL metric and the planar
datapath (`ops.windows`, `ops.metrics`, `kernels.streaming`).

Inputs are made with NumPy from a seed and fed to both packages.  Metric
arrays must agree within ``2e-5 * max(1, |ref|max)``: JAX sums windows from
a float32 blocked cumsum, the port from a float64 cumsum, so they differ by
float32 rounding.  `above_threshold` must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels import streaming as jstream  # noqa: E402
from ofdm_sync_tpu.kernels.pallas_minn import minn_rtl_metric_planar_pallas  # noqa: E402
from ofdm_sync_tpu.ops import metrics as jmet  # noqa: E402
from ofdm_sync_tpu.ops import windows as jwin  # noqa: E402
from ofdm_sync_tpu_torch.kernels import streaming as tstream  # noqa: E402
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import minn_rtl_metric  # noqa: E402
from ofdm_sync_tpu_torch.ops import metrics as tmet  # noqa: E402
from ofdm_sync_tpu_torch.ops import windows as twin  # noqa: E402

RTOL = 2e-5
KW = dict(smooth_shift=3, threshold_value=3276, threshold_frac_bits=15)


def _close(out, ref, name=""):
    out = out.numpy() if hasattr(out, "numpy") else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, name
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=RTOL * scale, err_msg=name)


def _compare_states(ref, out):
    for f in ("corr_positive", "smooth_metric", "energy_total"):
        _close(getattr(out, f), getattr(ref, f), f)
    np.testing.assert_array_equal(out.above_threshold.numpy(),
                                  np.asarray(ref.above_threshold))


@pytest.mark.parametrize("delay", [0, 3, 100, 600])
def test_shift_right(delay, rng):
    x = rng.standard_normal((2, 500)).astype(np.float32)
    np.testing.assert_array_equal(
        twin.shift_right(torch.from_numpy(x), delay).numpy(),
        np.asarray(jwin.shift_right(jnp.asarray(x), delay)))


@pytest.mark.parametrize("window", [1, 7, 64])
def test_running_and_sliding_sums(window, rng):
    x = rng.standard_normal((3, 9000)).astype(np.float32)
    _close(twin.running_sum_stream(torch.from_numpy(x), window),
           jwin.running_sum_stream(jnp.asarray(x), window), "running")
    _close(twin.sliding_sum_valid(torch.from_numpy(x), window),
           jwin.sliding_sum_valid(jnp.asarray(x), window), "sliding")


@pytest.mark.parametrize("shift,masked", [(3, True), (0, True), (5, False)])
def test_exp_smooth_shift(shift, masked, rng):
    x = np.abs(rng.standard_normal(10000)).astype(np.float32)
    mask = (np.arange(x.size) >= 191) if masked else None
    out = twin.exp_smooth_shift(torch.from_numpy(x), shift,
                                None if mask is None else torch.from_numpy(mask))
    ref = jwin.exp_smooth_shift(jnp.asarray(x), shift,
                                None if mask is None else jnp.asarray(mask))
    _close(out, ref)


def test_linear_recurrence(rng):
    a = rng.uniform(0.5, 1.0, 3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    _close(twin.linear_recurrence(torch.from_numpy(a), torch.from_numpy(b)),
           jwin.linear_recurrence(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("Q,branches,L", [(16, 1, 1000), (64, 2, 3000), (24, 2, 2000)])
def test_minn_rtl_metric_complex(Q, branches, L, rng):
    rx = (rng.standard_normal((branches, L)) + 1j * rng.standard_normal((branches, L)))
    rx = rx.astype(np.complex64)
    ref = jmet.minn_rtl_metric(jnp.asarray(rx), quarter_len=Q, **KW)
    out = tmet.minn_rtl_metric(torch.from_numpy(rx), quarter_len=Q, **KW)
    _compare_states(ref, out)
    _close(out.corr_total, ref.corr_total, "corr_total")


@pytest.mark.parametrize("batch,Q,L", [(3, 16, 1000), (2, 64, 2500)])
def test_planar_metric_matches_jax_xla_and_pallas(batch, Q, L, rng):
    """Port's plain planar metric vs the JAX XLA datapath and vs the JAX
    Pallas metric kernel (`_minn_kernel`, interpret mode)."""
    iq = rng.standard_normal((batch, 2, 2, L)).astype(np.float32)
    out = tstream.minn_rtl_metric_planar(torch.from_numpy(iq), quarter_len=Q, **KW)
    xla = jstream.minn_rtl_metric_planar(jnp.asarray(iq), quarter_len=Q, **KW)
    _compare_states(xla, out)
    pal = minn_rtl_metric_planar_pallas(jnp.asarray(iq), quarter_len=Q, **KW, block=512)
    _compare_states(pal, out)
    assert out.valid_from == 3 * Q - 1


def test_planar_metric_int16_equals_f32(rng):
    """int16 ADC codes are exact in float32: identical results."""
    iq = rng.integers(-2000, 2000, (2, 2, 2, 3000)).astype(np.int16)
    a = tstream.minn_rtl_metric_planar(torch.from_numpy(iq), quarter_len=64, **KW)
    b = tstream.minn_rtl_metric_planar(torch.from_numpy(iq.astype(np.float32)),
                                       quarter_len=64, **KW)
    for f in ("corr_positive", "smooth_metric", "energy_total", "above_threshold"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_kernel_a_wrapper_cpu_matches_jax(rng):
    """The kernel-A wrapper on a CPU tensor (plain version), channel-leading
    layout, vs the JAX XLA datapath."""
    x = rng.standard_normal((4, 3, 2000)).astype(np.float32)
    corr, above = minn_rtl_metric(torch.from_numpy(x), quarter_len=32, **KW)
    planar = jnp.asarray(x.transpose(1, 0, 2).reshape(3, 2, 2, 2000))
    ref = jstream.minn_rtl_metric_planar(planar, quarter_len=32, **KW)
    _close(corr, ref.corr_positive, "corr")
    np.testing.assert_array_equal(above.numpy(), np.asarray(ref.above_threshold))
    assert above.dtype == torch.bool and corr.dtype == torch.float32
