"""Port's Park family (D4) vs the JAX package, a direct NumPy sum and the
reference: `ops.metrics._poly_mul`, `_place_strided`,
`park_banded_selfconv`, `park_metric` (a power-of-two half, and the
`frame_signal` gather for another), `ops.windows.frame_signal`,
`ParkDetector`, `pipelines/park.py` and the CLI ``park``.

Tolerances: the banded self-convolution within 1e-5 of the peak of a
float64 direct sum ``sum_k x[d-k] x[d+k]`` (both are complex64 FFT
products, rounded in another order); metric arrays within 2e-5 of the peak
of the JAX package's; centers equal.  The simulations reproduce
tests/test_pipeline_parity.py:140-156, the cir1 mis-lock (center 8619)
included, and print the JAX pipeline's report line for line.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.models.detectors import ParkDetector as JParkDetector  # noqa: E402
from ofdm_sync_tpu.ops import metrics as jM  # noqa: E402
from ofdm_sync_tpu.ops import windows as jwindows  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_park_preamble as j_build  # noqa: E402
from ofdm_sync_tpu.params import SystemParams  # noqa: E402
from ofdm_sync_tpu.pipelines import park as jpark  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import ParkDetector  # noqa: E402
from ofdm_sync_tpu_torch.ops import metrics as M  # noqa: E402
from ofdm_sync_tpu_torch.ops.waveforms import build_park_preamble  # noqa: E402
from ofdm_sync_tpu_torch.ops.windows import frame_signal  # noqa: E402
from ofdm_sync_tpu_torch.params import SystemParams as TSystemParams  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import park  # noqa: E402
from test_torch_sc import _close, check_reference, no_jax_cache_writes  # noqa: E402,F401


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _direct(x: np.ndarray, half: int) -> np.ndarray:
    """float64 ``P(d) = sum_{k<half} x[d-k] x[d+k]`` for d in [half, L-half)."""
    x = x.astype(np.complex128)
    L = x.shape[-1]
    return np.stack([sum(x[..., d - k] * x[..., d + k] for k in range(half))
                     for d in range(half, L - half)], axis=-1)


@pytest.mark.parametrize("s,t", [(3, 11), (8, 8), (9, 40), (33, 5)])
def test_poly_mul_is_a_full_convolution(s, t):
    """Operands of at most 8 take the shift-add path, longer ones the FFT
    product: both are the full convolution, batched."""
    rng = np.random.default_rng(s)
    u, v = _cplx(rng, (2, s)), _cplx(rng, (2, t))
    want = np.stack([np.convolve(a.astype(np.complex128), b) for a, b in zip(u, v)])
    got = M._poly_mul(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_place_strided_matches_jax():
    c = _cplx(np.random.default_rng(0), (2, 5, 3))
    for stride, base, out_len in ((4, 0, 30), (3, 7, 19), (6, 2, 40)):
        want = np.asarray(jM._place_strided(jnp.asarray(c), stride, base, out_len))
        got = M._place_strided(torch.from_numpy(c), stride, base, out_len).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("half,L", [(2, 21), (16, 300), (64, 1000)])
def test_banded_selfconv_matches_direct_sum(half, L):
    x = _cplx(np.random.default_rng(half), (2, L))
    want = _direct(x, half)
    got = M.park_banded_selfconv(torch.from_numpy(x), half).numpy()[..., half:L - half]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError):
        M.park_banded_selfconv(torch.from_numpy(x), half + 1 if half > 2 else 3)


def test_frame_signal_matches_jax():
    x = _cplx(np.random.default_rng(1), (2, 50))
    for num, flen, hop, off in ((10, 7, 1, 3), (5, 8, 4, 0)):
        want = np.asarray(jwindows.frame_signal(jnp.asarray(x), num, flen, hop, off))
        np.testing.assert_array_equal(frame_signal(torch.from_numpy(x), num, flen, hop, off)
                                      .numpy(), want)
    with pytest.raises(ValueError):
        frame_signal(torch.from_numpy(x), 10, 8, 5, 0)  # runs past the end


def _rx(seed, n_fft, L=2500, pos=700):
    rng = np.random.default_rng(seed)
    sys = SystemParams(n_fft=n_fft, cp_len=n_fft // 4, num_active=n_fft // 2, tx_pre_pad=300)
    pre = j_build(np.random.default_rng(seed), sys)
    x = 0.3 * _cplx(rng, (2, L)).astype(complex)
    x[:, pos:pos + pre.size] += pre
    return x.astype(np.complex64), sys


@pytest.mark.parametrize("n_fft", [256, 200])
def test_park_metric_and_detector_match_jax(n_fft):
    """A power-of-two half (the banded self-convolution) and half = 100
    (the framed gather)."""
    x, sys = _rx(n_fft, n_fft)
    tsys = TSystemParams(n_fft=n_fft, cp_len=n_fft // 4, num_active=n_fft // 2, tx_pre_pad=300)
    t, j = ParkDetector(tsys).detect(torch.from_numpy(x)), JParkDetector(sys).detect(x)
    np.testing.assert_array_equal(t["ds"].numpy(), np.asarray(j["ds"]))
    for key in ("M", "P", "E"):  # the detector's park_metric outputs
        _close(t[key], j[key], key)
    for key in ("det_center", "det_symbol_start", "det_cp_start"):
        assert t[key] == j[key], key


def test_park_metric_short_stream_is_empty():
    ds, Mm, P, E = M.park_metric(torch.zeros(2, 256, dtype=torch.complex64), 256)
    assert ds.shape == Mm.shape == P.shape == E.shape == (0,)


def test_preamble_equals_jax():
    sys = dict(n_fft=256, cp_len=64, num_active=150)
    a = build_park_preamble(np.random.default_rng(2), TSystemParams(**sys))
    np.testing.assert_array_equal(a, j_build(np.random.default_rng(2), SystemParams(**sys)))
    with pytest.raises(ValueError):
        build_park_preamble(np.random.default_rng(2), TSystemParams(n_fft=254))


REFERENCE = {  # tests/test_pipeline_parity.py:140-156 (cir1: the reference mis-locks)
    "cir1": dict(det_center=8619, det_symbol_start=7595, cfo_est_hz=1883.81),
    None: dict(det_center=2616, det_symbol_start=1592, timing_error=-1, cfo_est_hz=980.18,
               evm_pct=30.96),
}


@pytest.mark.parametrize("channel", list(REFERENCE))
def test_simulation_reproduces_reference(channel):
    check_reference(park.run_simulation(channel, device="cpu"), REFERENCE[channel])


def test_report_matches_jax(capsys):
    jpark.run_simulation("cir1", None)
    jout = capsys.readouterr().out
    park.run_simulation("cir1", device="cpu")
    assert capsys.readouterr().out.splitlines() == jout.splitlines()


def test_cli(capsys):
    assert t_main(["park", "--device", "cpu", "--no-plots"]) == 0
    out = capsys.readouterr().out
    assert "Detected center index: 8619" in out and "Detected center index: 2616" in out
    assert "ALL PARK SIMULATIONS COMPLETE" in out
