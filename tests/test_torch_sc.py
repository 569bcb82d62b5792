"""Port's Schmidl & Cox family (D1) vs the JAX package and the reference:
`ops.metrics.sc_metric`, `find_plateau_end` (with its "same" smoothing),
`ops.detect.earliest_long_run_end`, `SCDetector`, `pipelines/sc.py` and
the CLI ``sc``.

Tolerances: the port's window sums accumulate in float64, JAX's in a
float32 cumulative sum, so metric arrays agree within 2e-5 of the peak of
|ref| (M, P, R each); integer outputs (plateau ends, run ends, coarse
starts) must be equal.  The simulations must reproduce the values of
tests/test_pipeline_parity.py:20-38 (indices exact, CFO within 0.05 Hz,
EVM within 0.15 points) and print the JAX pipeline's report line for line.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.models.detectors import SCDetector as JSCDetector  # noqa: E402
from ofdm_sync_tpu.ops import detect as jdetect  # noqa: E402
from ofdm_sync_tpu.ops import metrics as jM  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_sc_preamble as j_build  # noqa: E402
from ofdm_sync_tpu.params import SystemParams  # noqa: E402
from ofdm_sync_tpu.pipelines import sc as jsc  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from torch_plots import assert_same_run  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import SCDetector  # noqa: E402
from ofdm_sync_tpu_torch.ops import detect  # noqa: E402
from ofdm_sync_tpu_torch.ops import metrics as M  # noqa: E402
from ofdm_sync_tpu_torch.ops.waveforms import build_sc_preamble  # noqa: E402
from ofdm_sync_tpu_torch.params import SystemParams as TSystemParams  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import sc  # noqa: E402

RTOL_PEAK = 2e-5


@pytest.fixture(scope="module", autouse=True)
def no_jax_cache_writes():
    """The JAX calls of the port's tests compile shapes of their own: keep
    them out of the persistent compile cache that tests/conftest.py points
    at tests/.jax_cache (entries are still read).  The other family files
    import this fixture."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, old)
SMALL = dict(n_fft=256, cp_len=64, num_active=150, tx_pre_pad=300)


def _close(out, ref, what=""):
    out = out.numpy() if hasattr(out, "numpy") else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, what
    np.testing.assert_allclose(out, ref, rtol=0, atol=RTOL_PEAK * max(1.0, np.abs(ref).max()),
                               err_msg=what)


def _rx(seed, snr_db=5.0, branches=2, L=3000):
    """An S&C preamble (N = 256) at sample 700 in noise, ``branches``
    branches, complex64."""
    rng = np.random.default_rng(seed)
    pre = j_build(np.random.default_rng(seed), SystemParams(**SMALL))
    x = np.zeros((branches, L), complex)
    x[:, 700:700 + pre.size] = pre * np.linspace(1.0, 0.7, branches)[:, None]
    s = 10 ** (-snr_db / 20) / np.sqrt(2)
    x += s * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def test_preamble_equals_jax():
    a = build_sc_preamble(np.random.default_rng(3), TSystemParams(**SMALL))
    b = j_build(np.random.default_rng(3), SystemParams(**SMALL))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,branches", [(0, 1), (1, 2)])
def test_sc_metric_and_plateau_match_jax(seed, branches):
    x = _rx(seed, branches=branches)
    jMm, jP, jR = jM.sc_metric(jnp.asarray(x), 256)
    tMm, tP, tR = M.sc_metric(torch.from_numpy(x), 256)
    for what, t, j in (("M", tMm, jMm), ("P", tP, jP), ("R", tR, jR)):
        _close(t, j, what)
    for frac, run in ((0.95, 0.6), (0.5, 0.6), (0.01, 0.6), (0.01, 1.5)):
        kw = dict(lookahead=16, smooth_win=8, plateau_frac=frac, run_threshold=run)
        assert M.find_plateau_end(tMm, 64, **kw) == int(jM.find_plateau_end(jMm, 64, **kw))


@pytest.mark.parametrize("w", [1, 7, 8])
def test_smoothing_is_numpy_same_mode(w):
    """``np.convolve(M, ones(w)/w, "same")``: output i averages
    M[i - w//2 .. i + w - 1 - w//2] (one sample further back than forward
    for an even w), within 1e-6 relative."""
    m = np.random.default_rng(w).random(300).astype(np.float32)
    want = np.convolve(m.astype(np.float64), np.ones(w) / w, mode="same")
    got = M._smooth_same(torch.from_numpy(m), w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["strategy1", "strategy2", "strategy3", "flat", "empty"])
def test_find_plateau_end_strategies_match_jax(case):
    """Each of the three strategies picks the JAX package's index: an early
    drop (1), no drop within cp_len but a long high run (2), neither (3:
    the slope drop; the max is the last sample), and the degenerate
    all-zero and empty metrics."""
    n, cp = 400, 64
    m = np.zeros(n, np.float32)
    if case == "strategy1":
        m[100:140] = 1.0                            # drops within cp of the max
    elif case == "strategy2":
        m[100:300] = np.linspace(1.0, 0.96, 200)   # no drop below 95% within cp
    elif case == "strategy3":  # unsmoothed: the max is the last sample, a short run
        m[-6:] = [0.2, 0.4, 0.6, 0.8, 0.9, 1.0]
    elif case == "empty":
        m = m[:0]
    kw = dict(smooth_win=1 if case == "strategy3" else 8)
    want = int(jM.find_plateau_end(jnp.asarray(m), cp, **kw)) if m.size else 0
    assert M.find_plateau_end(torch.from_numpy(m), cp, **kw) == want


@pytest.mark.parametrize("seed", range(6))
def test_earliest_long_run_end_matches_jax(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(200) < (0.3 + 0.1 * seed)
    if seed == 5:
        mask[:] = False
    for min_run in (1, 3, 5, 500):
        want = int(jdetect.earliest_long_run_end(jnp.asarray(mask), min_run))
        assert int(detect.earliest_long_run_end(torch.from_numpy(mask), min_run)) == want


def test_earliest_long_run_end_ties_and_edges():
    m = torch.tensor([0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1], dtype=torch.bool)
    assert int(detect.earliest_long_run_end(m, 3)) == 3   # the first of two equal runs
    assert int(detect.earliest_long_run_end(m, 4)) == 12  # a run to the last sample
    assert int(detect.earliest_long_run_end(m[:0], 1)) == -1


def test_detector_matches_jax():
    x = _rx(4)
    j = JSCDetector(SystemParams(**SMALL)).detect(x)
    t = SCDetector(TSystemParams(**SMALL)).detect(torch.from_numpy(x))
    assert (t["plateau_end"], t["coarse_start"]) == (j["plateau_end"], j["coarse_start"])
    _close(t["M"], j["M"], "M")


REFERENCE = {  # tests/test_pipeline_parity.py:20-38
    "cir1": dict(plateau_end=2063, coarse_start=2047, timing_error=540, cfo_est_hz=933.82,
                 evm_pct=73.12),
    None: dict(plateau_end=1861, coarse_start=1845, cfo_est_hz=1027.74, evm_pct=32.96),
}


def check_reference(r, ref, evm_tol=0.15):
    for key, want in ref.items():
        if key == "cfo_est_hz":
            assert abs(r[key] - want) < 0.05, key
        elif key == "evm_pct":
            assert abs(100 * r["evm_rms"] - want) < evm_tol, key
        else:
            assert r[key] == want, key


@pytest.mark.parametrize("channel", list(REFERENCE))
def test_simulation_reproduces_reference(channel):
    check_reference(sc.run_simulation(channel, device="cpu"), REFERENCE[channel])


def test_report_matches_jax(capsys):
    jr = jsc.run_simulation("cir1", None)
    jout = capsys.readouterr().out
    tr = sc.run_simulation("cir1", device="cpu")
    assert capsys.readouterr().out.splitlines() == jout.splitlines()
    assert (tr["plateau_end"], tr["coarse_start"]) == (jr["plateau_end"], jr["coarse_start"])


def test_plots_match_jax(tmp_path):
    """With plots on, the port prints the JAX pipeline's lines (its "Plots
    saved to" line included) and writes the same PNG files."""
    _, _, files = assert_same_run(tmp_path, jsc.run_simulation, sc.run_simulation, "cir1",
                                  "measured_channel", device="cpu")
    assert "plots/sc/measured_channel/sc_metric.png" in files and len(files) == 7


def test_cli(capsys):
    assert t_main(["sc", "--device", "cpu", "--no-plots"]) == 0
    out = capsys.readouterr().out
    assert "Detected plateau end at d=2063" in out and "Detected plateau end at d=1861" in out
    assert "ALL SIMULATIONS COMPLETE" in out
