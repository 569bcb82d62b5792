"""Port's standard Minn family (D2) vs the JAX package and the reference:
`ops.metrics.minn_metric`, `find_minn_peak_standard`,
`ops.detect.largest_true_run` / `mask_segments`,
`ops.windows.trailing_average`, `MinnDetector` (with its ``symbol_len``),
`pipelines/minn.py` (`run_simulation`, `compare_block_lengths`) and the CLI
``minn``.

Tolerances: metric arrays within 2e-5 of the peak of |ref| (float64 window
sums here, float32 cumulative sums in JAX); peaks, gate masks and segments
equal.  The simulations reproduce tests/test_pipeline_parity.py:41-57
(indices exact, CFO within 0.05 Hz, EVM within 0.2 points) and print the
JAX pipeline's report line for line.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.models.detectors import MinnDetector as JMinnDetector  # noqa: E402
from ofdm_sync_tpu.ops import detect as jdetect  # noqa: E402
from ofdm_sync_tpu.ops import metrics as jM  # noqa: E402
from ofdm_sync_tpu.ops import windows as jwindows  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_minn_preamble as j_build  # noqa: E402
from ofdm_sync_tpu.params import SystemParams  # noqa: E402
from ofdm_sync_tpu.pipelines import minn as jminn  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import MinnDetector  # noqa: E402
from ofdm_sync_tpu_torch.ops import detect  # noqa: E402
from ofdm_sync_tpu_torch.ops import metrics as M  # noqa: E402
from ofdm_sync_tpu_torch.ops.waveforms import build_minn_preamble  # noqa: E402
from ofdm_sync_tpu_torch.ops.windows import trailing_average  # noqa: E402
from ofdm_sync_tpu_torch.params import SystemParams as TSystemParams  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import minn  # noqa: E402
from test_torch_sc import _close, check_reference, no_jax_cache_writes  # noqa: E402,F401

SMALL = dict(n_fft=256, cp_len=64, num_active=150, tx_pre_pad=300)


def _rx(seed, snr_db=3.0, branches=2, L=3000):
    rng = np.random.default_rng(seed)
    pre = j_build(np.random.default_rng(seed), SystemParams(**SMALL))
    x = np.zeros((branches, L), complex)
    x[:, 900:900 + pre.size] = pre
    s = 10 ** (-snr_db / 20) / np.sqrt(2)
    x += s * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def test_preamble_equals_jax():
    a = build_minn_preamble(np.random.default_rng(5), TSystemParams(**SMALL))
    np.testing.assert_array_equal(a, j_build(np.random.default_rng(5), SystemParams(**SMALL)))


@pytest.mark.parametrize("seed,branches", [(0, 1), (1, 2)])
def test_minn_metric_and_peak_match_jax(seed, branches):
    x = _rx(seed, branches=branches)
    jMm, jP, jR = jM.minn_metric(jnp.asarray(x), 256)
    tMm, tP, tR = M.minn_metric(torch.from_numpy(x), 256)
    for what, t, j in (("M", tMm, jMm), ("P", tP, jP), ("R", tR, jR)):
        _close(t, j, what)
    for kw in (dict(smooth_win=8, gate_threshold=0.5),
               dict(smooth_win=16, gate_threshold=0.2, search_bounds=(950, 1200)),
               dict(smooth_win=1, gate_threshold=0.5, search_bounds=(50, 10))):
        jp, jg, jMs = jM.find_minn_peak_standard(jMm, **kw)
        tp, tg, tMs = M.find_minn_peak_standard(tMm, **kw)
        assert int(tp) == int(jp), kw
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        _close(tMs, jMs, "M_smooth")


def test_find_minn_peak_falls_back_to_argmax():
    """An all-zero metric (max 0) and a gate cut away by the search bounds
    both fall back to the global argmax (reference minn.py:195-200)."""
    for m, bounds in ((np.zeros(64, np.float32), None),
                      (np.r_[np.zeros(10), np.ones(5), np.zeros(49)].astype(np.float32),
                       (40, 60))):
        jp, jg, _ = jM.find_minn_peak_standard(jnp.asarray(m), 4, 0.5, bounds)
        tp, tg, _ = M.find_minn_peak_standard(torch.from_numpy(m), 4, 0.5, bounds)
        assert int(tp) == int(jp)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        assert int(tg.sum()) == 1


@pytest.mark.parametrize("seed", range(5))
def test_largest_true_run_matches_jax(seed):
    mask = np.random.default_rng(seed).random(300) < 0.2 * (seed + 1)
    want = np.asarray(jdetect.largest_true_run(jnp.asarray(mask)))
    np.testing.assert_array_equal(detect.largest_true_run(torch.from_numpy(mask)).numpy(), want)


def test_largest_true_run_ties_keep_the_earliest():
    m = torch.tensor([0, 1, 1, 0, 1, 0, 1, 1, 0, 1, 1], dtype=torch.bool)
    want = [0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0]
    assert detect.largest_true_run(m).tolist() == [bool(v) for v in want]
    np.testing.assert_array_equal(np.asarray(jdetect.largest_true_run(jnp.asarray(m.numpy()))),
                                  want)
    assert not detect.largest_true_run(torch.zeros(5, dtype=torch.bool)).any()
    assert detect.largest_true_run(m[:0]).shape == (0,)


@pytest.mark.parametrize("mask", [[], [0, 0], [1, 1, 0, 1], [0, 1, 1, 0, 0, 1, 1, 1], [1]])
def test_mask_segments_match_jax(mask):
    m = np.asarray(mask, bool)
    want = [(int(s), int(e)) for s, e in jdetect.mask_segments(m)]
    assert detect.mask_segments(torch.from_numpy(m)) == want == detect.mask_segments(m)


@pytest.mark.parametrize("window", [1, 5, 16])
def test_trailing_average_matches_jax(window):
    x = np.random.default_rng(window).random(200).astype(np.float32)
    want = np.asarray(jwindows.trailing_average(jnp.asarray(x), window))
    got = trailing_average(torch.from_numpy(x), window)
    assert got.dtype == torch.float32
    _close(got, want, "trailing average")


def test_detector_symbol_len_matches_jax():
    x = _rx(2)
    sys = dict(n_fft=1024, cp_len=256, num_active=600, tx_pre_pad=300)
    j = JMinnDetector(SystemParams(**sys), symbol_len=256).detect(x)
    t = MinnDetector(TSystemParams(**sys), symbol_len=256).detect(torch.from_numpy(x))
    assert t["peak"] == j["peak"]
    np.testing.assert_array_equal(t["gate_mask"], np.asarray(j["gate_mask"]))
    assert t["M"].shape == j["M"].shape == (3000 - 256 + 1,)


REFERENCE = {  # tests/test_pipeline_parity.py:41-57
    "cir1": dict(peak=2065, timing_error=116, cfo_est_hz=1111.81, evm_pct=96.45),
    None: dict(peak=1856, timing_error=7, cfo_est_hz=833.24),
}


@pytest.mark.parametrize("channel", list(REFERENCE))
def test_simulation_reproduces_reference(channel):
    check_reference(minn.run_simulation(channel, device="cpu"), REFERENCE[channel], 0.2)


def test_report_matches_jax(capsys):
    jr = jminn.run_simulation(None, None)
    jout = capsys.readouterr().out
    tr = minn.run_simulation(None, device="cpu")
    assert capsys.readouterr().out.splitlines() == jout.splitlines()
    assert abs(tr["peak_ratio"] - jr["peak_ratio"]) <= 1e-4 * jr["peak_ratio"]
    assert abs(tr["sidelobe_ratio"] - jr["sidelobe_ratio"]) <= 1e-4 * jr["sidelobe_ratio"]


def test_block_length_sweep_matches_jax():
    want = jminn.compare_block_lengths([512, 1024])
    got = minn.compare_block_lengths([512, 1024], device="cpu")
    assert list(got) == list(want)
    for n in want:
        assert (got[n]["timing_error"], got[n]["overhead"]) == (
            want[n]["timing_error"], want[n]["overhead"])
        for key in ("peak_val", "noise_floor", "noise_max"):
            assert abs(got[n][key] - want[n][key]) <= 2e-5 * max(1.0, want[n]["peak_val"]), key


def test_cli(capsys):
    assert t_main(["minn", "--device", "cpu", "--no-plots"]) == 0
    out = capsys.readouterr().out
    assert "Detected Minn peak at d=2065" in out and "Detected Minn peak at d=1856" in out
    assert "BLOCK LENGTH COMPARISON - FLAT AWGN" in out and "ALL SIMULATIONS COMPLETE" in out
