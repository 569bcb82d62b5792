"""Port's frequency-domain Zadoff-Chu family (D6) vs the JAX package and
the reference: `ops.metrics.zc_freq_metric` (per-offset FFTs in chunks)
and `zc_freq_metric_sliding` (one modulate-and-window-sum pass per
template bin), `ZCFreqDetector` in both forms, `pipelines/zc_freq.py` and
the CLI ``zc_freq``.

Tolerances: each form within 2e-5 of the peak of the JAX package's same
form, and the two forms of the port within 2e-5 of each other's peak (the
sliding form's window sums accumulate in float64 here); detected CP starts
equal.  The cir1 simulation reproduces tests/test_pipeline_parity.py:96-102
(CFO within 0.1 Hz, EVM within 0.2 points), and both print the JAX
pipeline's report line for line.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.models.detectors import ZCFreqDetector as JZCFreqDetector  # noqa: E402
from ofdm_sync_tpu.ops import metrics as jM  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_pss_symbol  # noqa: E402
from ofdm_sync_tpu.params import SystemParams  # noqa: E402
from ofdm_sync_tpu.pipelines import zc_freq as jzc_freq  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import ZCFreqDetector  # noqa: E402
from ofdm_sync_tpu_torch.ops import metrics as M  # noqa: E402
from ofdm_sync_tpu_torch.ops.waveforms import (  # noqa: E402
    centered_subcarrier_indices,
    generate_zadoff_chu,
)
from ofdm_sync_tpu_torch.params import SystemParams as TSystemParams  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import zc_freq  # noqa: E402
from test_torch_sc import _close, check_reference, no_jax_cache_writes  # noqa: E402,F401

SMALL = dict(n_fft=256, cp_len=64, num_active=150, tx_pre_pad=300)
BINS, TMPL = centered_subcarrier_indices(62), generate_zadoff_chu(25, 62)


def _rx(seed, branches=2, L=2100, pos=611):
    rng = np.random.default_rng(seed)
    pss = build_pss_symbol(SystemParams(**SMALL), include_cp=True)
    x = 0.2 * (rng.standard_normal((branches, L)) + 1j * rng.standard_normal((branches, L)))
    x[:, pos:pos + pss.size] += pss
    return x.astype(np.complex64)


@pytest.mark.parametrize("branches,chunk", [(1, 512), (2, 300)])
def test_metrics_match_jax(branches, chunk):
    """Both forms against JAX's, the FFT form with a chunk that does not
    divide the offset count."""
    x = _rx(branches, branches)
    args = (TMPL, BINS, 256, 64)
    fft_j = np.asarray(jM.zc_freq_metric(jnp.asarray(x), *args, chunk=chunk))
    fft_t = M.zc_freq_metric(torch.from_numpy(x), *args, chunk=chunk)
    sl_j = np.asarray(jM.zc_freq_metric_sliding(jnp.asarray(x), *args))
    sl_t = M.zc_freq_metric_sliding(torch.from_numpy(x), *args)
    assert fft_t.shape == sl_t.shape == (2100 - 320 + 1,)
    _close(fft_t, fft_j, "fft form")
    _close(sl_t, sl_j, "sliding form")
    _close(sl_t, fft_t.numpy(), "sliding vs fft")
    assert int(torch.argmax(fft_t)) == int(np.argmax(fft_j)) == int(torch.argmax(sl_t)) == 611


def test_short_stream_raises():
    for fn in (M.zc_freq_metric, M.zc_freq_metric_sliding):
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 319, dtype=torch.complex64), TMPL, BINS, 256, 64)


@pytest.mark.parametrize("form", ["fft", "sliding"])
def test_detector_matches_jax(form):
    x = _rx(7)
    j = JZCFreqDetector(SystemParams(**SMALL), chunk=256, form=form).detect(x)
    t = ZCFreqDetector(TSystemParams(**SMALL), chunk=256, form=form).detect(torch.from_numpy(x))
    assert t["detected_cp_start"] == j["detected_cp_start"] == 611
    _close(t["metric"], j["metric"], "metric")
    with pytest.raises(ValueError):
        ZCFreqDetector(form="dft")


@pytest.mark.parametrize("channel", ["cir1", None])
def test_simulation_and_report_match_jax(channel, capsys):
    """cir1: the reference's recorded values; both conditions: the JAX
    pipeline's report, line for line."""
    jr = jzc_freq.run_simulation(channel, None)
    jout = capsys.readouterr().out
    tr = zc_freq.run_simulation(channel, device="cpu")
    assert capsys.readouterr().out.splitlines() == jout.splitlines()
    assert tr["detected_cp_start"] == jr["detected_cp_start"]
    if channel == "cir1":  # tests/test_pipeline_parity.py:96-102
        check_reference(tr, dict(detected_cp_start=1501), 0.2)
        assert abs(tr["cfo_est_hz"] - 77.71) < 0.1
        assert abs(100 * tr["evm_rms"] - 70.47) < 0.2


def test_cli(capsys):
    assert t_main(["zc_freq", "--device", "cpu", "--no-plots"]) == 0
    out = capsys.readouterr().out
    assert "Detected CP start sample: 1501" in out and "Detected CP start sample: 1337" in out
    assert "ALL SIMULATIONS COMPLETE" in out
