"""Port's combined S&C + Minn family (D8) vs the JAX package and the
reference: `ops.metrics.sc_generic_metric`, `CombinedSCMinnDetector`
(the peak in the S&C gate's first segment, and the fallback seed at the
strongest S&C sample where the gate is empty), `pipelines/
combined_sc_minn.py` and the CLI ``combined_sc_minn``.

Tolerances: metric arrays within 2e-5 of the peak of |ref|; peaks and gate
masks equal.  The cir1 simulation reproduces
tests/test_pipeline_parity.py:127-135, and both conditions print the JAX
pipeline's report line for line.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.models.detectors import CombinedSCMinnDetector as JDetector  # noqa: E402
from ofdm_sync_tpu.ops import metrics as jM  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_minn_preamble  # noqa: E402
from ofdm_sync_tpu.params import SystemParams  # noqa: E402
from ofdm_sync_tpu.pipelines import combined_sc_minn as jcombined  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import CombinedSCMinnDetector  # noqa: E402
from ofdm_sync_tpu_torch.ops import metrics as M  # noqa: E402
from ofdm_sync_tpu_torch.params import SystemParams as TSystemParams  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import combined_sc_minn  # noqa: E402
from test_torch_sc import _close, check_reference, no_jax_cache_writes  # noqa: E402,F401

SMALL = dict(n_fft=256, cp_len=64, num_active=150, tx_pre_pad=300)


def _rx(seed, L=3000, positions=(900,), amps=(1.0,)):
    rng = np.random.default_rng(seed)
    pre = build_minn_preamble(np.random.default_rng(seed), SystemParams(**SMALL))
    x = 0.3 * (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L)))
    for pos, a in zip(positions, amps):
        x[:, pos:pos + pre.size] += a * pre
    return x.astype(np.complex64)


@pytest.mark.parametrize("symbol_len", [256, 100])
def test_sc_generic_metric_matches_jax(symbol_len):
    x = _rx(symbol_len)
    for t, j, what in zip(M.sc_generic_metric(torch.from_numpy(x), symbol_len),
                          jM.sc_generic_metric(jnp.asarray(x), symbol_len), "MPR"):
        _close(t, j, what)
    assert all(t.shape == (0,) for t in M.sc_generic_metric(torch.from_numpy(x[:, :50]), 100))


@pytest.mark.parametrize("case", ["one", "two_gates", "empty_gate"])
def test_detector_matches_jax(case):
    """One preamble; two preambles, the weaker first (the peak must come
    from the first gate segment, not the strongest); an all-zero stream (an
    empty gate, seeded at the strongest S&C sample)."""
    if case == "one":
        x = _rx(1)
    elif case == "two_gates":
        x = _rx(2, positions=(700, 1900), amps=(0.9, 1.0))
    else:
        x = np.zeros((2, 3000), np.complex64)
    sys = SystemParams(**SMALL)
    j = JDetector(sys, smooth_win=8).detect(x)
    t = CombinedSCMinnDetector(TSystemParams(**SMALL), smooth_win=8).detect(torch.from_numpy(x))
    assert t["peak"] == j["peak"]
    np.testing.assert_array_equal(t["sc_gate_mask"], np.asarray(j["sc_gate_mask"]))
    for key in ("M_minn", "M_sc", "sc_norm", "M_smooth"):
        _close(t[key], j[key], key)
    if case == "two_gates":
        assert t["peak"] < 1500
    if case == "empty_gate":
        assert t["sc_gate_mask"].sum() == 1 and t["sc_gate_mask"][0]


@pytest.mark.parametrize("channel", ["cir1", None])
def test_simulation_and_report_match_jax(channel, capsys):
    jr = jcombined.run_simulation(channel, None)
    jout = capsys.readouterr().out
    tr = combined_sc_minn.run_simulation(channel, device="cpu")
    assert capsys.readouterr().out.splitlines() == jout.splitlines()
    assert tr["peak"] == jr["peak"]
    if channel == "cir1":  # tests/test_pipeline_parity.py:127-135
        check_reference(tr, dict(peak=2064, timing_error=115, cfo_est_hz=1082.82,
                                 evm_pct=66.73))


def test_cli(capsys):
    assert t_main(["combined_sc_minn", "--device", "cpu", "--no-plots"]) == 0
    out = capsys.readouterr().out
    assert "Detected Minn peak at d=2064" in out and "S&C gate window" in out
    assert "ALL SIMULATIONS COMPLETE" in out
