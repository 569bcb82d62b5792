"""Port's ZC simulations (`pipelines/zc.py`, `pipelines/zc_v2.py`) and
`post_detection_chain` vs the reference and the JAX package.

The expected values are the reference scripts' own printed results, as
tests/test_pipeline_parity.py:78-125 records them (seed 0, cir1 and flat
AWGN); the stimulus replays the reference's RNG order, so indices and
event counts must be equal, CFO within 0.05 Hz and EVM within 0.15
percentage points (the tolerances of that file).  The port's printed
report must equal the JAX pipeline's line for line.  `post_detection_chain`
runs on the JAX-built and the port-built stimulus of one seed (the two
agree within 1e-5: the cir1 FIR is a complex64 FFT convolution in both,
rounded in another order): CFO within 0.01 Hz, phase slope within 1e-5
rad/bin, EVM and gain within 1e-4 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu.ops.waveforms import build_pss_symbol as j_pss  # noqa: E402
from ofdm_sync_tpu.params import SYS_30M72  # noqa: E402
from ofdm_sync_tpu.pipelines import common as jcommon  # noqa: E402
from ofdm_sync_tpu.pipelines import zc as jzc  # noqa: E402
from ofdm_sync_tpu.pipelines import zc_v2 as jzc_v2  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import common, zc, zc_v2  # noqa: E402
from torch_plots import assert_same_run  # noqa: E402

# tests/test_pipeline_parity.py:78-125: (module, channel) -> reference values
REFERENCE = {
    ("zc", "cir1"): dict(peak_index=3548, detected_start=1501, cfo_est_hz=1040.57,
                         evm_pct=67.88),
    ("zc", None): dict(peak_index=3384, timing_error=0, cfo_est_hz=993.62, evm_pct=30.91),
    ("zc_v2", "cir1"): dict(num_events=3, peak_index=3549, detected_start=1502,
                            cfo_est_hz=1047.41, evm_pct=75.29),
    ("zc_v2", None): dict(num_events=3, peak_index=3384, detected_start=1337, timing_error=0),
}
MODULES = {"zc": (zc, jzc), "zc_v2": (zc_v2, jzc_v2)}


@pytest.mark.parametrize("name,channel", list(REFERENCE))
def test_simulation_reproduces_reference(name, channel, capsys):
    r = MODULES[name][0].run_simulation(channel, device="cpu")
    out = capsys.readouterr().out
    for key, want in REFERENCE[(name, channel)].items():
        if key == "cfo_est_hz":
            assert abs(r[key] - want) < 0.05, key
        elif key == "evm_pct":
            assert abs(100 * r["evm_rms"] - want) < 0.15, key
        else:
            assert r[key] == want, key
    assert "Carrier Frequency Offset:" in out and "EVM RMS:" in out


@pytest.mark.parametrize("name,channel", [("zc", "cir1"), ("zc_v2", None)])
def test_report_matches_jax(name, channel, capsys):
    tmod, jmod = MODULES[name]
    jr = jmod.run_simulation(channel, None)
    jout = capsys.readouterr().out
    tr = tmod.run_simulation(channel, device="cpu")
    tout = capsys.readouterr().out
    assert tout.splitlines() == jout.splitlines()
    assert tr["peak_index"] == jr["peak_index"]
    assert tr["detected_start"] == jr["detected_start"]


@pytest.mark.parametrize("channel,start", [("cir1", 1501), (None, 1337), ("cir1", 1437)])
def test_post_detection_chain_matches_jax(channel, start):
    pss = j_pss(SYS_30M72)
    kw = dict(channel_name=channel, cir_mode="two", snr_db=10.0, cfo_hz=1000.0)
    jsetup = jcommon.build_setup(pss, np.random.default_rng(0), **kw)
    tsetup = common.build_setup(pss, np.random.default_rng(0), **kw)
    np.testing.assert_allclose(tsetup.rx.numpy(), jsetup.rx, rtol=0, atol=1e-5)
    jp = jcommon.post_detection_chain(jsetup, start, None, "ZC")
    tp = common.post_detection_chain(tsetup, start)
    assert abs(tp.cfo_est_hz - jp.cfo_est_hz) < 0.01
    assert abs(tp.slope_rad_per_bin - jp.slope_rad_per_bin) < 1e-5
    assert abs(tp.timing_offset_samples - jp.timing_offset_samples) < 1e-5 * 2048
    assert abs(tp.evm_rms - jp.evm_rms) <= 1e-4 * jp.evm_rms
    assert abs(tp.gain - jp.gain) <= 1e-4 * abs(jp.gain)
    np.testing.assert_allclose(tp.h_est, jp.h_est, rtol=0, atol=1e-4 * np.abs(jp.h_est).max())
    assert tp.xhat_aligned.shape == jp.xhat_aligned.shape == (SYS_30M72.num_active,)


def test_plots_match_jax(tmp_path):
    """With plots on, the port prints the JAX pipeline's lines (its "Plots
    saved to" line included) and writes the same PNG files, the correlation
    zoom among them."""
    _, _, files = assert_same_run(tmp_path, jzc_v2.run_simulation, zc_v2.run_simulation, "cir1",
                                  "measured_channel", device="cpu")
    assert "plots/zc_v2/measured_channel/correlation_zoom.png" in files and len(files) == 7


def test_cli_runs_both_simulations(capsys):
    assert t_main(["zc_v2", "--device", "cpu", "--no-plots"]) == 0
    out = capsys.readouterr().out
    assert "ZC V2 DETECTION RESULTS - FLAT AWGN" in out and "MEASURED CIR 'CIR1'" in out
    assert "<- PRIMARY" in out and "ALL SIMULATIONS COMPLETE" in out
    assert t_main(["zc", "--device", "cpu", "--no-plots"]) == 0
    assert "Matched filter peak index: 3548" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # --help: the device flag says where the kernels run
        t_main(["zc_v2", "--help"])
    assert "--device" in (help_text := capsys.readouterr().out) and "detect_fused" in help_text
