"""The simulations' plots, port vs JAX: Park, ZC (time domain), ZC
frequency domain and the combined S&C + Minn detector.

Each family runs one channel with plots on, in its own temporary directory
for each package: the port must print the JAX pipeline's lines (with its
"Plots saved to" line) and write the same PNG file names (Schmidl-Cox and
ZC v2 are in tests/test_torch_sc.py and tests/test_torch_zc_pipeline.py;
Minn, Minn-RTL and the CP/FFT demo in tests/test_torch_plots_minn.py).
"""

import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu.pipelines import combined_sc_minn as jcombined  # noqa: E402
from ofdm_sync_tpu.pipelines import park as jpark  # noqa: E402
from ofdm_sync_tpu.pipelines import zc as jzc  # noqa: E402
from ofdm_sync_tpu.pipelines import zc_freq as jzc_freq  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import combined_sc_minn, park, zc, zc_freq  # noqa: E402
from torch_plots import assert_same_run  # noqa: E402

CASES = {
    "park": (jpark, park, None, "park_metric.png"),
    "zc": (jzc, zc, "cir1", "correlation.png"),
    "zc_freq": (jzc_freq, zc_freq, None, "correlation.png"),
    "combined_sc_minn": (jcombined, combined_sc_minn, "cir1", "minn_metric.png"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plots_match_jax(tmp_path, name):
    jmod, tmod, channel, own = CASES[name]
    sub = "measured_channel" if channel else "flat_awgn"
    jr, tr, files = assert_same_run(tmp_path, jmod.run_simulation, tmod.run_simulation,
                                    channel, sub, device="cpu")
    assert f"plots/{name}/{sub}/{own}" in files
    assert f"plots/{name}/{sub}/start_detection.png" in files or name == "zc_v2"
    assert ("plots/" + name + "/" + sub + "/channel_cir.png" in files) == (channel is not None)
    ints = {k: v for k, v in jr.items() if isinstance(v, int)}
    assert {k: tr[k] for k in ints} == ints
