"""The plots of the Minn and Minn-RTL simulations and of the CP/FFT demo,
port vs JAX.

* `run_simulation` with plots on (Minn on AWGN, Minn-RTL on cir1): the
  JAX pipeline's prints and PNG file names, the LS CIR plot among them;
* the sweep plots `minn.plot_block_length_comparison` and
  `minn_rtl.plot_q_comparison` at one SNR: the same file names and printed
  lines;
* `cp_fft_demo.main`: the same prints and its two PNGs.

Each package runs in its own temporary directory.
"""

import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu.pipelines import cp_fft_demo as jdemo  # noqa: E402
from ofdm_sync_tpu.pipelines import minn as jminn  # noqa: E402
from ofdm_sync_tpu.pipelines import minn_rtl as jminn_rtl  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import cp_fft_demo, minn, minn_rtl  # noqa: E402
from torch_plots import assert_same_run, run_in  # noqa: E402


def test_minn_plots_match_jax(tmp_path):
    _, _, files = assert_same_run(tmp_path, jminn.run_simulation, minn.run_simulation, None,
                                  "flat_awgn", device="cpu")
    assert {"plots/minn/flat_awgn/ls_cir.png",
            "plots/minn/flat_awgn/minn_energy_thresh.png"} <= set(files)


def test_minn_rtl_plots_match_jax(tmp_path):
    _, _, files = assert_same_run(tmp_path, jminn_rtl.run_simulation, minn_rtl.run_simulation,
                                  "cir1", "measured_channel", device="cpu")
    assert {"plots/minn_rtl/measured_channel/ls_cir.png",
            "plots/minn_rtl/measured_channel/minn_rtl_metric.png"} <= set(files)


@pytest.mark.parametrize("which", ["block_length", "q"])
def test_sweep_plots_match_jax(tmp_path, which):
    """One SNR of each sweep plot, on cir1: the reference's file names."""
    if which == "block_length":
        jfn, tfn = jminn.plot_block_length_comparison, minn.plot_block_length_comparison
        want = "plots/minn/block_length_comparison/measured_channel_block_comparison_snr+5dB.png"
    else:
        jfn, tfn = jminn_rtl.plot_q_comparison, minn_rtl.plot_q_comparison
        want = "plots/minn_rtl/q_comparison/measured_channel_q_comparison_snr+5dB.png"
    _, jlines, jfiles = run_in(tmp_path / "jax", jfn, "cir1", snr_values=(5.0,))
    _, tlines, tfiles = run_in(tmp_path / "port", tfn, "cir1", snr_values=(5.0,), device="cpu")
    assert tfiles == jfiles == [want]
    assert tlines == jlines


def test_cp_fft_demo_plots_match_jax(tmp_path):
    _, jlines, jfiles = run_in(tmp_path / "jax", jdemo.main)
    _, tlines, tfiles = run_in(tmp_path / "port", cp_fft_demo.main, device="cpu")
    assert tfiles == jfiles == ["plots/cp_fft_demo/constellations.png",
                                "plots/cp_fft_demo/phase_slope.png"]
    assert tlines == jlines and tlines[-1] == "Artifacts written to plots/cp_fft_demo/"
    _, lines, files = run_in(tmp_path / "off", cp_fft_demo.main, device="cpu", plots=False)
    assert files == [] and lines == tlines[:-1]
