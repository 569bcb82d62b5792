"""The [A][A] grid test's entry points, port vs JAX: `main()` (the PAPR
report, the preamble and metric plots, the serial grid, its summary, the
heatmap), `run_grid_test(plot_samples=True)` / `run_single_test(plot=True)`
and the CLI ``aa``.

The 135-config grid is swapped for a small one with `monkeypatch`, in both
packages alike.  Each package runs in its own temporary directory: the
printed lines and the PNG file names must be equal.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu.pipelines import aa as jaa  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import aa  # noqa: E402
from torch_plots import run_in  # noqa: E402

SMALL = dict(snr_values=(0, 15), channels=(None, "cir1"), full_scale_ratios=(1.0,),
             preamble_lengths=(1024,))


@pytest.fixture
def small_grid(monkeypatch):
    monkeypatch.setattr(jaa, "run_grid_test", functools.partial(jaa.run_grid_test, **SMALL))
    monkeypatch.setattr(aa, "run_grid_test", functools.partial(aa.run_grid_test, **SMALL))


def test_main_matches_jax(tmp_path, small_grid):
    _, jlines, jfiles = run_in(tmp_path / "jax", jaa.main)
    _, tlines, tfiles = run_in(tmp_path / "port", aa.main, device="cpu")
    assert tfiles == jfiles == sorted(f"plots/sync_aa/{n}.png" for n in (
        "preamble_design", "metric_zoom_no_noise", "plateau_vs_peak_comparison",
        "detection_heatmap"))
    assert tlines == jlines
    assert "L=512: PAPR=3.69 dB, [A][A] corr=1.000" in tlines
    _, off_lines, off_files = run_in(tmp_path / "off", aa.main, device="cpu", plots=False)
    assert off_files == [] and off_lines == tlines


def test_sample_plots_match_jax(tmp_path):
    kw = dict(snr_values=(10,), channels=("cir1",), full_scale_ratios=(1.0, 2.0),
              preamble_lengths=(1024,), plot_samples=True)
    jr, jlines, jfiles = run_in(tmp_path / "jax", jaa.run_grid_test, **kw)
    tr, tlines, tfiles = run_in(tmp_path / "port", aa.run_grid_test, **kw, device="cpu")
    assert tfiles == jfiles == ["plots/sync_aa/cir1/cir1_snr+10dB_fs1.00.png",
                                "plots/sync_aa/cir1/cir1_snr+10dB_fs1.00_L512.png"]
    assert tlines == jlines
    assert [(r.detected, r.timing_error, r.num_events) for r in tr] == [
        (r.detected, r.timing_error, r.num_events) for r in jr]


def test_single_test_plot_when_missed(tmp_path):
    """A config that misses (-5 dB, L = 128) still writes its view, under
    the L-suffixed name only."""
    r = aa.run_single_test(-5.0, None, 1.0, preamble_length=256, plot=True,
                           plot_dir=tmp_path, device="cpu")
    assert not r.detected
    assert sorted(p.name for p in tmp_path.iterdir()) == ["awgn_snr-5dB_fs1.00_L128.png"]


def test_cli_aa(tmp_path, monkeypatch, small_grid, capsys):
    monkeypatch.chdir(tmp_path)
    assert t_main(["aa", "--device", "cpu", "--no-plots"]) == 0
    out = capsys.readouterr().out
    assert "[A][A] PREAMBLE SYNCHRONIZATION - GRID TEST" in out and "Total tests: 4" in out
    assert "DETECTION RATE BY PREAMBLE LENGTH AND CHANNEL" in out
    assert not (tmp_path / "plots").exists()
    assert t_main(["aa", "--device", "cpu"]) == 0
    assert (tmp_path / "plots" / "sync_aa" / "detection_heatmap.png").exists()
