"""The port's plot artifacts (`ofdm_sync_tpu_torch.utils.report`, the
shared artifacts of `pipelines.common`) against the JAX package's.

Each of the six plotting functions writes its PNG, from tensors as well as
NumPy arrays; `plot_phase_slope` returns JAX's (slope, sto) within 1e-6.
Every test writes under its own temporary directory, never the repo's
committed `plots/`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu.utils import report as jreport  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import common  # noqa: E402
from ofdm_sync_tpu_torch.utils import report  # noqa: E402


def _rng():
    return np.random.default_rng(11)


def _complex(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("shape", [(300,), (1, 300), (2, 300)])
def test_time_series_writes_png(tmp_path, shape):
    x = torch.from_numpy(_complex(_rng(), *shape))
    report.plot_time_series(x, "title", tmp_path / "ts.png")
    assert (tmp_path / "ts.png").stat().st_size > 0


def test_constellation_metric_and_rx_plots_write_png(tmp_path):
    rng = _rng()
    x = _complex(rng, 64)
    report.plot_constellation(torch.from_numpy(x), x[:8], tmp_path / "c.png", "t")
    report.plot_constellation(x, None, tmp_path / "c2.png", "t")
    M = torch.rand(500, generator=torch.Generator().manual_seed(0))
    report.plot_metric(M, tmp_path / "m.png", "t", vlines=[(10, "tab:red", ":", "x")],
                       extra_traces=[(M * 0.5, "half", "--")], spans=[(5, 20, "gate")])
    report.plot_rx_and_metric(torch.from_numpy(_complex(rng, 2, 500)), M.numpy(),
                              tmp_path / "rx.png", "top", "bottom",
                              vlines_top=[(3, "g", "--", "a")],
                              vlines_bottom=[(4, "r", ":", "b")], spans=[(1, 9, "g")])
    report.plot_rx_and_metric(_complex(rng, 500), M, tmp_path / "rx1.png", "top", "bottom")
    for name in ("c", "c2", "m", "rx", "rx1"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0


@pytest.mark.parametrize("cir", [None, "bank"])
def test_ls_cir_writes_png(tmp_path, cir):
    rng = _rng()
    ls = torch.from_numpy(_complex(rng, 2048))
    bank = _complex(rng, 2, 40) if cir else None
    report.plot_ls_cir(ls, bank, 7, -3, tmp_path / "ls.png", "t")
    assert (tmp_path / "ls.png").stat().st_size > 0


@pytest.mark.parametrize("delay", [0, 5, -17])
def test_phase_slope_matches_jax(tmp_path, delay):
    """A used-band channel estimate with a linear phase (a timing offset of
    ``delay`` samples) plus noise: both packages' (slope, sto) agree."""
    n_fft, num_active = 2048, 1200
    rng = np.random.default_rng(delay + 100)
    k = np.arange(num_active) - num_active // 2
    h = np.exp(-2j * np.pi * k * delay / n_fft) * (1 + 0.05 * rng.standard_normal(num_active))
    h = h.astype(np.complex64)
    t = report.plot_phase_slope(torch.from_numpy(h), tmp_path / "p.png", "t", n_fft, num_active)
    j = jreport.plot_phase_slope(h, tmp_path / "pj.png", "t", n_fft, num_active)
    assert (tmp_path / "p.png").stat().st_size > 0
    assert abs(t[0] - j[0]) <= 1e-6 and abs(t[1] - j[1]) <= 1e-6 * max(1.0, abs(j[1]))
    assert abs(t[1] - delay) < 0.5


def test_shared_artifacts(tmp_path, monkeypatch):
    """make_plots_dir under the relative plots/ root; the standard artifacts
    and the LS CIR plot of a CPU setup."""
    monkeypatch.chdir(tmp_path)
    d = common.make_plots_dir("sc", "sub")
    assert d == common.PLOTS_ROOT / "sc" / "sub" and d.is_dir()
    from ofdm_sync_tpu_torch.ops.waveforms import build_sc_preamble

    rng = np.random.default_rng(0)
    setup = common.build_setup(build_sc_preamble(rng), rng, channel_name="cir1",
                               cir_mode="ch1", snr_db=10.0, cfo_hz=1000.0, device="cpu")
    common.emit_standard_artifacts(setup, d, "S&C")
    post = common.post_detection_chain(setup, 2063, d, "S&C")
    common.emit_ls_cir_artifact(setup, post, 540, d, "S&C")
    assert sorted(p.name for p in d.iterdir()) == [
        "channel_cir.png", "constellation.png", "ls_cir.png", "phase_slope_sto.png",
        "rx_frame_time.png", "tx_frame_time.png"]
    off = common.post_detection_chain(setup, 2063)
    assert (off.slope_rad_per_bin, off.timing_offset_samples) == (
        post.slope_rad_per_bin, post.timing_offset_samples)
