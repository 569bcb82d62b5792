"""Port's receive-side ops shared by the families without a TPU kernel, vs
the JAX package: the CP-based CFO estimators and CIR rebuild of
`ops.estimate`, the NumPy stimulus builders of `ops.waveforms` (bit for
bit, same RNG call order), `batched_qpsk_frames`, `ops.channel.
quantize_int` / `parse_cir_csv`, `pipelines/cp_fft_demo.py` and the CLI
``cp_fft_demo`` and ``list``.

Tolerances: CP correlation profiles within 2e-5 of the peak of |ref|
(float64 window sums here); CFOs within 0.05 Hz + 1e-5 of the CFO at
30.72 MHz (a window of mostly noise gives a large, sensitive angle);
picked offsets equal; the rebuilt CIR within 1e-6 of its peak; the demo's STO
estimates within 0.01 samples.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.ops import channel as jchannel  # noqa: E402
from ofdm_sync_tpu.ops import estimate as jestimate  # noqa: E402
from ofdm_sync_tpu.ops import waveforms as jwaveforms  # noqa: E402
from ofdm_sync_tpu.params import SYS_30M72, SystemParams  # noqa: E402
from ofdm_sync_tpu.pipelines import cp_fft_demo as jdemo  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from ofdm_sync_tpu_torch.ops import channel, estimate, waveforms  # noqa: E402
from ofdm_sync_tpu_torch.params import SYS_30M72 as T_SYS  # noqa: E402
from ofdm_sync_tpu_torch.params import SystemParams as TSystemParams  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import cp_fft_demo  # noqa: E402
from test_torch_sc import _close, no_jax_cache_writes  # noqa: E402,F401

FS = SYS_30M72.sample_rate_hz
N, CP = 256, 64


def _rx(seed=0, cfo_hz=1200.0):
    """Three QPSK symbols with CP (N = 256) after 500 zeros, CFO applied,
    noise at 15 dB, two branches; complex64."""
    rng = np.random.default_rng(seed)
    sys = SystemParams(n_fft=N, cp_len=CP, num_active=150)
    syms = [jwaveforms.build_random_qpsk_symbol(rng, sys)[0] for _ in range(3)]
    x = np.concatenate([np.zeros(500)] + syms + [np.zeros(300)])
    x = x * np.exp(2j * np.pi * cfo_hz * np.arange(x.size) / FS)
    x = np.stack([x, 0.7 * x]) + 0.12 * (rng.standard_normal((2, x.size))
                                           + 1j * rng.standard_normal((2, x.size)))
    return x.astype(np.complex64)


def test_cp_correlation_profile_matches_jax():
    x = _rx()
    _close(estimate.cp_correlation_profile(torch.from_numpy(x), N, CP),
           jestimate.cp_correlation_profile(jnp.asarray(x), N, CP), "P")


def _cfo_close(t, j, what=""):
    assert abs(float(t) - float(j)) < 0.05 + 1e-5 * abs(float(j)), what


@pytest.mark.parametrize("start", [500, 510, 1400, 1600])
def test_cfo_estimators_match_jax(start):
    """Inside the stream, and near its end, where the span bounds are
    empty (the single-window fallback, its second window clamped into the
    stream as JAX's `dynamic_slice` clamps it)."""
    x = _rx()
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for span, win in ((None, None), (16, 24), (0, 1)):
        _cfo_close(estimate.estimate_cfo_from_cp_robust(t, start, N, CP, FS, span, win),
                   jestimate.estimate_cfo_from_cp_robust(j, start, N, CP, FS, span, win),
                   (span, win))
    for span in (None, 40):
        tc, td = estimate.estimate_cfo_from_cp_peak_with_index(t, start, N, CP, FS, span)
        jc, jd = jestimate.estimate_cfo_from_cp_peak_with_index(j, start, N, CP, FS, span)
        assert int(td) == int(jd)
        _cfo_close(tc, jc)
        assert float(estimate.estimate_cfo_from_cp_peak(t, start, N, CP, FS, span)) == float(tc)
    for half in (1024, 30):
        assert estimate.find_cp_start_via_corr(t, start, N, CP, half) == \
            jestimate.find_cp_start_via_corr(j, start, N, CP, half)


def test_cfo_estimate_recovers_the_offset():
    x = torch.from_numpy(_rx(cfo_hz=-2500.0))
    cfo = float(estimate.estimate_cfo_from_cp_robust(x, 500, N, CP, FS))
    assert abs(cfo + 2500.0) < 600.0  # 15 dB: the estimate's own spread


def test_remove_common_phase_and_cir_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(np.complex64)
    ref = (x * np.exp(0.4j)).astype(np.complex64)
    for r in (None, ref):
        tx, tc = estimate.remove_common_phase(torch.from_numpy(x),
                                              None if r is None else torch.from_numpy(r))
        jx, jc = jestimate.remove_common_phase(jnp.asarray(x), None if r is None else jnp.asarray(r))
        assert abs(float(tc) - float(jc)) < 1e-6
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    h = (rng.standard_normal(150) + 1j * rng.standard_normal(150)).astype(np.complex64)
    want = np.asarray(jestimate.reconstruct_cir_from_ls(jnp.asarray(h), N, 150))
    got = estimate.reconstruct_cir_from_ls(torch.from_numpy(h), N, 150).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_builders_equal_jax():
    sys = dict(n_fft=256, cp_len=64, num_active=150)
    js, ts = SystemParams(**sys), TSystemParams(**sys)
    for cp in (True, False):
        np.testing.assert_array_equal(
            waveforms.build_random_bpsk_symbol(np.random.default_rng(1), ts, cp),
            jwaveforms.build_random_bpsk_symbol(np.random.default_rng(1), js, cp))
    for kw in (dict(), dict(rng=np.random.default_rng(4)), dict(subcarrier_value=1 - 1j),
               dict(include_cp=False)):
        a, av = waveforms.build_hermitian_minn_preamble(ts, **kw)
        b, bv = jwaveforms.build_hermitian_minn_preamble(js, **{
            k: (np.random.default_rng(4) if k == "rng" else v) for k, v in kw.items()})
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(av, bv)
    s = np.arange(10.0)
    np.testing.assert_array_equal(waveforms.remove_cyclic_prefix(s, 3), s[3:])
    np.testing.assert_array_equal(waveforms.remove_cyclic_prefix(s, 0), s)


def test_batched_qpsk_frames_are_qpsk_ofdm_symbols():
    g = torch.Generator().manual_seed(0)
    td, vals = waveforms.batched_qpsk_frames(g, 3, T_SYS)
    n, cp = T_SYS.n_fft, T_SYS.cp_len
    assert td.shape == (3, n + cp) and vals.shape == (3, T_SYS.num_active)
    assert td.dtype == vals.dtype == torch.complex64
    np.testing.assert_allclose(np.abs(vals.numpy()), 1.0, rtol=1e-6)
    torch.testing.assert_close(td[:, :cp], td[:, -cp:])
    torch.testing.assert_close((td[:, cp:].abs() ** 2).mean(dim=-1), torch.ones(3))
    used = torch.stack([waveforms.ofdm_fft_used(s[cp:], T_SYS) for s in td])
    scale = used.abs().mean() / vals.abs().mean()
    torch.testing.assert_close(used / scale, vals, atol=1e-4, rtol=0)
    td2, _ = waveforms.batched_qpsk_frames(torch.Generator().manual_seed(0), 3, T_SYS,
                                           include_cp=False)
    torch.testing.assert_close(td2, td[:, cp:])


def test_quantize_int_equals_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 500)) + 1j * rng.standard_normal((2, 500))
    for width in (8, 12):
        for a, b in zip(channel.quantize_int(x, width), jchannel.quantize_int(x, width)):
            np.testing.assert_array_equal(a, b)
    re, im, scale = channel.quantize_int(np.zeros(4, complex), 12)
    assert scale == 1.0 and not re.any() and not im.any()


def test_parse_cir_csv_equals_jax(tmp_path):
    path = tmp_path / "cir.csv"
    path.write_text("delay,re0,im0,re1,im1\n0,1,2,3,4\n1,0.5,nan,5,6\n2,7,8,nan,nan\n"
                    "3,9,10,11,12\n")
    want = jchannel.parse_cir_csv(path)
    np.testing.assert_array_equal(channel.parse_cir_csv(path), want)
    assert want.shape == (2, 3)


def test_cp_fft_demo_matches_jax(capsys):
    t, j = cp_fft_demo.run_demo(device="cpu"), jdemo.run_demo()
    assert abs(t.sto_est_early - j.sto_est_early) < 0.01
    assert abs(t.sto_est_late - j.sto_est_late) < 0.01
    assert round(t.sto_est_early) == 16 and round(t.sto_est_late) == -16
    for key in ("sym0", "sym1", "early", "late"):
        np.testing.assert_allclose(t.spectra[key], j.spectra[key], rtol=0, atol=1e-4)
    assert t_main(["cp_fft_demo", "--device", "cpu", "--no-plots"]) == 0
    out = capsys.readouterr().out
    assert "STO estimate = +16.00 samples" in out and "STO estimate = -16.00 samples" in out


def test_cli_list(capsys):
    assert t_main(["list", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("sc", "minn", "minn_rtl", "park", "zc_freq", "combined_sc_minn",
                 "cp_fft_demo", "model: ParkDetector", "model: CombinedSCMinnDetector"):
        assert name in out
