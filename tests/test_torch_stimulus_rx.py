"""Port vs JAX: stimulus, channel, frame re-emission and the receive
stages (`ops.waveforms`, `ops.channel`, `pipelines.common`, `ops.extract`,
`ops.estimate`).

Host NumPy builders must agree exactly (same RNG call order).  Complex64
FFT and CFO results agree within 1e-5 (absolute, on unit-power signals):
PyTorch and XLA factor their FFTs differently.  The scalar CFO estimate
agrees within 0.05 Hz, EVM within 1e-4 of its value.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.ops import channel as jch  # noqa: E402
from ofdm_sync_tpu.ops import estimate as jest  # noqa: E402
from ofdm_sync_tpu.ops import waveforms as jw  # noqa: E402
from ofdm_sync_tpu.ops.detect import extract_gate_events as j_extract  # noqa: E402
from ofdm_sync_tpu.ops.extract import extract_frames as j_frames  # noqa: E402
from ofdm_sync_tpu.pipelines import common as jcommon  # noqa: E402
from ofdm_sync_tpu_torch.ops import channel as tch  # noqa: E402
from ofdm_sync_tpu_torch.ops import estimate as t_est  # noqa: E402
from ofdm_sync_tpu_torch.ops import waveforms as tw  # noqa: E402
from ofdm_sync_tpu_torch.ops.detect import GateEvents  # noqa: E402
from ofdm_sync_tpu_torch.ops.extract import extract_frames, extract_frames_batched  # noqa: E402
from ofdm_sync_tpu_torch.params import MinnRTLParams, SYS_30M72  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import common as tcommon  # noqa: E402

ATOL = 1e-5


def _c64(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("seq_type", ["qpsk_freq", "bpsk_freq", "zc_time", "gold"])
def test_preamble_builders_exact(seq_type):
    a = jw.build_minn_rtl_preamble(seq_type, np.random.default_rng(3), Q=512)
    b = tw.build_minn_rtl_preamble(seq_type, np.random.default_rng(3), Q=512)
    np.testing.assert_array_equal(a, b)
    s1, v1 = jw.build_random_qpsk_symbol(np.random.default_rng(4))
    s2, v2 = tw.build_random_qpsk_symbol(np.random.default_rng(4))
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(v1, v2)


def test_channel_helpers_exact():
    for name in ("cir1", "cir2"):
        np.testing.assert_array_equal(tch.load_measured_cir(name), jch.load_measured_cir(name))
        cir = tcommon.select_cir(name, "two")
        np.testing.assert_array_equal(cir, jcommon.select_cir(name, "two"))
        assert tch.compute_channel_peak_offset(cir) == jch.compute_channel_peak_offset(cir)
    with pytest.raises(ValueError):
        tch.load_measured_cir("bogus")
    sig = _c64(np.random.default_rng(5), (2, 300))
    np.testing.assert_array_equal(
        tch.awgn_noise_host(sig, 10.0, np.random.default_rng(6)),
        jch.awgn_noise_host(sig, 10.0, np.random.default_rng(6)))


@pytest.mark.parametrize("cfo,L", [(1000.0, 5000), (-733.3, 70000)])
def test_apply_cfo(cfo, L, rng):
    x = _c64(rng, (2, L))
    out = tch.apply_cfo(torch.from_numpy(x), cfo, 30.72e6).numpy()
    ref = np.asarray(jch.apply_cfo(jnp.asarray(x), cfo, 30.72e6))
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL * 4)


def test_apply_cir_and_fft_used(rng):
    sig = _c64(rng, 4000)
    cir = jcommon.select_cir("cir1", "two")
    np.testing.assert_allclose(tch.apply_cir(sig, cir).numpy(),
                               np.asarray(jch.apply_cir(sig, cir)), rtol=0, atol=ATOL)
    sym = _c64(rng, 2048)
    np.testing.assert_allclose(tw.ofdm_fft_used(torch.from_numpy(sym)).numpy(),
                               np.asarray(jw.ofdm_fft_used(jnp.asarray(sym))),
                               rtol=0, atol=ATOL * 50)  # unnormalized 2048-pt FFT


@pytest.mark.parametrize("channel,snr", [(None, 30.0), ("cir1", 0.0)])
def test_build_setup_matches_jax(channel, snr):
    Q = MinnRTLParams().quarter_len
    kw = dict(channel_name=channel, cir_mode="two", snr_db=snr, cfo_hz=1000.0,
              two_frames=True)
    pre_j = jw.build_minn_rtl_preamble("qpsk_freq", np.random.default_rng(0), Q=Q)
    ref = jcommon.build_setup(pre_j, np.random.default_rng(1), **kw)
    out = tcommon.build_setup(pre_j, np.random.default_rng(1), **kw)
    assert out.rx.dtype == torch.complex64 and out.rx.shape == ref.rx.shape
    np.testing.assert_allclose(out.rx.numpy(), ref.rx, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(out.tx, ref.tx)
    np.testing.assert_array_equal(out.data_used, ref.data_used)
    assert out.channel_peak_offset == ref.channel_peak_offset
    assert out.extras == ref.extras


def _table(rng, n=4000, E=6):
    above = rng.random(n) < 0.01
    track = rng.standard_normal(n).astype(np.float32)
    return j_extract(jnp.asarray(above), jnp.asarray(track), hysteresis=2, max_events=E)


@pytest.mark.parametrize("max_frames,offset", [(4, 0), (2, -300), (8, 250)])
def test_extract_frames_matches_jax(rng, max_frames, offset):
    iq = rng.standard_normal((4, 4000)).astype(np.float32)
    jt = _table(rng)
    kw = dict(frame_len=700, timing_offset=offset, max_frames=max_frames)
    rf, rs, rv = j_frames(jnp.asarray(iq), jt, **kw)
    of, os_, ov = extract_frames(torch.from_numpy(iq), GateEvents.from_numpy(jt), **kw)
    np.testing.assert_array_equal(of.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(os_.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))


def test_extract_frames_batched_rows(rng):
    iq = rng.standard_normal((3, 2, 3000)).astype(np.float32)
    tabs = [GateEvents.from_numpy(_table(rng, 3000)) for _ in range(3)]
    table = GateEvents(*(torch.stack([getattr(t, f) for t in tabs]) for f in GateEvents._fields))
    fb, sb, vb = extract_frames_batched(torch.from_numpy(iq), table, frame_len=500)
    for i in range(3):
        f1, s1, v1 = extract_frames(torch.from_numpy(iq[i]), tabs[i], frame_len=500)
        assert torch.equal(fb[i], f1) and torch.equal(sb[i], s1) and torch.equal(vb[i], v1)


def test_receive_stages_match_jax(rng):
    """CP-CFO -> CFO correction -> LS -> EQ -> gain -> EVM on one frame."""
    sys_p = SYS_30M72
    n_fft, cp, fs = sys_p.n_fft, sys_p.cp_len, sys_p.sample_rate_hz
    setup = jcommon.build_setup(
        jw.build_minn_rtl_preamble("qpsk_freq", np.random.default_rng(0), Q=512),
        np.random.default_rng(0), channel_name=None, cir_mode="two", snr_db=20.0,
        cfo_hz=800.0)
    ants = np.array(setup.rx[:, sys_p.tx_pre_pad: sys_p.tx_pre_pad + setup.extras["frame_len"]])
    pilot_cp = 5 * 512
    cfo_j = float(jest.estimate_cfo_from_cp(jnp.asarray(ants), pilot_cp, n_fft, cp, fs))
    cfo_t = float(t_est.estimate_cfo_from_cp(torch.from_numpy(ants), pilot_cp, n_fft, cp, fs))
    assert abs(cfo_j - cfo_t) < 0.05

    comb_j = np.asarray(jch.apply_cfo(jnp.asarray(ants), -cfo_j, fs)).mean(axis=0)
    comb_t = tch.apply_cfo(torch.from_numpy(ants), -cfo_j, fs).mean(dim=0)
    p0, d0 = pilot_cp + cp, pilot_cp + 2 * cp + n_fft
    yp_j = jw.ofdm_fft_used(jnp.asarray(comb_j[p0: p0 + n_fft]))
    yd_j = jw.ofdm_fft_used(jnp.asarray(comb_j[d0: d0 + n_fft]))
    yp_t = tw.ofdm_fft_used(comb_t[p0: p0 + n_fft])
    yd_t = tw.ofdm_fft_used(comb_t[d0: d0 + n_fft])
    pu = setup.pilot_used.astype(np.complex64)
    du = setup.data_used.astype(np.complex64)
    h_j = jest.ls_channel_estimate(yp_j, jnp.asarray(pu))
    h_t = t_est.ls_channel_estimate(yp_t, torch.from_numpy(pu))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-4)
    al_j, g_j = jest.align_complex_gain(jest.equalize(yd_j, h_j), jnp.asarray(du))
    al_t, g_t = t_est.align_complex_gain(t_est.equalize(yd_t, h_t), torch.from_numpy(du))
    assert abs(complex(g_j) - complex(g_t)) < 1e-4
    e_j, db_j = jest.evm_rms_db(al_j, jnp.asarray(du))
    e_t, db_t = t_est.evm_rms_db(al_t, torch.from_numpy(du))
    assert abs(float(e_j) - float(e_t)) <= 1e-4 * float(e_j)
    assert abs(float(db_j) - float(db_t)) < 1e-3
    assert float(e_t) < 0.2  # 20 dB SNR: EVM near the noise floor
