"""Port's fused ZC kernels (#7 `zc_cfar_detect`, #8/#9 `zc_iq_cfar_detect`,
#10 `matched_filter_ols`) vs the JAX TPU kernels.

On the CPU the port's wrappers run the plain versions of kernels D, B and E;
the JAX side runs `pallas_zc.py`, `pallas_zc_tm.py` and `pallas_mf.py` in
Pallas interpret mode.  Stimuli follow tests/test_pallas_zc.py (the
`SystemParams(n_fft=256, num_active=144, cp_len=64)` detector, a PSS
symbol at 1.0 / 0.7 on two branches in noise of amplitude 0.05).
Tolerances: event tables equal field by field, ``peak_value`` within 1e-4
of the largest peak (JAX sums its windows in float32, the port in float64,
as tests/test_pallas_zc.py holds JAX's own paths to each other); the
matched filter within 1e-5 of the output peak against
`matched_filter_mxu(precision="highest")`.  The CUDA kernels themselves are
held to the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels.pallas_mf import LANES, S_ROWS, matched_filter_mxu  # noqa: E402
from ofdm_sync_tpu.kernels.pallas_zc import (  # noqa: E402
    zc_cfar_detect_pallas,
    zc_iq_cfar_detect_pallas,
)
from ofdm_sync_tpu.kernels.pallas_zc_tm import zc_iq_cfar_detect_tm_planar  # noqa: E402
from ofdm_sync_tpu.models.detectors import ZCStreamingDetector as JDetector  # noqa: E402
from ofdm_sync_tpu.ops import metrics as JM  # noqa: E402
from ofdm_sync_tpu.params import SystemParams, ZCParams  # noqa: E402
from ofdm_sync_tpu_torch.kernels import matched_filter as MF  # noqa: E402
from ofdm_sync_tpu_torch.kernels import zc_fused as Z  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import launch_counts, reset_launch_counts  # noqa: E402
from ofdm_sync_tpu_torch.kernels.streaming import zc_cfar_planar, zc_iq_planar  # noqa: E402
from ofdm_sync_tpu_torch.ops.detect import extract_gate_events  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402

SMALL = SystemParams(n_fft=256, num_active=144, cp_len=64)
PEAK_RTOL = 1e-4
MF_RTOL = 1e-5


@pytest.fixture(scope="module")
def jdet():
    return JDetector(sys=SMALL, zc=ZCParams())


def _cfar_kw(det):
    p = det.params
    return dict(corr_window=p.corr_window, threshold_value=p.threshold_value,
                threshold_frac_bits=p.threshold_frac_bits, min_corr_mag=p.min_corr_mag)


def _event_kw(det):
    return dict(hysteresis=det.params.hysteresis, max_events=det.max_events)


def _rx(det, rng, L=6000, positions=(1800,)):
    """tests/test_pallas_zc.py:_stimulus, with any number of preambles."""
    ref = det.reference_waveform()
    sig = np.zeros(L, complex)
    for pos in positions:
        sig[pos: pos + ref.size] = ref
    rx = np.stack([sig, 0.7 * sig])
    return rx + 0.05 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))


def _mf_iq(det, rx):
    """Planar (4, Lc) matched-filter rows and (4, L) float32 IQ rows, and
    the template's length and norm, as tests/test_pallas_zc.py builds them."""
    ref = jnp.asarray(det.reference_waveform(), jnp.complex64)
    mf = np.asarray(JM.matched_filter(jnp.asarray(rx, jnp.complex64), ref))
    mf_p = np.stack([p for b in range(2) for p in (mf[b].real, mf[b].imag)]).astype(np.float32)
    iq_p = np.stack([p for b in range(2) for p in (rx[b].real, rx[b].imag)]).astype(np.float32)
    return mf_p, iq_p, int(ref.shape[-1]), float(jnp.sqrt(jnp.sum(jnp.abs(ref) ** 2)))


def test_cfar_detect_matches_pallas(jdet, rng):
    """#7 on one stream, L off the block size."""
    rx = _rx(jdet, rng)
    corr_mag = np.array(jdet._detect_jit(jnp.asarray(rx))[1])
    jt = zc_cfar_detect_pallas(jnp.asarray(corr_mag), **_cfar_kw(jdet), **_event_kw(jdet),
                               block=1024)
    mag = torch.from_numpy(corr_mag)
    tt = Z.zc_cfar_detect(mag, **_cfar_kw(jdet), **_event_kw(jdet))
    assert_tables_equal(jt, tt, "zc_cfar_detect", peak_rtol=PEAK_RTOL)
    assert int(tt.count) >= 1 and tt.peak_idx.shape == (16,)
    plain = extract_gate_events(zc_cfar_planar(mag, **_cfar_kw(jdet)), mag, valid_from=2048,
                                **_event_kw(jdet))
    assert_tables_equal(tt, plain, "plain D + B")


def test_cfar_detect_batched_two_preambles(jdet, rng):
    """Three streams with two preambles each (tests/test_pallas_zc.py:77)."""
    mags = [np.array(jdet._detect_jit(jnp.asarray(
        _rx(jdet, rng, L=9000, positions=(2600 + 300 * b, 6200 + 300 * b))))[1])
        for b in range(3)]
    jt = zc_cfar_detect_pallas(jnp.asarray(np.stack(mags)), **_cfar_kw(jdet),
                               **_event_kw(jdet), block=2048)
    tt = Z.zc_cfar_detect(torch.from_numpy(np.stack(mags)), **_cfar_kw(jdet), **_event_kw(jdet))
    assert_tables_equal(jt, tt, "batched", peak_rtol=PEAK_RTOL)
    assert (tt.count >= 2).all()


def test_iq_cfar_detect_matches_both_pallas_kernels(jdet, rng):
    """#8 (lane-major) and #9 (time-major) on one stream; the plain D + B
    composition equals the wrapper."""
    mf, iq, R, ref_norm = _mf_iq(jdet, _rx(jdet, rng))
    kw = dict(ref_len=R, ref_norm=ref_norm, **_cfar_kw(jdet), **_event_kw(jdet))
    j8 = zc_iq_cfar_detect_pallas(jnp.asarray(mf)[:, None], jnp.asarray(iq)[:, None], **kw,
                                  block=1024)
    j9 = zc_iq_cfar_detect_tm_planar(jnp.asarray(mf)[:, None], jnp.asarray(iq)[:, None], **kw,
                                     rows=1024)
    mf_t, iq_t = torch.from_numpy(mf)[:, None], torch.from_numpy(iq)[:, None]
    tt = Z.zc_iq_cfar_detect(mf_t, iq_t, **kw)
    assert_tables_equal(j8, tt, "vs zc_iq_cfar_detect_pallas", peak_rtol=PEAK_RTOL)
    assert_tables_equal(j9, tt, "vs zc_iq_cfar_detect_tm_planar", peak_rtol=PEAK_RTOL)
    mag, above = zc_iq_planar(mf_t, iq_t, ref_len=R, ref_norm=ref_norm, **_cfar_kw(jdet))
    assert_tables_equal(tt, extract_gate_events(above, mag, valid_from=2048, **_event_kw(jdet)),
                        "plain D + B")
    assert int(tt.count[0]) >= 1


def test_iq_cfar_detect_batched(jdet, rng):
    """Three streams, two preambles each, L = 9000 (no block multiple)."""
    parts = [_mf_iq(jdet, _rx(jdet, rng, L=9000, positions=(2600 + 300 * b, 6200 + 300 * b)))
             for b in range(3)]
    mf = np.stack([p[0] for p in parts], axis=1)
    iq = np.stack([p[1] for p in parts], axis=1)
    kw = dict(ref_len=parts[0][2], ref_norm=parts[0][3], **_cfar_kw(jdet), **_event_kw(jdet))
    jt = zc_iq_cfar_detect_pallas(jnp.asarray(mf), jnp.asarray(iq), **kw, block=2048)
    tt = Z.zc_iq_cfar_detect(torch.from_numpy(mf), torch.from_numpy(iq), **kw)
    assert_tables_equal(jt, tt, "batched", peak_rtol=PEAK_RTOL)
    assert (tt.count >= 2).all()


def test_iq_int16_codes_match_tm_kernel(jdet, rng):
    """int16 ADC codes go in as they are (JAX's time-major kernel takes the
    same codes); the table equals the port's float32 run exactly."""
    _, iq, R, ref_norm = _mf_iq(jdet, _rx(jdet, rng))
    iq16 = np.clip(np.round(iq * (1024.0 / np.abs(iq).max())), -2048, 2047).astype(np.int16)
    rx_q = (iq16[0::2] + 1j * iq16[1::2].astype(np.float32)).astype(np.complex64)
    mf, _, _, _ = _mf_iq(jdet, rx_q)
    kw = dict(ref_len=R, ref_norm=ref_norm, **_cfar_kw(jdet), **_event_kw(jdet))
    jt = zc_iq_cfar_detect_tm_planar(jnp.asarray(mf)[:, None],
                                     jnp.asarray(iq16.astype(np.float32))[:, None], **kw,
                                     rows=1024)
    mf_t = torch.from_numpy(mf)[:, None]
    t16 = Z.zc_iq_cfar_detect(mf_t, torch.from_numpy(iq16)[:, None], **kw)
    t32 = Z.zc_iq_cfar_detect(mf_t, torch.from_numpy(iq16.astype(np.float32))[:, None], **kw)
    assert_tables_equal(jt, t16, "int16 vs tm kernel", peak_rtol=PEAK_RTOL)
    assert_tables_equal(t32, t16, "int16 vs float32")
    assert int(t16.count[0]) >= 1


def test_zc_metric_modes_and_zero_signal():
    """Magnitude mode returns its input as mag; a zero IQ stream gives a
    finite zero magnitude and no event."""
    x = torch.rand((2, 5000))
    o = Z.zc_metric(x)
    assert o.mag is x and o.above.dtype == torch.bool and o.above.shape == x.shape
    mf = torch.zeros((4, 3, 3000))
    iq = torch.zeros((4, 3, 2745), dtype=torch.int16)
    o = Z.zc_metric(mf, iq, ref_len=256, ref_norm=16.0)
    assert torch.isfinite(o.mag).all() and float(o.mag.abs().max()) == 0.0
    assert not bool(o.above.any())
    assert int(Z.zc_iq_cfar_detect(mf, iq, ref_len=256, ref_norm=16.0).count.sum()) == 0


def test_short_stream_has_no_event():
    """Shorter than the CFAR window: never valid (n >= W)."""
    x = torch.ones((1, 2000))
    assert int(Z.zc_cfar_detect(x, min_corr_mag=0.0).count.sum()) == 0


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        Z.zc_metric(torch.zeros((3, 2, 100)), torch.zeros((3, 2, 100)), ref_len=8, ref_norm=1.0)
    with pytest.raises(ValueError):  # IQ mode needs the template's length and norm
        Z.zc_metric(torch.zeros((4, 2, 100)), torch.zeros((4, 2, 100)))
    with pytest.raises(TypeError):
        Z.zc_metric(torch.zeros((4, 2, 100)), torch.zeros((4, 2, 100), dtype=torch.float64),
                    ref_len=8, ref_norm=1.0)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent path
        Z.zc_metric(torch.zeros((2, 100), device="meta"))
    with pytest.raises(ValueError):
        MF.matched_filter_ols(torch.zeros((4, 1, 100)), np.ones(MF.MAX_TAPS + 1, np.complex64))
    with pytest.raises(ValueError):
        MF.matched_filter_ols(torch.zeros((3, 1, 100)), np.ones(8, np.complex64))
    assert Z.default_threshold(2048) == 64
    # two float64 power rings and a float32 magnitude ring, 3072 entries each
    assert Z.smem_bytes(2048, 2048, 2) == 61_440


def test_cpu_path_counts_no_launch(jdet, rng):
    reset_launch_counts()
    mf, iq, R, ref_norm = _mf_iq(jdet, _rx(jdet, rng))
    Z.zc_iq_cfar_detect(torch.from_numpy(mf)[:, None], torch.from_numpy(iq)[:, None],
                        ref_len=R, ref_norm=ref_norm)
    MF.matched_filter_ols(torch.from_numpy(iq)[:, None], np.ones(62, np.complex64))
    assert set(launch_counts().values()) == {0}


def _check_mf(x, taps, **kw):
    y = MF.matched_filter_ols(torch.from_numpy(x), taps, **kw).numpy()
    want = np.asarray(matched_filter_mxu(jnp.asarray(x), taps, precision="highest",
                                         interpret=True, **kw))
    assert y.shape == want.shape
    np.testing.assert_allclose(y, want, rtol=0, atol=MF_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("T", [62, 2048, 2049])
def test_matched_filter_tap_lengths(rng, T):
    taps = (rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(np.complex64)
    _check_mf(rng.standard_normal((4, 2, 17000)).astype(np.float32), taps)


@pytest.mark.parametrize("L", [S_ROWS * LANES - 1, S_ROWS * LANES, S_ROWS * LANES + 1,
                               2 * S_ROWS * LANES + 37, 5000])
def test_matched_filter_block_seams(rng, L):
    taps = np.stack([rng.standard_normal(200), rng.standard_normal(200)]).astype(np.float32)
    _check_mf(rng.standard_normal((2, 1, L)).astype(np.float32), taps)


def test_matched_filter_out_len(rng):
    taps = (rng.standard_normal(300) + 1j * rng.standard_normal(300)).astype(np.complex64)
    x = rng.standard_normal((2, 2, 20000)).astype(np.float32)
    _check_mf(x, taps, out_len=20000)
    longer = MF.matched_filter_ols(torch.from_numpy(x), taps, out_len=20400)
    assert float(longer[..., 20299:].abs().max()) == 0.0
