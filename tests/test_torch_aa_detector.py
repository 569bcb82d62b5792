"""Port vs JAX: the [A][A] detector D9 (`models.detectors.AADetector`) and
its stimulus (`ops.waveforms` AA builders, `ops.channel` multi-antenna
channel, 12-bit ADC, clipping stats, device AWGN).

Detector: same events, peak index and start, CFO within 0.5 Hz, metric at
the peak within 1e-4.  NumPy builders are bit-equal (same RNG draw order);
channel and ADC outputs agree within float32 rounding (PyTorch and XLA
factor their FFTs and round cos/sin differently).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.models.detectors import AADetector as JDetector  # noqa: E402
from ofdm_sync_tpu.ops import channel as jch  # noqa: E402
from ofdm_sync_tpu.ops import waveforms as jw  # noqa: E402
from ofdm_sync_tpu.params import AADetectorParams, SYS_AA_10M  # noqa: E402
from ofdm_sync_tpu_torch.models.base import DetectionEvent, DetectionResult  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import AADetector  # noqa: E402
from ofdm_sync_tpu_torch.ops import channel as tch  # noqa: E402
from ofdm_sync_tpu_torch.ops import waveforms as tw  # noqa: E402


def _rx(rng, total=256, n=6000, positions=(1500, 4000), cfo_hz=500.0, amp=0.05):
    """Two antennas, [A][A] preambles at ``positions``, CFO, complex noise."""
    pre, _, _ = jw.build_aa_preamble(total, SYS_AA_10M)
    sig = np.zeros(n, complex)
    for p in positions:
        sig[p: p + total] = pre
    rx = np.stack([sig, 0.8 * sig])
    rx = np.asarray(jch.apply_cfo(jnp.asarray(rx), cfo_hz, SYS_AA_10M.sample_rate_hz))
    return (rx + amp * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
            ).astype(np.complex64)


def _same_events(out, ref):
    assert len(out.events) == len(ref.events) >= 1
    for a, b in zip(out.events, ref.events):
        assert (a.peak_index, a.detected_start, a.gate_start, a.gate_end, a.closed) == \
            (b.peak_index, b.detected_start, b.gate_start, b.gate_end, b.closed)
        assert abs(a.cfo_hz - b.cfo_hz) < 0.5
        assert abs(a.metric_at_peak - b.metric_at_peak) < 1e-4


@pytest.mark.parametrize("total", [256, 1024])
def test_detect_matches_jax(rng, total):
    rx = _rx(rng, total=total, positions=(1500, 4000) if total == 256 else (1200,))
    params = AADetectorParams(preamble_len=total)
    jstate, jres = JDetector(params=params).detect(jnp.asarray(rx))
    state, res = AADetector(params=params).detect(torch.from_numpy(rx))
    _same_events(res, jres)
    # whole M arrays: JAX's float32 cumsums drift over the 6000-sample stream
    # (1.2e-4 seen); the metric at every event's peak is held to 1e-4 above
    np.testing.assert_allclose(state.M.numpy(), np.asarray(jstate.M), atol=5e-4)
    # physical sanity: the CFO of the strongest event (a short L is coarser)
    assert abs(AADetector.best(res).cfo_hz - 500.0) < (20.0 if total == 1024 else 200.0)


def test_detect_fused_matches_jax_and_detect(rng):
    rx = _rx(rng)
    det = AADetector(params=AADetectorParams(preamble_len=256))
    jres = JDetector(params=AADetectorParams(preamble_len=256)).detect_fused(jnp.asarray(rx))
    res = det.detect_fused(torch.from_numpy(rx))
    _same_events(res, jres)
    _same_events(res, det.detect(torch.from_numpy(rx))[1])
    assert [e.detected_start for e in res.events] == [1500, 4000] or \
        all(abs(e.detected_start - p) <= 2 for e, p in zip(res.events, (1500, 4000)))


def test_detect_fused_frames_matches_jax(rng):
    rx = _rx(rng, positions=(1000, 3500))
    params = AADetectorParams(preamble_len=256)
    jres, jf, js, jv = JDetector(params=params).detect_fused_frames(
        rx, frame_len=700, max_frames=4)
    res, f, s, v = AADetector(params=params).detect_fused_frames(
        torch.from_numpy(rx), frame_len=700, max_frames=4)
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(f.numpy(), jf)
    assert int(v.sum()) == 2
    _same_events(res, jres)


def test_best_by_metric():
    ev = [DetectionEvent(peak_index=i, peak_value=0.0, gate_start=0, gate_end=1, closed=True,
                         metric_at_peak=m) for i, m in enumerate((0.3, 0.9, 0.5))]
    assert AADetector.best(DetectionResult(events=ev)).peak_index == 1
    assert AADetector.best(DetectionResult()) is None
    assert DetectionResult(events=ev).best_by(lambda e: -e.peak_index).peak_index == 0


def test_metric_is_forward(rng):
    rx = torch.from_numpy(_rx(rng))
    det = AADetector(params=AADetectorParams(preamble_len=256))
    torch.testing.assert_close(det(rx).M, det.metric(rx).M)
    assert det.L == 128 and not list(det.parameters())


# ---------------------------------------------------------------------------
# Stimulus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total", [1024, 512, 256])
def test_aa_preamble_exact(total):
    a, za, pa = jw.build_aa_preamble(total, SYS_AA_10M)
    b, zb, pb = tw.build_aa_preamble(total, SYS_AA_10M)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(za, zb)
    assert pa == pb == tw.papr_db(b)
    assert tw.AA_PREAMBLE_LENGTHS == jw.AA_PREAMBLE_LENGTHS
    with pytest.raises(ValueError):
        tw.build_aa_preamble(100)


def test_aa_qpsk_symbol_exact():
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):  # the second draw checks the RNG state advanced alike
        a, ua = jw.build_aa_qpsk_symbol(ra, SYS_AA_10M)
        b, ub = tw.build_aa_qpsk_symbol(rb, SYS_AA_10M)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ua, ub)


@pytest.mark.parametrize("channel", [None, "cir1", "cir2"])
def test_apply_channel_multi_antenna(channel):
    tx = np.concatenate([np.zeros(100), tw.build_aa_preamble(256)[0], np.zeros(300)])
    ja, jc, jo = jch.apply_channel_multi_antenna(tx, 5.0, np.random.default_rng(1), channel)
    ta, tc, to = tch.apply_channel_multi_antenna(tx, 5.0, np.random.default_rng(1), channel)
    assert ta.dtype == ja.dtype and ta.shape == ja.shape and to == jo
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-5)
    if channel is None:
        assert tc is None and jc is None
        np.testing.assert_array_equal(ta, ja)  # host NumPy only: bit-equal
    else:
        np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("ratio", [0.25, 1.0, 2.0])
def test_quantize_adc_and_clipping(rng, ratio):
    x = (rng.standard_normal((2, 4000)) + 1j * rng.standard_normal((2, 4000))).astype(
        np.complex64)
    fs = float(np.sqrt(np.mean(np.abs(x) ** 2)) * ratio)
    q_ref = np.asarray(jch.quantize_adc(jnp.asarray(x), fs))
    q = tch.quantize_adc(torch.from_numpy(x), fs).numpy()
    assert q.dtype == q_ref.dtype == np.complex64
    np.testing.assert_array_equal(q, q_ref)
    assert tch.compute_clipping_stats(x.flatten(), fs) == \
        jch.compute_clipping_stats(x.flatten(), fs)
    # a tensor full scale broadcasts per config
    q2 = tch.quantize_adc(torch.from_numpy(np.stack([x, x])),
                          torch.tensor([fs, 2 * fs]).reshape(2, 1, 1))
    np.testing.assert_array_equal(q2[0].numpy(), q)


def test_awgn_noise_device_power_and_seed(rng):
    x = torch.from_numpy((rng.standard_normal((2, 20000)) + 1j * rng.standard_normal(
        (2, 20000))).astype(np.complex64))
    x[1] *= 3.0
    snr = torch.tensor([0.0, 10.0])
    n1 = tch.awgn_noise_device(x, snr, torch.Generator().manual_seed(4))
    n2 = tch.awgn_noise_device(x, snr, torch.Generator().manual_seed(4))
    assert n1.shape == (2, 2, 20000) and n1.dtype == torch.complex64
    torch.testing.assert_close(n1, n2, rtol=0, atol=0)
    p_sig = (x.abs() ** 2).mean(-1)
    for k, s in enumerate((0.0, 10.0)):
        ratio = p_sig / (n1[k].abs() ** 2).mean(-1)
        np.testing.assert_allclose(ratio.numpy(), 10 ** (s / 10), rtol=0.05)
    zero = tch.awgn_noise_device(torch.zeros(100, dtype=torch.complex64), 5.0,
                                 torch.Generator().manual_seed(0))
    assert zero.shape == (100,) and float(zero.abs().max()) == 0.0
