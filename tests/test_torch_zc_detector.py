"""Port's ZC detectors D5 (`ZCTimeDetector`) and D7 (`ZCStreamingDetector`:
`detect`, `detect_fused`, `detect_fused_iq`, `strongest`) vs the JAX
package on the same complex rx.

On the CPU the port's fused paths run the plain versions of kernels D, B
and E; JAX's run their Pallas kernels in interpret mode.
Tolerances: peak indices, gates and detected starts equal; peak values
within 1e-4 of the largest (JAX sums its windows in float32, the port in
float64); the correlation magnitudes within 1e-4 of their peak.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.models.detectors import ZCStreamingDetector as JStreaming  # noqa: E402
from ofdm_sync_tpu.models.detectors import ZCTimeDetector as JTime  # noqa: E402
from ofdm_sync_tpu.params import SYS_30M72, SystemParams, ZCParams  # noqa: E402
from ofdm_sync_tpu_torch.kernels.matched_filter import MAX_TAPS, matched_filter_ols  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import ZCStreamingDetector, ZCTimeDetector  # noqa: E402

SMALL = SystemParams(n_fft=256, num_active=144, cp_len=64)
PEAK_RTOL = 1e-4


def _rx(ref, rng, L=6000, positions=(1800,), branches=2):
    sig = np.zeros(L, complex)
    for pos in positions:
        sig[pos: pos + ref.size] = ref
    rx = np.stack([sig, 0.7 * sig][:branches])
    rx = rx + 0.05 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return rx.astype(np.complex64)


def _assert_same_events(tres, jres):
    key = lambda e: (e.peak_index, e.gate_start, e.gate_end, e.closed, e.detected_start)  # noqa: E731
    assert [key(e) for e in tres.events] == [key(e) for e in jres.events]
    scale = max([1.0] + [abs(e.peak_value) for e in jres.events])
    for et, ej in zip(tres.events, jres.events):
        assert abs(et.peak_value - ej.peak_value) <= PEAK_RTOL * scale


@pytest.mark.parametrize("sys_p,branches", [(SMALL, 2), (SMALL, 1), (SYS_30M72, 2)])
def test_time_detector_matches_jax(rng, sys_p, branches):
    jd, td = JTime(sys_p), ZCTimeDetector(sys_p)
    np.testing.assert_array_equal(td.reference_waveform(), jd.reference_waveform())
    rx = _rx(jd.reference_waveform(), rng, L=9000, positions=(3100,), branches=branches)
    jo, to = jd.detect(rx), td.detect(torch.from_numpy(rx))
    assert to["peak_index"] == jo["peak_index"] == 3100 + sys_p.n_fft - 1
    assert to["detected_start"] == jo["detected_start"] == 3100
    jm = np.asarray(jo["corr_mag"])
    np.testing.assert_allclose(to["corr_mag"].numpy(), jm, rtol=0, atol=1e-4 * jm.max())


@pytest.fixture(scope="module")
def dets():
    return JStreaming(sys=SMALL, zc=ZCParams()), ZCStreamingDetector(SMALL, ZCParams())


def test_streaming_detect_matches_jax(dets, rng):
    jd, td = dets
    rx = _rx(jd.reference_waveform(), rng, L=9000, positions=(2600, 6200))
    jres, tres = jd.detect(rx), td.detect(torch.from_numpy(rx))
    _assert_same_events(tres, jres)
    assert len(tres.events) >= 2
    np.testing.assert_array_equal(tres.gate_mask, np.asarray(jres.gate_mask))
    for k in ("corr_mag", "local_sum"):
        want = np.asarray(jres.state[k])
        np.testing.assert_allclose(tres.state[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    for k in ("above", "valid"):
        np.testing.assert_array_equal(tres.state[k].numpy(), np.asarray(jres.state[k]))


@pytest.mark.parametrize("path", ["detect_fused", "detect_fused_iq"])
def test_fused_paths_match_jax_and_detect(dets, rng, path):
    jd, td = dets
    rx = _rx(jd.reference_waveform(), rng, L=9000, positions=(2600, 6200))
    tres = getattr(td, path)(torch.from_numpy(rx))
    _assert_same_events(tres, getattr(jd, path)(rx))
    _assert_same_events(tres, td.detect(torch.from_numpy(rx)))
    s = ZCStreamingDetector.strongest(tres)
    assert s is not None and s.peak_value == max(e.peak_value for e in tres.events)
    assert s.peak_index == JStreaming.strongest(jd.detect(rx)).peak_index


def test_one_branch_and_unnormalized(rng):
    """(L,) input, and normalize=False (the branch-summed raw matched
    filter; detect_fused_iq falls back to detect_fused)."""
    jd = JStreaming(sys=SMALL, zc=ZCParams(), normalize=False)
    td = ZCStreamingDetector(SMALL, ZCParams(), normalize=False)
    rx = _rx(jd.reference_waveform(), rng, branches=1)[0] * 4
    _assert_same_events(td.detect(torch.from_numpy(rx)), jd.detect(rx))
    _assert_same_events(td.detect_fused_iq(torch.from_numpy(rx)), jd.detect_fused(rx))


def test_no_event_and_mf_mode_rules(dets, rng):
    """Noise gives no event.  The port has no matched-filter mode: the
    from-IQ path always calls `matched_filter_ols`, which refuses a
    template longer than MAX_TAPS on any device instead of taking the FFT."""
    jd, td = dets
    noise = _rx(jd.reference_waveform(), rng, positions=())
    assert not td.detect_fused_iq(torch.from_numpy(noise)).detected
    assert ZCStreamingDetector.strongest(td.detect(torch.from_numpy(noise))) is None
    with pytest.raises(TypeError):
        ZCStreamingDetector(SMALL, mf_mode="fft")
    iq = torch.from_numpy(np.stack([noise.real, noise.imag], 1).reshape(4, 1, -1))
    with pytest.raises(ValueError, match="taps"):
        matched_filter_ols(iq.float(), np.ones(MAX_TAPS + 1, np.complex64))
