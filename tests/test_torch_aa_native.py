"""The port's [A][A] detect held to the C++ fixed-point [A][A] model
(`ofdm_sync_tpu_torch.native.aa_detect_native`, built from
native/src/minn_rtl.cc), on the CPU.

Stimuli: the golden vectors' int12 stimulus (`testing.aa_int12_stimulus`,
with and without the 500 Hz CFO; equal to tests/test_native_aa.py's, which
reads the JAX package's golden vectors) and `testing.rtl_stimulus` at
L = 64 and L = 512.  Two port paths on the same codes: the plain
`AADetector.detect` (complex64 metric) and `aa_detect_fused`'s plain
version (kernel C's and B's plain versions).  Event counts and peak indices
must equal the C++ model's.  P at each peak of the fused path must be the
C++ model's integer P rounded once to float32; the plain detector's
`ops.metrics.aa_metric` (JAX's arithmetic, kept as it is) rounds each
branch's window sum to complex64 before the branch sum, so its P is within
two float32 roundings (2^-23 relative) of the C++ value.  (The C++ model compares M against the
threshold in Q15, 4915 / 32768, the port against float32(0.15): a single
above bit may differ, as it does once at L = 512, without moving an event.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu.conformance.vectors import golden_stimulus  # noqa: E402
from ofdm_sync_tpu_torch.kernels.aa_fused import aa_detect_fused  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import AADetector  # noqa: E402
from ofdm_sync_tpu_torch.native import aa_detect_native  # noqa: E402
from ofdm_sync_tpu_torch.params import AADetectorParams  # noqa: E402
from ofdm_sync_tpu_torch.testing import (  # noqa: E402
    aa_int12_stimulus,
    event_tuples,
    rtl_channel_leading,
    rtl_stimulus,
)


def _cases():
    cases = [("golden", aa_int12_stimulus(0.0), 512),
             ("golden 500 Hz", aa_int12_stimulus(500.0), 512)]
    for L in (64, 512):
        cases.append((f"rtl L={L}", rtl_stimulus(np.random.default_rng(0), L,
                                                  L=max(4000, 900 + 12 * L)), L))
    return cases


CASES = {label: (iq, L) for label, iq, L in _cases()}


@pytest.mark.parametrize("cfo_hz", [0.0, 500.0])
def test_int12_stimulus_is_the_golden_one(cfo_hz):
    stim = golden_stimulus(cfo_hz=cfo_hz)
    q = np.round(stim.real * 1024.0) + 1j * np.round(stim.imag * 1024.0)
    np.testing.assert_array_equal(aa_int12_stimulus(cfo_hz),
                                  np.stack([q.real, q.imag]).astype(np.int16)[None])


def _native(iq, L):
    det = aa_detect_native(iq, half_len=L, max_events=8)
    assert det.count >= 1 and not det.overflow
    return det


@pytest.mark.parametrize("label", list(CASES))
def test_fused_plain_matches_cpp(label):
    iq, L = CASES[label]
    det = _native(iq, L)
    table, P, _ = aa_detect_fused(rtl_channel_leading(iq, "cpu", torch.float32), half_len=L)
    events = event_tuples(table.select(0))
    assert [e[2] for e in events] == [int(p) for p in det.peak_idx]
    slots = np.flatnonzero(table.valid[0].numpy())
    np.testing.assert_array_equal(P[0, 0, slots].numpy(), det.p_at_peak.real.astype(np.float32))
    np.testing.assert_array_equal(P[0, 1, slots].numpy(), det.p_at_peak.imag.astype(np.float32))


@pytest.mark.parametrize("label", list(CASES))
def test_detector_plain_matches_cpp(label):
    iq, L = CASES[label]
    det = _native(iq, L)
    x = torch.from_numpy(iq.astype(np.float32))
    state, result = AADetector(params=AADetectorParams(preamble_len=2 * L)).detect(
        torch.complex(x[:, 0], x[:, 1]))
    peaks = [e.peak_index for e in result.events]
    assert peaks == [int(p) for p in det.peak_idx]
    P = state.P[peaks].numpy().astype(np.complex128)
    np.testing.assert_allclose(P.real, det.p_at_peak.real, rtol=2.0 ** -23, atol=0)
    np.testing.assert_allclose(P.imag, det.p_at_peak.imag, rtol=2.0 ** -23, atol=0)
    if label == "golden":   # the documented peak: the preamble's end
        assert peaks == [1523]
