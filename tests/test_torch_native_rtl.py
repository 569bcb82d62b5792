"""The Minn-RTL oracle triangle through the port's own binding
(`ofdm_sync_tpu_torch.native`): the C++ integer model
(`native/src/minn_rtl.cc`), the float64 NumPy golden model
(`ofdm_sync_tpu/conformance/golden.py`) and the port's plain versions of
kernels A and B, after tests/test_native_rtl.py and
tests/test_rtl_conformance.py.

* The port's metric (`ops.metrics.minn_rtl_metric`, complex128 in) equals
  the C++ corr_total and energy_total traces exactly (integer sums below
  2^53); the plain version of kernel A's corr/energy mode (float32 out)
  equals them rounded once to float32.
* The plain version of kernel B (`ops.detect.extract_gate_events`, and the
  wrapper `kernels.minn_rtl_fused.gate_events` on CPU tensors) on the C++
  model's own above / track traces equals its events field by field (the
  wrapper's float32 track: the peak value rounded once to float32).
* The CPU `minn_rtl_detect_fused` frame start lies within +-16 samples
  (the reference's RTL tolerance) of the C++ model's.
* The port's metric and gate equal the golden model's (above bits: all
  but 1e-3 of them, at gate edges; events exactly on the golden traces).
* The port's binding gives the JAX package's binding's results, and builds
  into the port's own `kernels/_build/`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu import native as jnative  # noqa: E402
from ofdm_sync_tpu.conformance.golden import (  # noqa: E402
    golden_gate_events,
    golden_minn_rtl_metric,
)
from ofdm_sync_tpu_torch import native  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.ops import metrics as M  # noqa: E402
from ofdm_sync_tpu_torch.ops.detect import extract_gate_events  # noqa: E402
from ofdm_sync_tpu_torch.testing import (  # noqa: E402
    native_events,
    rtl_channel_leading,
    rtl_stimulus,
    event_tuples,
)

KW = dict(smooth_shift=3, threshold_value=3276, threshold_frac_bits=15)


def _complex(iq):
    return torch.from_numpy((iq[:, 0] + 1j * iq[:, 1]).astype(np.complex128))


@pytest.mark.parametrize("Q", [64, 512])
def test_metric_equals_cpp_traces(rng, Q):
    iq = rtl_stimulus(rng, Q)
    det = native.minn_rtl_detect_native(iq, quarter_len=Q, **KW, return_traces=True)
    st = M.minn_rtl_metric(_complex(iq), quarter_len=Q, **KW)
    np.testing.assert_array_equal(st.corr_total.numpy(), det.corr_total)
    np.testing.assert_array_equal(st.energy_total.numpy(), det.energy_total)
    corr, energy = F.minn_rtl_corr_energy_planar_fused(rtl_channel_leading(iq, "cpu"),
                                                       quarter_len=Q)
    np.testing.assert_array_equal(corr[0].numpy(),
                                  np.maximum(det.corr_total, 0).astype(np.float32))
    np.testing.assert_array_equal(energy[0].numpy(), det.energy_total.astype(np.float32))


@pytest.mark.parametrize("snr_db", [0.0, 10.0])
def test_gate_on_cpp_traces_equals_cpp_events(rng, snr_db):
    iq = rtl_stimulus(rng, 64, snr_db=snr_db)
    det = native.minn_rtl_detect_native(iq, quarter_len=64, hysteresis=2, return_traces=True,
                                        max_events=16)
    assert det.count >= 1 and not det.overflow
    above = torch.from_numpy(det.above.astype(bool))
    track = torch.from_numpy(np.maximum(det.corr_total, 0).astype(np.float64))
    kw = dict(hysteresis=2, max_events=16, tie="last", emit_unclosed=False)
    want = native_events(det)
    assert event_tuples(extract_gate_events(above, track, **kw)) == want
    # kernel B's track is float32: the peak value is the C++ one rounded once
    table = F.gate_events(above[None], track[None].float(), **kw)
    assert event_tuples(table) == [e[:3] + (float(np.float32(e[3])),) + e[4:] for e in want]


def test_cpu_fused_frame_start_within_rtl_tolerance(rng):
    iq = rtl_stimulus(rng, 64)
    det = native.minn_rtl_detect_native(iq, quarter_len=64, hysteresis=2)
    assert det.count >= 1
    table = F.minn_rtl_detect_fused(rtl_channel_leading(iq, "cpu", torch.float32),
                                    quarter_len=64, **KW, hysteresis=2)
    assert int(table.count[0]) >= 1
    native_peak, port_peak = int(det.peak_idx[0]), int(table.peak_idx[0, 0])
    assert abs(native_peak - port_peak) <= 16
    assert abs(native_peak - (900 + 5 * 64 + 64 - 1)) <= 16  # 1Q after the preamble


def test_metric_and_gate_equal_golden_model(rng):
    iq = rtl_stimulus(rng, 64, snr_db=3.0)
    x = _complex(iq)
    g = golden_minn_rtl_metric(x.numpy(), 64, smooth_shift=3, threshold_value=3276, frac_bits=15)
    st = M.minn_rtl_metric(x, quarter_len=64, **KW)
    np.testing.assert_array_equal(st.corr_total.numpy(), g["corr_total"])
    np.testing.assert_array_equal(st.energy_total.numpy(), g["energy_total"])
    np.testing.assert_allclose(st.smooth_metric.numpy(), g["smooth"], rtol=1e-9,
                               atol=1e-9 * np.abs(g["smooth"]).max())
    assert np.mean(st.above_threshold.numpy() != g["above"]) < 1e-3
    want = golden_gate_events(g["above"], g["corr_positive"], 2, tie="last",
                              emit_unclosed=False, valid_from=3 * 64 - 1)
    table = extract_gate_events(torch.from_numpy(g["above"]),
                                torch.from_numpy(g["corr_positive"]), hysteresis=2,
                                max_events=16, valid_from=3 * 64 - 1, tie="last",
                                emit_unclosed=False)
    assert want and event_tuples(table) == [(s, c, i, float(v), cl) for s, c, i, v, cl in want]


def test_binding_matches_jax_binding(rng):
    iq = rtl_stimulus(rng, 64)
    a = native.minn_rtl_detect_native(iq, quarter_len=64, return_traces=True)
    b = jnative.minn_rtl_detect_native(iq, quarter_len=64, return_traces=True)
    for f in ("gate_start", "gate_close", "peak_idx", "peak_value", "closed", "corr_total",
              "energy_total", "smooth", "above"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.count, a.total) == (b.count, b.total)
    aa, ab = (m.aa_detect_native(iq, half_len=64, return_traces=True) for m in (native, jnative))
    for f in ("peak_idx", "peak_value", "p_at_peak", "P_re", "P_im", "R", "above"):
        np.testing.assert_array_equal(getattr(aa, f), getattr(ab, f), err_msg=f)


def test_overflow_and_unclosed():
    iq = np.zeros((1, 2, 200), np.int16)
    iq[0, 0] = 100  # constant DC: above once valid -> one gate that never closes
    one = native.minn_rtl_detect_native(iq, quarter_len=4, hysteresis=1, emit_unclosed=True,
                                        max_events=4)
    assert one.count == 1 and not one.closed[0] and not one.overflow
    assert native.minn_rtl_detect_native(iq, quarter_len=4, hysteresis=1,
                                         max_events=4).count == 0
    with pytest.raises(ValueError):
        native.minn_rtl_detect_native(np.zeros((2, 3, 10), np.int16), quarter_len=4)
