"""The port's plain [A][A] grid sweep (`pipelines.aa.run_grid_test_batched`)
against its fused sweep, JAX's arithmetic and the design doc's profile.

* Batched == fused on the CPU, config by config, on every channel and
  preamble length: detected, frame start, event count and timing error
  equal, CFO within 1e-3 Hz (JAX's tolerance for its own pair,
  tests/test_pipeline_parity.py:196-212).  Both sweeps draw the same
  quantized batch (`_grid_batch`, one seeded `torch.Generator`).
* JAX's `_batched_single` arithmetic (its `aa_metric`, the above / |P|^2
  track, `extract_gate_events`, the best event by M at its peak, CFO from
  angle(P)) on the port's batch: the same outcomes, CFO within 1e-3 Hz.
* The port's sweep meets the detection profile JAX's meets
  (tests/test_pipeline_parity.py:179-194) and the design doc's rates over
  seeds 42-46 (tests/test_detection_quality.py, marked `parity` as there).
  The noise comes from a `torch.Generator`, not JAX keys, so these hold
  statistics, not bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.ops.detect import extract_gate_events as j_events  # noqa: E402
from ofdm_sync_tpu.ops.metrics import aa_metric as j_aa_metric  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import aa  # noqa: E402

EXACT = ("detected", "frame_start", "num_events", "timing_error")
SNR, FSR = (-5.0, 0.0, 5.0, 10.0, 15.0), (0.25, 0.5, 1.0, 1.5, 2.0)


@pytest.mark.parametrize("preamble_length", [1024, 512, 256])
@pytest.mark.parametrize("channel", [None, "cir1", "cir2"])
def test_batched_equals_fused(channel, preamble_length):
    a = aa.run_grid_test_batched(preamble_length, channel, device="cpu")
    b = aa.run_grid_test_fused(preamble_length, channel, device="cpu")
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["cfo_error"], b["cfo_error"], atol=1e-3)
    np.testing.assert_allclose(a["metric_peak"], b["metric_peak"], atol=1e-5)
    assert a["detected"].shape == (5, 5) and a["detected"].sum() >= 15


@jax.jit
def _jax_batched(rx_q):
    """JAX's `_batched_single` body (pipelines/aa.py:252-281) after the
    synthesis, vmapped over the configs of (ncfg, branches, n)."""
    L, p = 512, aa._GRID_PARAMS

    def single(x):
        state = j_aa_metric(x, L)
        above = state.valid & (state.M >= p.threshold)
        table = j_events(above, jnp.abs(state.P) ** 2, hysteresis=p.hysteresis,
                         max_events=8, tie="first", emit_unclosed=True)
        M_at_peak = state.M[table.peak_idx] * table.valid
        best = jnp.argmax(M_at_peak)
        peak_idx = table.peak_idx[best]
        return table.count > 0, peak_idx, state.P[peak_idx], M_at_peak[best], table.count

    return jax.vmap(single)(rx_q)


@pytest.mark.parametrize("channel", [None, "cir1"])
def test_batched_matches_jax_arithmetic(channel):
    out = aa.run_grid_test_batched(1024, channel, SNR, FSR, device="cpu")
    x, true_start, L = aa._grid_clean_stream(1024, channel, 42, torch.device("cpu"))
    iq = aa._grid_batch(x, SNR, FSR, 500.0, 42).numpy()        # (4, 25, n)
    rx_q = (iq[0::2] + 1j * iq[1::2]).transpose(1, 0, 2).astype(np.complex64)
    det, peak, P, M, count = (np.asarray(v) for v in _jax_batched(jnp.asarray(rx_q)))
    np.testing.assert_array_equal(out["detected"].reshape(-1), det)
    np.testing.assert_array_equal(out["frame_start"].reshape(-1), peak - 2 * L + 1)
    np.testing.assert_array_equal(out["num_events"].reshape(-1), count)
    cfo = np.angle(P.astype(np.complex128)) * aa.SYS.sample_rate_hz / (2 * np.pi * L)
    np.testing.assert_allclose(out["cfo_est"].reshape(-1)[det], cfo[det], atol=1e-3)
    np.testing.assert_allclose(out["metric_peak"].reshape(-1), M, atol=1e-5)


def test_batched_matches_detection_profile():
    """tests/test_pipeline_parity.py:179-194 on the port's sweep: every
    config at SNR >= 0 dB detects, CFO error < 250 Hz, timing within 2
    samples.  At 0 dB that bound holds for JAX's one noise draw, not in
    general: over seeds 42-61 JAX's own sweep errs by up to 5 samples there
    (80% within 2), and this draw errs by 3 at full scale 1.0.  So 0 dB is
    held to the design doc's bound (16 samples, as
    tests/test_detection_quality.py) and the jitter's statistics to JAX's
    in `test_timing_jitter_matches_jax`."""
    out = aa.run_grid_test_batched(1024, None, snr_values=(-5.0, 0.0, 5.0, 10.0),
                                   full_scale_ratios=(1.0, 2.0), device="cpu")
    det = out["detected"]
    assert det.shape == (4, 2)
    assert det[1:].all() and not det[0].any()
    assert np.all(np.abs(out["timing_error"][2:]) <= 2)
    assert np.all(np.abs(out["timing_error"][1]) <= 16)
    assert np.all(np.abs(out["cfo_error"][1:]) < 250.0)


def test_timing_jitter_matches_jax():
    """Over 20 seeds (42-61) of the AWGN grid at 0 and 5 dB, full scale 1
    and 2: both sweeps detect every config, and the port's mean |timing
    error| at each SNR is within 0.5 samples of JAX's (about 2.5 standard
    errors of the 40 configs' mean), its largest within 2 of JAX's."""
    from ofdm_sync_tpu.pipelines.aa import run_grid_test_batched as j_batched

    kw = dict(snr_values=(0.0, 5.0), full_scale_ratios=(1.0, 2.0))
    seeds = range(42, 62)
    t = np.stack([aa.run_grid_test_batched(1024, None, seed=s, device="cpu", **kw)
                  ["timing_error"] for s in seeds])
    j = np.stack([j_batched(1024, None, seed=s, **kw)["timing_error"] for s in seeds])
    assert np.abs(t).max() < 100 and np.abs(j).max() < 100   # no miss (-1523) in either
    for k in range(2):
        tk, jk = np.abs(t[:, k]), np.abs(j[:, k])
        assert abs(tk.mean() - jk.mean()) <= 0.5, (k, tk.mean(), jk.mean())
        assert abs(int(tk.max()) - int(jk.max())) <= 2, (k, tk.max(), jk.max())


SEEDS = (42, 43, 44, 45, 46)


def _rates(channel, snr_values, fs=2.0):
    shape = (len(SEEDS), len(snr_values))
    det, terr, cerr = np.zeros(shape, bool), np.zeros(shape), np.zeros(shape)
    for i, seed in enumerate(SEEDS):
        out = aa.run_grid_test_batched(1024, channel, snr_values, (fs,), seed=seed,
                                       device="cpu")
        det[i], terr[i], cerr[i] = (out[k][:, 0] for k in ("detected", "timing_error",
                                                           "cfo_error"))
    return det, terr, cerr


@pytest.mark.parity
def test_awgn_detection_rates_match_design_doc():
    """tests/test_detection_quality.py's AWGN bounds on the port's sweep."""
    det, terr, cerr = _rates(None, (-5.0, 0.0, 10.0))
    assert det[:, 1].all() and det[:, 2].all()
    assert not det[:, 0].any()
    assert np.abs(terr[:, 2][det[:, 2]]).max() <= 1
    assert np.abs(terr[:, 1][det[:, 1]]).max() <= 16
    assert np.abs(cerr[:, 2][det[:, 2]]).max() < 300.0


@pytest.mark.parity
def test_multipath_detection_rates_match_design_doc():
    det, terr, _ = _rates("cir1", (0.0, 10.0))
    assert det.all()
    assert (terr[det] >= 0).all()
    assert terr[det].max() < 1024
