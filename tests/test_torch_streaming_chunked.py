"""Port's plain chunked stream (`minn_rtl_stream_*`) vs the JAX one.

The port's `minn_rtl_stream_step` is plain PyTorch (no kernel), as JAX's
is XLA.  Both consume the same chunks; after every step the state must
match: hist, base, last_above, gate_count and the per-slot table ``ev_*``
equal (the stimulus is integer-valued, so every window sum is exact on
both sides, float32 cumsums in JAX and float64 in the port), the smoothing
register within SMOOTH_RTOL (the two scans round in another order).
Chunked must equal the port's one-shot `minn_rtl_detect_planar` for
random chunk splits.  Sizes are those of tests/test_streaming_chunked.py
(Q = 32, streams of 3000-6000 samples).
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels import streaming_chunked as J  # noqa: E402
from ofdm_sync_tpu_torch.kernels import streaming_chunked as T  # noqa: E402
from ofdm_sync_tpu_torch.kernels.streaming import (  # noqa: E402
    minn_rtl_detect_planar,
    minn_rtl_metric_planar,
)
from ofdm_sync_tpu_torch.ops.waveforms import build_minn_rtl_preamble  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402

PARAMS = dict(quarter_len=32, smooth_shift=3, threshold_value=3276, threshold_frac_bits=15,
              hysteresis=2)
SMOOTH_RTOL = 1e-6
EV_FIELDS = ("last_above", "gate_count", "ev_start", "ev_last", "ev_pidx", "ev_pval", "hist")


def _make_stream(rng, L=6000, n_pre=2):
    """Planar (2 branches, 2, L) integer-valued: round(24 x) of the JAX
    test's stimulus (tests/test_streaming_chunked.py:_make_stream)."""
    Q = PARAMS["quarter_len"]
    sig = np.zeros(L, complex)
    for k in range(n_pre):
        pre = build_minn_rtl_preamble("qpsk_freq", rng=np.random.default_rng(k), Q=Q)
        pos = 700 + k * 2500
        sig[pos: pos + 5 * Q] = pre
    rx = np.stack([sig, 0.8 * sig])
    rx = rx + 0.05 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return np.round(24 * np.stack([rx.real, rx.imag], axis=1)).astype(np.float32)


def _check_state(ts, js, what):
    assert int(ts.base) == int(np.asarray(js.base)), what
    for f in EV_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f"{what}: {f}")
    np.testing.assert_allclose(float(ts.smooth), float(js.smooth), rtol=SMOOTH_RTOL)


def _run_both(iq, splits, jp=None, tp=None):
    jp = jp or J.MinnRTLStreamParams(**PARAMS)
    tp = tp or T.MinnRTLStreamParams(**PARAMS)
    js = J.minn_rtl_stream_init(jp, branches=iq.shape[0])
    ts = T.minn_rtl_stream_init(tp, branches=iq.shape[0], device="cpu")
    start = 0
    for end in list(splits) + [iq.shape[-1]]:
        if end > start:
            js = J.minn_rtl_stream_step(js, jnp.asarray(iq[..., start:end]), params=jp)
            ts = T.minn_rtl_stream_step(ts, torch.from_numpy(iq[..., start:end]), params=tp)
            _check_state(ts, js, f"after {end}")
            start = end
    return ts, js


def _oneshot(iq):
    return minn_rtl_detect_planar(torch.from_numpy(iq), **PARAMS)[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_matches_jax_and_oneshot(seed):
    rng = np.random.default_rng(seed)
    iq = _make_stream(rng)
    L = iq.shape[-1]
    # chunk sizes from a 3-value set (each distinct length compiles one
    # JAX step graph), split points in random order
    sizes = rng.choice([256, 384, 512], size=16)
    splits = 200 + np.cumsum(sizes)
    splits = splits[splits < L - 200][:5]
    ts, js = _run_both(iq, splits)
    tp = T.MinnRTLStreamParams(**PARAMS)
    out = T.minn_rtl_stream_finalize(ts, params=tp)
    assert_tables_equal(J.minn_rtl_stream_finalize(js, params=J.MinnRTLStreamParams(**PARAMS)),
                        out, "finalize vs JAX")
    ref = _oneshot(iq)
    assert int(out.count) == int(ref.count) >= 2
    assert_tables_equal(ref, out, "chunked vs one-shot")


def test_chunked_tiny_chunks_cross_gate():
    """Chunks smaller than the hysteresis window, cutting through a gate,
    merge into one event (port only: 30 chunks of 100 samples)."""
    iq = _make_stream(np.random.default_rng(3), L=3000, n_pre=1)
    tp = T.MinnRTLStreamParams(**PARAMS)
    s = T.minn_rtl_stream_init(tp, branches=2, device="cpu")
    for o in range(0, 3000, 100):
        s = T.minn_rtl_stream_step(s, torch.from_numpy(iq[..., o: o + 100]), params=tp)
    out = T.minn_rtl_stream_finalize(s, params=tp)
    ref = _oneshot(iq)
    assert int(out.count) == int(ref.count) >= 1
    assert_tables_equal(ref, out, "tiny chunks")


def test_finalize_midstream_is_nondestructive():
    iq = _make_stream(np.random.default_rng(4), L=3000, n_pre=1)
    tp = T.MinnRTLStreamParams(**PARAMS)
    s = T.minn_rtl_stream_init(tp, branches=2, device="cpu")
    s = T.minn_rtl_stream_step(s, torch.from_numpy(iq[..., :1500]), params=tp)
    before = [t.clone() for t in s]
    mid = T.minn_rtl_stream_finalize(s, params=tp)
    assert all(torch.equal(a, b) for a, b in zip(before, s))
    s = T.minn_rtl_stream_step(s, torch.from_numpy(iq[..., 1500:]), params=tp)
    end = T.minn_rtl_stream_finalize(s, params=tp)
    assert int(end.count) >= int(mid.count)
    assert_tables_equal(_oneshot(iq), end, "split at 1500")


def test_state_checkpoint_roundtrip():
    """torch.save / torch.load mid-stream, then continue: same events."""
    iq = _make_stream(np.random.default_rng(5), L=4000, n_pre=2)
    tp = T.MinnRTLStreamParams(**PARAMS)
    s = T.minn_rtl_stream_init(tp, branches=2, device="cpu")
    s = T.minn_rtl_stream_step(s, torch.from_numpy(iq[..., :2100]), params=tp)
    buf = io.BytesIO()
    torch.save(s, buf)
    buf.seek(0)
    r = torch.load(buf)
    assert isinstance(r, T.MinnRTLStreamState)
    tail = torch.from_numpy(iq[..., 2100:])
    ta = T.minn_rtl_stream_finalize(T.minn_rtl_stream_step(s, tail, params=tp), params=tp)
    tb = T.minn_rtl_stream_finalize(T.minn_rtl_stream_step(r, tail, params=tp), params=tp)
    assert_tables_equal(ta, tb, "restored")
    assert int(ta.count) >= 1


def test_stream_rebase_fresh_epoch():
    """Rebase clears the table and restarts the epoch at 3Q - 1, keeping the
    physical state; JAX's rebase gives the same state."""
    Q = PARAMS["quarter_len"]
    iq1 = _make_stream(np.random.default_rng(0), L=4000, n_pre=1)
    ts, js = _run_both(iq1, [2000])
    ts = T.minn_rtl_stream_rebase(ts, params=T.MinnRTLStreamParams(**PARAMS))
    js = J.minn_rtl_stream_rebase(js, params=J.MinnRTLStreamParams(**PARAMS))
    _check_state(ts, js, "rebased")
    tp = T.MinnRTLStreamParams(**PARAMS)
    assert int(T.minn_rtl_stream_finalize(ts, params=tp).count) == 0
    rng = np.random.default_rng(7)
    pos = 900
    sig = np.zeros(4000, complex)
    sig[pos: pos + 5 * Q] = build_minn_rtl_preamble("qpsk_freq", rng=rng, Q=Q)
    rx = np.stack([sig, 0.8 * sig])
    rx = rx + 0.05 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    iq2 = np.round(24 * np.stack([rx.real, rx.imag], axis=1)).astype(np.float32)
    ts = T.minn_rtl_stream_step(ts, torch.from_numpy(iq2), params=tp)
    t2 = T.minn_rtl_stream_finalize(ts, params=tp)
    assert int(t2.count) >= 1
    best = int(torch.argmax(torch.where(t2.valid, t2.peak_value, float("-inf"))))
    peak_rel = int(t2.peak_idx[best]) - (3 * Q - 1)
    assert abs(peak_rel - (pos + 6 * Q - 1)) <= 8


def test_epoch_headroom_warns_and_raises():
    tp = T.MinnRTLStreamParams(**PARAMS)
    s = T.minn_rtl_stream_init(tp, branches=2, device="cpu")
    assert T.epoch_headroom(s) == T.EPOCH_HORIZON
    with pytest.warns(RuntimeWarning):
        T.epoch_headroom(s._replace(base=torch.tensor(T.EPOCH_HORIZON - 1000,
                                                      dtype=torch.int32)))
    with pytest.raises(OverflowError):
        T.epoch_headroom(s._replace(base=torch.tensor(T.EPOCH_HORIZON, dtype=torch.int32)))
    fused = T.minn_rtl_fused_stream_init(tp, 1, device="cpu")
    assert T.epoch_headroom(fused) == T.EPOCH_HORIZON


def test_metric_on_stream_shorter_than_lag():
    """A stream shorter than the correlator lag gives the zero-primed RTL
    output, no crash."""
    st = minn_rtl_metric_planar(torch.zeros((2, 2, 100)), quarter_len=512, smooth_shift=3,
                                threshold_value=3276, threshold_frac_bits=15)
    assert not bool(st.above_threshold.any())
    tp = T.MinnRTLStreamParams(**PARAMS)._replace(quarter_len=512)
    s = T.minn_rtl_stream_step(T.minn_rtl_stream_init(tp, 2, device="cpu"),
                               torch.zeros((2, 2, 100)), params=tp)
    assert int(s.base) == 100 and int(T.minn_rtl_stream_finalize(s, params=tp).count) == 0
