"""Port's fused [A][A] kernels (#5 `aa_metric_planar`, #6 `aa_detect_fused`,
and the `sc_`/`minn_metric_planar` re-indexings) vs the JAX TPU kernels.

On the CPU the port's wrappers run the plain versions of kernels C and B;
the JAX side runs `pallas_aa.py` in Pallas interpret mode.  Stimuli are
those of tests/test_pallas_aa.py:19-124.  Tolerances (JAX sums windows in
float32, the port in float64): event tables equal field by field except
``peak_value`` (rtol 2e-4); P_at_peak rtol 2e-4, atol 1e-3; M_at_peak rtol
2e-4, atol 1e-5; metric arrays atol 2e-5 * max|R|, M atol 1e-4.  The CUDA
kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels.pallas_aa import (  # noqa: E402
    aa_detect_fused_pallas,
    aa_metric_planar_pallas,
    minn_metric_planar_pallas,
    sc_metric_planar_pallas,
)
from ofdm_sync_tpu.ops.channel import apply_cfo  # noqa: E402
from ofdm_sync_tpu.ops.metrics import find_minn_peak_standard, find_plateau_end  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_aa_preamble  # noqa: E402
from ofdm_sync_tpu.params import SYS_AA_10M  # noqa: E402
from ofdm_sync_tpu_torch.kernels import aa_fused as A  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import launch_counts, reset_launch_counts  # noqa: E402
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import gate_events_capture  # noqa: E402
from ofdm_sync_tpu_torch.ops.detect import GateEvents, extract_gate_events  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402


def _stimulus(rng, total_len=256, L_sig=8192, pos=2000, cfo_hz=500.0, snr_amp=0.05):
    """tests/test_pallas_aa.py:_stimulus: a 2-antenna [A][A] preamble with
    CFO in complex noise -> complex (2, L_sig)."""
    pre, _, _ = build_aa_preamble(total_len, SYS_AA_10M)
    sig = np.zeros(L_sig, complex)
    sig[pos: pos + total_len] = pre
    rx = np.stack([sig, 0.8 * sig])
    rx = np.asarray(apply_cfo(jnp.asarray(rx), cfo_hz, SYS_AA_10M.sample_rate_hz))
    return rx + snr_amp * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))


def _channel_leading(rxs):
    """complex (batch, BR, n) -> float32 (2*BR, batch, n), rows
    [b0_i, b0_q, b1_i, b1_q]."""
    rxs = np.asarray(rxs)
    iq = np.stack([rxs.real, rxs.imag], axis=-2).astype(np.float32)  # (batch, BR, 2, n)
    b, br, _, n = iq.shape
    return np.ascontiguousarray(iq.reshape(b, 2 * br, n).transpose(1, 0, 2))


def _check_detect(cl, L, **kw):
    """Port aa_detect_fused (CPU) vs JAX aa_detect_fused_pallas on one
    channel-leading input."""
    jt, jP, jM = aa_detect_fused_pallas(jnp.asarray(cl), half_len=L, block=1024,
                                        channel_leading=True, **kw)
    tt, tP, tM = A.aa_detect_fused(torch.from_numpy(cl), half_len=L, **kw)
    assert_tables_equal(jt, tt, "vs aa_detect_fused_pallas", peak_rtol=2e-4)
    assert tP.shape == np.asarray(jP).shape and tM.shape == np.asarray(jM).shape
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(tM.numpy(), np.asarray(jM), rtol=2e-4, atol=1e-5)
    return tt, tP, tM


def test_detect_single_stream_cfo_and_timing(rng):
    """L = 512 (the 1024-sample preamble): frame start = peak - 2L + 1 at
    the true position, CFO from angle(P_peak)."""
    L, pos, cfo = 512, 3000, 500.0
    rx = _stimulus(rng, total_len=1024, pos=pos, cfo_hz=cfo, snr_amp=0.02)
    table, P, _ = _check_detect(_channel_leading(rx[None]), L)
    assert int(table.count[0]) >= 1
    assert abs(int(table.peak_idx[0, 0]) - 2 * L + 1 - pos) <= 2
    fs = SYS_AA_10M.sample_rate_hz
    cfo_est = float(np.arctan2(float(P[0, 1, 0]), float(P[0, 0, 0]))) * fs / (2 * np.pi * L)
    assert abs(cfo_est - cfo) < 5.0


def test_detect_batched(rng):
    """Three streams, preambles at different positions, L = 128."""
    rxs = [_stimulus(np.random.default_rng(s), total_len=256, pos=1500 + 400 * s)
           for s in range(3)]
    table, _, _ = _check_detect(_channel_leading(rxs), 128)
    assert table.peak_idx.shape == (3, 8)
    for s in range(3):
        assert int(table.count[s]) >= 1
        assert abs(int(table.peak_idx[s, 0]) - 255 - (1500 + 400 * s)) <= 2


@pytest.mark.parametrize("tie,emit", [("first", True), ("last", True), ("first", False),
                                      ("last", False)])
def test_detect_tie_and_emit_options(rng, tie, emit):
    """Three [A][A] blocks per stream on integer-valued noise (many exact
    |P|^2 ties), the last one ending 5 samples before the stream end so its
    gate is still open there, for every tie / emit_unclosed combination."""
    batch, L, n = 2, 64, 2000
    x = np.round(4 * rng.standard_normal((batch, 2, n)) + 4j * rng.standard_normal((batch, 2, n)))
    for pos in (300, 900, n - 2 * L - 5):
        a = np.round(12 * rng.standard_normal((batch, 2, L)))
        x[..., pos: pos + L] += a
        x[..., pos + L: pos + 2 * L] += a
    table, _, _ = _check_detect(_channel_leading(x), L, hysteresis=16, tie=tie,
                                emit_unclosed=emit)
    assert int(table.count.sum()) >= 2 * batch
    assert not bool(table.closed[:, 2].any())  # the last gate runs into the end


def test_channel_leading_layout_matches_natural(rng):
    """JAX's natural (batch, BR, 2, L) layout and the port's channel-leading
    input give the same table (tests/test_pallas_aa.py:98-111)."""
    batch, L_half, n = 2, 64, 2000
    iq = rng.standard_normal((batch, 2, 2, n)).astype(np.float32)
    cl = np.ascontiguousarray(iq.reshape(batch, 4, n).transpose(1, 0, 2))
    jt, jP, jM = aa_detect_fused_pallas(jnp.asarray(iq), half_len=L_half, block=512)
    tt, tP, tM = A.aa_detect_fused(torch.from_numpy(cl), half_len=L_half)
    assert_tables_equal(jt, tt, "natural layout", peak_rtol=2e-4)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(tM.numpy(), np.asarray(jM), rtol=2e-4, atol=1e-5)


def test_detect_int16_codes(rng):
    """int16 ADC codes go in as they are; JAX takes the same values as f32."""
    rx = _stimulus(rng, total_len=256, L_sig=4000, pos=1200)
    cl = np.round(_channel_leading(rx[None]) * 1024).astype(np.int16)
    jt, jP, jM = aa_detect_fused_pallas(jnp.asarray(cl.astype(np.float32)), half_len=128,
                                        block=1024, channel_leading=True)
    tt, tP, tM = A.aa_detect_fused(torch.from_numpy(cl), half_len=128)
    assert_tables_equal(jt, tt, "int16", peak_rtol=2e-4)
    np.testing.assert_allclose(tM.numpy(), np.asarray(jM), rtol=2e-4, atol=1e-5)
    assert int(tt.count[0]) == 1


@pytest.mark.parametrize("L", [128, 512])
def test_metric_planar_matches_pallas(rng, L):
    rxs = [_stimulus(np.random.default_rng(s), total_len=2 * L, L_sig=5000, pos=900 + 700 * s)
           for s in range(2)]
    cl = _channel_leading(rxs)
    jr = aa_metric_planar_pallas(jnp.asarray(cl), half_len=L, block=1024,
                                 channel_leading=True)
    tr = A.aa_metric_planar(torch.from_numpy(cl), half_len=L)
    scale = float(np.abs(np.asarray(jr[2])).max())
    for name, o, r in zip(("P_re", "P_im", "R"), tr, jr):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=2e-5 * scale,
                                   err_msg=name)


def test_sc_metric_planar_matches_pallas(rng):
    """Schmidl-Cox re-indexing, including the plateau-end pick."""
    n_fft, n = 256, 3000
    x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    x[:, 800: 800 + n_fft // 2] = x[:, 800 + n_fft // 2: 800 + n_fft]
    cl = _channel_leading(x[None])
    jM, jP, jR = sc_metric_planar_pallas(jnp.asarray(cl), n_fft=n_fft, block=512,
                                         channel_leading=True)
    M, P, R = A.sc_metric_planar(torch.from_numpy(cl), n_fft=n_fft)
    scale = float(np.abs(np.asarray(jR)).max())
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=2e-5 * scale)
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), atol=2e-5 * scale)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), atol=1e-4)
    assert int(find_plateau_end(jnp.asarray(M.numpy()[0]), cp_len=64)) == \
        int(find_plateau_end(jnp.asarray(jM)[0], cp_len=64))


def test_minn_metric_planar_matches_pallas(rng):
    """Standard-Minn re-indexing, including the peak pick."""
    n_fft, n = 256, 3000
    Q = n_fft // 4
    x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    a = x[:, 900: 900 + Q].copy()
    x[:, 900: 900 + n_fft] = np.concatenate([a, a, -a, -a], axis=-1)
    cl = _channel_leading(x[None])
    jM, jP, jR = minn_metric_planar_pallas(jnp.asarray(cl), n_fft=n_fft, block=512,
                                           channel_leading=True)
    M, P, R = A.minn_metric_planar(torch.from_numpy(cl), n_fft=n_fft)
    scale = float(np.abs(np.asarray(jR)).max())
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=2e-5 * scale)
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), atol=2e-5 * scale)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), atol=1e-4)
    assert int(find_minn_peak_standard(jnp.asarray(M.numpy()[0]))[0]) == \
        int(find_minn_peak_standard(jnp.asarray(jM)[0])[0])


@pytest.mark.parametrize("emit", [True, False])
def test_capture_is_a_gather_at_the_peak(rng, emit):
    """Kernel B's plain capture: each existing slot reads its channels at
    peak_idx, every other slot reads 0 -- also an unclosed gate that is not
    emitted (emit_unclosed=False), as `pallas_common.event_finalize`."""
    above = torch.zeros((3, 500), dtype=torch.bool)
    above[:, 50:55] = above[:, 200:203] = True
    above[:, -3:] = True  # a gate still open at the end of every stream
    track = torch.from_numpy(rng.integers(0, 9, (3, 500)).astype(np.float32))
    extras = tuple(torch.from_numpy(rng.standard_normal((3, 500)).astype(np.float32))
                   for _ in range(3))
    kw = dict(hysteresis=4, max_events=8, valid_from=10, tie="first", emit_unclosed=emit)
    table, cap = gate_events_capture(above, track, extras, **kw)
    assert_tables_equal(extract_gate_events(above, track, **kw), table, "capture table")
    assert cap.shape == (3, 3, 8)
    exists = table.gate_start > 0
    for b in range(3):
        for k in range(3):
            want = torch.where(exists[b], extras[k][b][table.peak_idx[b].long()], 0.0)
            torch.testing.assert_close(cap[b, k], want, rtol=0, atol=0)
    if not emit:  # the open gate exists (captured) but is not valid
        assert bool((exists & ~table.valid).any())


def test_gate_events_round_trip_numpy(rng):
    """The AA path's carried state is its event table: a JAX table and the
    port's round-trip through `GateEvents.from_numpy` / `to_numpy`."""
    cl = _channel_leading(_stimulus(rng, total_len=256, L_sig=3000, pos=900)[None])
    jt, _, _ = aa_detect_fused_pallas(jnp.asarray(cl), half_len=128, block=1024,
                                      channel_leading=True)
    tt, _, _ = A.aa_detect_fused(torch.from_numpy(cl), half_len=128)
    assert_tables_equal(GateEvents.from_numpy(jt), GateEvents.from_numpy(tt.to_numpy()),
                        "round trip", peak_rtol=2e-4)


def test_short_stream_and_zero_signal():
    """A stream shorter than 2L: no event; zero signal: finite M, no event."""
    for n in (100, 3000):
        x = torch.zeros((4, 2, n))
        table, P, M = A.aa_detect_fused(x, half_len=128)
        assert int(table.count.sum()) == 0 and torch.isfinite(M).all()
        assert float(P.abs().max()) == 0.0
    st = A.aa_metric(torch.zeros((4, 1, 700)), half_len=128, threshold=0.15)
    assert torch.isfinite(st.M).all() and not bool(st.above.any())


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        A.aa_detect_fused(torch.zeros((3, 2, 100)), half_len=8)
    with pytest.raises(TypeError):
        A.aa_metric_planar(torch.zeros((4, 2, 100), dtype=torch.float64), half_len=8)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent path
        A.aa_metric_planar(torch.zeros((4, 2, 100), device="meta"), half_len=8)
    with pytest.raises(ValueError):
        A.aa_metric_planar(torch.zeros((4, 2, 100)), half_len=0)
    with pytest.raises(ValueError):
        gate_events_capture(torch.zeros((1, 10), dtype=torch.bool), torch.zeros((1, 10)),
                            tuple(torch.zeros((1, 10)) for _ in range(4)), hysteresis=2)


def test_cpu_path_counts_no_launch(rng):
    reset_launch_counts()
    A.aa_detect_fused(torch.from_numpy(_channel_leading(_stimulus(rng)[None])), half_len=128)
    A.aa_metric_planar(torch.zeros((4, 1, 300)), half_len=16)
    assert launch_counts() == dict.fromkeys(
        ("minn_rtl_metric", "gate_events", "aa_metric", "zc_metric", "matched_filter_ols",
         "minn_rtl_step", "aa_peak_capture", "minn_rx_front", "minn_rx_back"), 0)
