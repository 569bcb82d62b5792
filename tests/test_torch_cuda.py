"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX and uses no fixture of tests/conftest.py, so on a machine
with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Stimulus is integer-valued (window sums exact in both versions).  Kernel A's
corr_positive must match within ``2e-5 * max(1, |ref|max)``; an above bit
may differ only on the threshold's knife edge (margin within 1e-5 of
energy*T), since the two smoothing scans round in another order; kernel B
tables must be equal.  Kernel C (the [A][A] metric) has no IIR and rounds
each output once: every output must be bit-equal, and so must kernel B's
captured values.  Kernel D (the ZC CFAR gate input) must give a bit-equal
magnitude on integer IQ, and an above bit may differ only where
|mag*2^frac - local*T| is within 1e-6 of local*T; kernel E (the matched
filter) must be within 1e-5 of the output peak of a complex128 FFT
convolution.  The carried-state (primed) modes of A-D and the fused stream
steps are held to their plain versions by the same rules, with smooth
within 1e-5 of max(1, |smooth|) and the emitted smoothing register within
1e-5 of max(1, |register|) (a register decayed toward zero differs in its
denormals).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu_torch.kernels import aa_fused as AF  # noqa: E402
from ofdm_sync_tpu_torch.kernels import matched_filter as MF  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels import zc_fused as ZF  # noqa: E402
from ofdm_sync_tpu_torch.kernels import streaming_chunked as ST  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import (  # noqa: E402
    launch_counts,
    mode_launch_counts,
    reset_launch_counts,
)
from ofdm_sync_tpu_torch.kernels.streaming import minn_rtl_metric_planar  # noqa: E402
from ofdm_sync_tpu_torch.kernels.streaming import aa_detect_step, aa_metric_planar  # noqa: E402
from ofdm_sync_tpu_torch.kernels.streaming import (  # noqa: E402
    zc_cfar_planar,
    zc_iq_planar,
    zc_iq_planar_primed,
)
from ofdm_sync_tpu_torch.models.detectors import ZCStreamingDetector  # noqa: E402
from ofdm_sync_tpu_torch.ops.channel import fft_convolve_full  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import MinnRTLDetector  # noqa: E402
from ofdm_sync_tpu_torch.ops.detect import (  # noqa: E402
    GateEvents,
    extract_gate_events,
    extract_gate_events_capture,
    extract_gate_events_carried,
)
from ofdm_sync_tpu_torch.ops.waveforms import build_minn_rtl_preamble, build_pss_symbol  # noqa: E402
from ofdm_sync_tpu_torch.ops.windows import running_sum_stream  # noqa: E402
from ofdm_sync_tpu_torch.params import SystemParams  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import common  # noqa: E402
from ofdm_sync_tpu_torch.pipelines.fused_rx import run_fused_rx  # noqa: E402
from ofdm_sync_tpu_torch.native import minn_rtl_detect_native  # noqa: E402
from ofdm_sync_tpu_torch.testing import (  # noqa: E402
    aa_stimulus,
    assert_tables_equal,
    event_tuples,
    native_events,
    rtl_channel_leading,
    rtl_stimulus,
)

KW = dict(smooth_shift=3, threshold_value=3276, threshold_frac_bits=15)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _stimulus(batch, L, q, events, seed=0):
    rng = np.random.default_rng(seed)
    x = np.round(8 * rng.standard_normal((4, batch, L)))
    A = rng.standard_normal(q) + 1j * rng.standard_normal(q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    for b, pos in events:
        for c, comp in ((0, pre.real), (1, pre.imag), (2, pre.real), (3, pre.imag)):
            x[c, b, pos: pos + 5 * q] += 3 * np.round(24 * comp)
    return x.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("q,dtype", [(64, torch.float32), (512, torch.int16)])
def test_cuda_kernels_match_plain(cuda, q, dtype):
    batch, L = 5, 9 * 4096 + 123
    x = _stimulus(batch, L, q, [(0, 1000), (2, 20000), (4, L - 7 * q)])
    x = torch.from_numpy(x).to(dtype).to(cuda)
    st = minn_rtl_metric_planar(F._planar_view(x), quarter_len=q, **KW)
    reset_launch_counts()
    corr, above = F.minn_rtl_metric(x, quarter_len=q, **KW)
    torch.testing.assert_close(corr, st.corr_positive, rtol=0,
                               atol=2e-5 * max(1.0, float(st.corr_positive.abs().max())))
    e_s = st.energy_total * float(KW["threshold_value"])
    margin = (st.smooth_metric * float(1 << KW["threshold_frac_bits"]) - e_s).abs()
    assert not ((above != st.above_threshold) & (margin > 1e-5 * e_s.abs())).any()
    for tie in ("first", "last"):
        kw = dict(hysteresis=2, max_events=8, valid_from=st.valid_from, tie=tie,
                  emit_unclosed=tie == "first")
        out = F.gate_events(st.above_threshold, st.corr_positive, **kw)
        ref = extract_gate_events(st.above_threshold, st.corr_positive, **kw)
        assert_tables_equal(ref, out, f"kernel B tie={tie}")
    assert launch_counts()["minn_rtl_metric"] == 1
    assert launch_counts()["gate_events"] == 2


@pytest.mark.gpu
def test_cuda_detect_fused_frames_match_cpu(cuda):
    """The detector front half on the card equals the CPU run."""
    rng = np.random.default_rng(0)
    pre = build_minn_rtl_preamble("qpsk_freq", rng, Q=512)
    setup = common.build_setup(pre, rng, channel_name="cir1", cir_mode="two", snr_db=0.0,
                               cfo_hz=1000.0, two_frames=True, device="cpu")
    flen = setup.extras["frame_len"]
    det = MinnRTLDetector()
    _, f_c, s_c, v_c = det.detect_fused_frames(setup.rx, frame_len=flen)
    _, f_g, s_g, v_g = det.detect_fused_frames(setup.rx.to(cuda), frame_len=flen)
    assert torch.equal(v_g.cpu(), v_c) and torch.equal(s_g.cpu(), s_c)
    assert torch.equal(f_g.cpu(), f_c)
    assert int(v_g.sum()) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("lag,dtype", [(128, torch.float32), (512, torch.int16)])
def test_cuda_aa_metric_matches_plain(cuda, lag, dtype):
    """Kernel C in both modes, bit-equal to the plain version."""
    batch, n = 5, 3 * 4096 + 77
    x = aa_stimulus(batch, n, lag, cuda, seed=lag, events=[(0, 900), (3, 6000)]).to(dtype)
    st = aa_metric_planar(F._planar_view(x), lag)
    reset_launch_counts()
    P_re, P_im, R = AF.aa_metric_planar(x, half_len=lag)
    for out, ref in ((P_re, st.P_re), (P_im, st.P_im), (R, st.R)):
        assert torch.equal(out, ref)
    o = AF.aa_metric(x, half_len=lag, threshold=0.15)
    track, M, above = aa_detect_step(st.P_re, st.P_im, st.R, lag, 0.15)
    assert torch.equal(o.P_re, st.P_re) and torch.equal(o.P_im, st.P_im)
    assert torch.equal(o.track, track) and torch.equal(o.M, M) and torch.equal(o.above, above)
    assert launch_counts()["aa_metric"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("tie,emit", [("first", True), ("last", False)])
def test_cuda_gate_events_capture_matches_plain(cuda, tie, emit):
    """Kernel B's capture: the plain gather at peak_idx, masked by exists."""
    g = torch.Generator(device=cuda).manual_seed(3)
    above = torch.rand((6, 30_000), generator=g, device=cuda) < 0.02
    track = torch.randint(0, 50, (6, 30_000), generator=g, device=cuda).float()
    extras = tuple(torch.randn((6, 30_000), generator=g, device=cuda) for _ in range(3))
    kw = dict(hysteresis=7, max_events=8, valid_from=100, tie=tie, emit_unclosed=emit)
    table, cap = F.gate_events_capture(above, track, extras, **kw)
    ref, ref_cap = extract_gate_events_capture(above, track, extras, **kw)
    assert_tables_equal(ref, table, "kernel B capture")
    assert torch.equal(cap, ref_cap)


@pytest.mark.gpu
def test_cuda_aa_detect_fused_matches_plain(cuda):
    x = aa_stimulus(4, 20_000, 512, cuda, events=[(0, 3000), (2, 12_000)])
    table, P, M = AF.aa_detect_fused(x, half_len=512)
    st = aa_metric_planar(F._planar_view(x), 512)
    track, Mp, above = aa_detect_step(st.P_re, st.P_im, st.R, 512, 0.15)
    ref, cap = extract_gate_events_capture(above, track, (st.P_re, st.P_im, Mp),
                                           hysteresis=128, max_events=8)
    assert_tables_equal(ref, table, "aa_detect_fused")
    assert torch.equal(P, cap[:, :2]) and torch.equal(M, cap[:, 2])
    for b, pos in ((0, 3000), (2, 12_000)):
        assert abs(int(table.peak_idx[b, 0]) - 2 * 512 + 1 - pos) <= 2
    assert int(table.count[1]) == 0 and int(table.count[3]) == 0


@pytest.mark.gpu
def test_cuda_aa_chain_matches_cpu(cuda):
    """The [A][A] receive chain on the card equals the CPU run."""
    reset_launch_counts()
    g = run_fused_rx(channel_name="cir1", num_frames=2, device=cuda)
    counts = launch_counts()
    c = run_fused_rx(channel_name="cir1", num_frames=2, device="cpu")
    assert counts["aa_metric"] >= 1 and counts["gate_events"] >= 1
    assert g.starts == c.starts and len(g.frames) == 2
    for fg, fc in zip(g.frames, c.frames):
        assert abs(fg.cfo_error_hz - fc.cfo_error_hz) < 0.5
        assert abs(fg.evm_pct - fc.evm_pct) < 0.05


ZC = dict(corr_window=2048, threshold_value=64, threshold_frac_bits=15, min_corr_mag=0.3)


def _zc_template(n_fft):
    ref = np.asarray(build_pss_symbol(SystemParams(n_fft=n_fft, num_active=144, cp_len=64)),
                     np.complex64)
    taps = np.stack([ref.real[::-1], -ref.imag[::-1]]).astype(np.float32)
    return ref, taps, float(np.linalg.norm(ref))


def _assert_knife_only(above, ref_above, mag):
    """Kernel D's above vs the plain bits: differences only on the knife edge."""
    e_s = running_sum_stream(mag, ZC["corr_window"]) * float(ZC["threshold_value"])
    margin = (mag * float(1 << ZC["threshold_frac_bits"]) - e_s).abs()
    assert not ((above != ref_above) & (margin > 1e-6 * e_s.abs())).any()


@pytest.mark.gpu
@pytest.mark.parametrize("R,dtype", [(256, torch.int16), (2048, torch.float32)])
def test_cuda_zc_metric_matches_plain(cuda, R, dtype):
    """Kernel D in IQ mode (f32 / int16 codes) and in magnitude mode, and
    D + B, against the plain versions on integer-valued IQ."""
    rng = np.random.default_rng(R)
    ref, taps, ref_norm = _zc_template(R)
    x = np.round(8 * rng.standard_normal((4, 3, 20_000)))
    for b, pos in ((0, 2500), (2, 11_000)):
        for c, part in enumerate((ref.real, ref.imag, ref.real, ref.imag)):
            x[c, b, pos: pos + R] += np.round(24 * part)
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    mf = MF.matched_filter_ols(x, taps)
    kw = dict(ref_len=R, ref_norm=ref_norm, **ZC)
    reset_launch_counts()
    o = ZF.zc_metric(mf, x.to(dtype), **kw)
    mag, above = zc_iq_planar(mf, x.to(dtype), **kw)
    assert torch.equal(o.mag, mag)
    _assert_knife_only(o.above, above, mag)
    table = ZF.zc_iq_cfar_detect(mf, x.to(dtype), **kw)
    ref_table = extract_gate_events(o.above, mag, hysteresis=256, max_events=16, valid_from=2048)
    assert_tables_equal(ref_table, table, "D + B, IQ mode")
    for b, pos in ((0, 2500), (2, 11_000)):
        assert any(abs(p - pos - R + 1) <= 2 for p in table.peak_idx[b][table.valid[b]].tolist())
    assert int(table.count[1]) == 0
    m = ZF.zc_metric(mag, **ZC)
    _assert_knife_only(m.above, zc_cfar_planar(mag, **ZC), mag)
    assert launch_counts()["zc_metric"] == 3 and launch_counts()["gate_events"] == 1


def _mf_complex128(x, taps):
    xc = torch.complex(x[0::2].double(), x[1::2].double())
    want = fft_convolve_full(xc, torch.complex(taps[0].double(), taps[1].double()))
    return torch.stack([want.real, want.imag], dim=1).reshape((x.shape[0],) + want.shape[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("T,n", [(62, 14_335), (2048, 2 * 14_336 + 37), (2049, 5000), (1, 6145),
                                 (2048, 6143), (300, 12_289), (2049, 100)])
def test_cuda_matched_filter_matches_complex128(cuda, T, n):
    """Kernel E against complex128 for taps 1 .. 2049, lengths off the
    6144-output blocks, a stream shorter than one block; one launch."""
    g = torch.Generator(device=cuda).manual_seed(T)
    x = torch.randn((4, 3, n), generator=g, device=cuda)
    taps = torch.randn((2, T), generator=g, device=cuda)
    reset_launch_counts()
    y = MF.matched_filter_ols(x, taps)
    want = _mf_complex128(x, taps)
    assert float((y.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert launch_counts()["matched_filter_ols"] == 1


@pytest.mark.gpu
def test_cuda_matched_filter_many_streams(cuda):
    """More than 65,535 complex streams in one launch (all on gridDim.x)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 40_000, 64), generator=g, device=cuda)
    taps = torch.randn((2, 62), generator=g, device=cuda)
    reset_launch_counts()
    y = MF.matched_filter_ols(x, taps)
    want = _mf_complex128(x, taps)
    assert float((y.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert launch_counts()["matched_filter_ols"] == 1


@pytest.mark.gpu
def test_cuda_matched_filter_modes_bit_identical(cuda):
    """Every precision and nb gives the same bits, within the 'highest'
    mode's 2e-6 of the peak (tests/test_pallas_mf.py:74); one launch a call.
    The precision does not reach the kernel, so it is not crossed with nb."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((4, 2, 30_000), generator=g, device=cuda)
    taps = torch.randn((2, 2048), generator=g, device=cuda)
    reset_launch_counts()
    y = MF.matched_filter_ols(x, taps, precision="highest")
    want = _mf_complex128(x, taps)
    assert float((y.double() - want).abs().max()) <= 2e-6 * float(want.abs().max())
    modes = [dict(precision=p) for p in MF.PRECISIONS] + [dict(nb=nb) for nb in (1, 2, 4)]
    for kw in modes:
        assert torch.equal(MF.matched_filter_ols(x, taps, **kw), y)
    assert launch_counts()["matched_filter_ols"] == 1 + len(modes)


@pytest.mark.gpu
@pytest.mark.parametrize("out_len", [4000, 9000 + 300 - 1, 9000 + 300 - 1 + 2 * 6144 + 17])
def test_cuda_matched_filter_out_len_exact_zeros(cuda, out_len):
    """out_len shorter or longer than L + T - 1: the same values where both
    exist, exactly 0.0 past L + T - 1 (whole blocks of zeros included)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 3, 9000), generator=g, device=cuda)
    taps = torch.randn((2, 300), generator=g, device=cuda)
    full = MF.matched_filter_ols(x, taps)
    y = MF.matched_filter_ols(x, taps, out_len=out_len)
    n = min(out_len, full.shape[-1])
    assert y.shape[-1] == out_len and torch.equal(y[..., :n], full[..., :n])
    assert bool((y[..., n:] == 0).all())


@pytest.mark.gpu
def test_cuda_zc_paths_match_cpu(cuda):
    """`detect_fused` and `detect_fused_iq` on the card (kernels D, E, B)
    give the CPU `detect`'s events on the cir1 stimulus."""
    pss = build_pss_symbol()
    setup = common.build_setup(pss, np.random.default_rng(0), channel_name="cir1",
                               cir_mode="two", snr_db=10.0, cfo_hz=1000.0, device="cpu")
    det = ZCStreamingDetector()
    reset_launch_counts()
    outs = [det.detect_fused(setup.rx.to(cuda)), det.detect_fused_iq(setup.rx.to(cuda))]
    counts = launch_counts()
    want = [(e.peak_index, e.detected_start) for e in det.detect(setup.rx).events]
    for out in outs:
        assert [(e.peak_index, e.detected_start) for e in out.events] == want
        assert ZCStreamingDetector.strongest(out).peak_index == 3549
    assert min(counts["zc_metric"], counts["matched_filter_ols"], counts["gate_events"]) >= 1


# ---------------------------------------------------------------------------
# The carried-state (primed) modes and the fused stream steps


def _rel(out, ref):
    return float((out.double() - ref.double()).abs().max()) / max(1.0, float(ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("q,dtype", [(64, torch.float32), (512, torch.int16)])
def test_cuda_metric_modes_match_plain(cuda, q, dtype):
    """Kernel A's full-metric, corr/energy and primed modes (history,
    register, global base, emitted register) vs the plain versions."""
    batch, L = 5, 5 * 4096 + 123
    x = torch.from_numpy(_stimulus(batch, L, q, [(0, 1000), (4, L - 7 * q)])).to(dtype).to(cuda)
    hist = torch.from_numpy(_stimulus(batch, 3 * q, q, [], seed=1)).to(cuda)
    carry = torch.rand(batch, device=cuda) * 1e4
    base = 123_456_789
    pk = dict(base_index=base, hist_init=hist, carry_init=carry)
    reset_launch_counts()
    full = F.minn_rtl_metric_planar_fused(x, quarter_len=q, **KW, **pk)
    corr, energy = F.minn_rtl_corr_energy_planar_fused(x, quarter_len=q, hist_init=hist)
    _, above, carry_out = F.minn_rtl_metric(x, quarter_len=q, **KW, **pk, emit_state=True)
    st = minn_rtl_metric_planar(F._planar_view(x), quarter_len=q, **KW, base_index=base,
                                hist_init=F._planar_view(hist), carry_init=carry)
    assert _rel(full.corr_positive, st.corr_positive) <= 2e-5 and _rel(corr, st.corr_positive) <= 2e-5
    assert torch.equal(full.energy_total, st.energy_total) and torch.equal(energy, st.energy_total)
    assert _rel(full.smooth_metric, st.smooth_metric) <= 1e-5
    e_s = st.energy_total * float(KW["threshold_value"])
    margin = (st.smooth_metric * float(1 << KW["threshold_frac_bits"]) - e_s).abs()
    for a in (above, full.above_threshold):
        assert not ((a != st.above_threshold) & (margin > 1e-5 * e_s.abs())).any()
    torch.testing.assert_close(carry_out, st.smooth_metric[:, -1], rtol=1e-5, atol=1e-5)
    modes = mode_launch_counts()
    assert modes["minn_rtl_metric/full"] == modes["minn_rtl_metric/corr_energy"] == 1
    assert modes["minn_rtl_metric/primed"] == 3 and launch_counts()["minn_rtl_metric"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("tie,emit,n_extra", [("last", True, 0), ("first", False, 3)])
def test_cuda_gate_events_carried_matches_plain(cuda, tie, emit, n_extra):
    """Kernel B with global indices, a finite global length and a gate carry
    in and out, with and without capture."""
    g = torch.Generator(device=cuda).manual_seed(5)
    batch, L, base, h = 6, 30_000, 1_000_000_000, 7
    above = torch.rand((batch, L), generator=g, device=cuda) < 0.02
    track = torch.randint(0, 50, (batch, L), generator=g, device=cuda).float()
    extras = tuple(torch.randn((batch, L), generator=g, device=cuda) for _ in range(n_extra))
    la = base - torch.randint(1, h + 1, (batch,), generator=g, device=cuda)
    flag = torch.arange(batch, device=cuda) % 2
    gi = torch.stack([torch.where(flag > 0, la, -1), flag], dim=1).to(torch.int32)
    kw = dict(hysteresis=h, max_events=8, valid_from=base + 10, tie=tie, emit_unclosed=emit,
              base_index=base, stream_len_global=base + L - 300, gate_init=gi)
    reset_launch_counts()
    if extras:
        table, cap, gate_out = F.gate_events_capture(above, track, extras, **kw, emit_state=True)
    else:
        (table, gate_out), cap = F.gate_events(above, track, **kw, emit_state=True), None
    ref, ref_cap, ref_gate = extract_gate_events_carried(above, track, extras, **kw)
    assert_tables_equal(ref, table, "kernel B carried")
    assert torch.equal(gate_out, ref_gate)
    if extras:
        assert torch.equal(cap, ref_cap)
    assert mode_launch_counts()["gate_events/primed"] == 1


@pytest.mark.gpu
def test_cuda_aa_and_zc_primed_match_plain(cuda):
    """Kernel C primed (bit-equal) and kernel D's primed magnitude mode
    (dyadic magnitudes: exact local sums, so equal above bits)."""
    lag, batch, n, base = 256, 3, 3 * 4096 + 7, 77_777
    x = aa_stimulus(batch, n, lag, cuda, seed=2, events=[(0, 50), (2, 5000)])
    hist = aa_stimulus(batch, 2 * lag, lag, cuda, seed=3, events=[(1, 100)])
    o = AF.aa_metric(x.to(torch.int16), half_len=lag, threshold=0.15, base_index=base,
                     hist_init=hist)
    st = aa_metric_planar(F._planar_view(x), lag, base_index=base, hist=F._planar_view(hist))
    track, M, above = aa_detect_step(st.P_re, st.P_im, st.R, lag, 0.15, base)
    for out, ref in ((o.P_re, st.P_re), (o.P_im, st.P_im), (o.track, track), (o.M, M),
                     (o.above, above)):
        assert torch.equal(out, ref)
    g = torch.Generator(device=cuda).manual_seed(4)
    mag = torch.randn((3, 20_000), generator=g, device=cuda).abs().mul(0.05)
    mag[0, 3000] += 1.0
    mag[2, 15_000] += 1.0
    mag = (mag * 1024).round() / 1024
    mhist = (torch.rand((3, 2048), generator=g, device=cuda) * 51).round() / 1024
    m = ZF.zc_metric(mag, **ZC, base_index=base, hist_init=mhist)
    assert torch.equal(m.above, zc_cfar_planar(mag, **ZC, base_index=base, hist=mhist))
    assert int(m.above.sum()) >= 2


@pytest.mark.gpu
def test_cuda_fused_streams_match_cpu(cuda):
    """The three fused stream steps on the card equal the CPU, chunk by
    chunk (tables, gate carry; the Minn register within 1e-5); the Minn
    step launches kernel F once a chunk and kernel A not at all."""
    mp = ST.MinnRTLStreamParams(quarter_len=64, **KW, hysteresis=2)
    x = torch.from_numpy(_stimulus(3, 4 * 4096, 64, [(0, 4096 - 200), (2, 9000)]))
    xa = aa_stimulus(3, 4 * 4096, 256, "cpu", seed=5, events=[(1, 2 * 4096 - 300)])
    mag = (torch.rand((3, 4 * 4096), generator=torch.Generator().manual_seed(6)) * 51).round() / 1024
    mag[1, 4096 + 3] += 1.0
    cases = ((ST.minn_rtl_fused_stream_step, lambda d: ST.minn_rtl_fused_stream_init(mp, 3, device=d),
              x, dict(params=mp)),
             (ST.aa_fused_stream_step, lambda d: ST.aa_fused_stream_init(256, 3, device=d), xa,
              dict(half_len=256)),
             (ST.zc_cfar_fused_stream_step, lambda d: ST.zc_cfar_fused_stream_init(2048, 3, device=d),
              mag, ZC))
    reset_launch_counts()
    for step, init, data, kw in cases:
        sg, sc = init(cuda), init("cpu")
        for o in range(0, data.shape[-1], 4096):
            c = data[..., o: o + 4096].contiguous()
            sg, tg = step(sg, c.to(cuda), **kw)
            sc, tc = step(sc, c, **kw)
            if not isinstance(tg, GateEvents):  # [A][A]: (table, P_at_peak, M_at_peak)
                assert torch.equal(tg[1].cpu(), tc[1]) and torch.equal(tg[2].cpu(), tc[2])
                tg, tc = tg[0], tc[0]
            assert_tables_equal(tc, tg, f"{step.__name__} at {o}")
            assert torch.equal(sg.gate.cpu(), sc.gate)
        if hasattr(sg, "carry"):
            torch.testing.assert_close(sg.carry.cpu(), sc.carry, rtol=1e-5, atol=1e-5)
    modes, counts = mode_launch_counts(), launch_counts()
    # the Minn step is kernel F alone; [A][A] and ZC CFAR are C + B and D + B
    assert counts["minn_rtl_step"] == 4 and counts["minn_rtl_metric"] == 0
    assert min(modes["aa_metric/primed"], modes["zc_metric/primed"]) == 4
    assert modes["gate_events/primed"] == 8


# ---------------------------------------------------------------------------
# Span seams: kernel A walks each stream in spans, each primed from a halo
# (or, at the head, from the history); kernel B composes span summaries.
# These shapes give several spans per stream.


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["corr_above", "full", "corr_energy", "primed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("batch,L", [(1, 3 * 2**16 + 37), (3, 100_003)])
def test_cuda_metric_spans_match_plain(cuda, mode, dtype, batch, L):
    """Kernel A in every mode across span seams, preambles on the seams."""
    q = 512
    events = [(b, p) for b in range(batch) for p in range(3000 + 700 * b, L - 6 * q, 16_384)]
    x = torch.from_numpy(_stimulus(batch, L, q, events, seed=batch)).to(dtype).to(cuda)
    pk = {}
    if mode == "primed":
        pk = dict(base_index=77_777_777, carry_init=torch.rand(batch, device=cuda) * 1e4,
                  hist_init=torch.from_numpy(_stimulus(batch, 3 * q, q, [], seed=9)).to(cuda))
    hist = pk.get("hist_init")
    st = minn_rtl_metric_planar(F._planar_view(x), quarter_len=q, **KW,
                                base_index=pk.get("base_index", 0),
                                hist_init=None if hist is None else F._planar_view(hist),
                                carry_init=pk.get("carry_init"))
    if mode == "corr_energy":
        corr, energy = F.minn_rtl_corr_energy_planar_fused(x, quarter_len=q)
        assert _rel(corr, st.corr_positive) <= 2e-5 and torch.equal(energy, st.energy_total)
        return
    if mode == "full":
        full = F.minn_rtl_metric_planar_fused(x, quarter_len=q, **KW)
        corr, above = full.corr_positive, full.above_threshold
        assert torch.equal(full.energy_total, st.energy_total)
        assert _rel(full.smooth_metric, st.smooth_metric) <= 1e-5
    else:
        corr, above, carry_out = F.minn_rtl_metric(x, quarter_len=q, **KW, **pk, emit_state=True)
        torch.testing.assert_close(carry_out, st.smooth_metric[:, -1], rtol=1e-5, atol=1e-5)
    assert _rel(corr, st.corr_positive) <= 2e-5
    e_s = st.energy_total * float(KW["threshold_value"])
    margin = (st.smooth_metric * float(1 << KW["threshold_frac_bits"]) - e_s).abs()
    assert not ((above != st.above_threshold) & (margin > 1e-5 * e_s.abs())).any()
    assert int(above.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("q,dtype", [(37, torch.float32), (101, torch.int16)])
def test_cuda_metric_odd_quarter_matches_plain(cuda, q, dtype):
    """Kernel A with Q not a multiple of 4: its ring accesses at a Q offset
    take the unaligned path, across spans and the primed head."""
    batch, L = 2, 70_001
    x = torch.from_numpy(_stimulus(batch, L, q, [(0, 5000), (1, 40_000)], seed=q))
    x = x.to(dtype).to(cuda)
    hist = torch.from_numpy(_stimulus(batch, 3 * q + 5, q, [], seed=3)).to(cuda)
    carry = torch.rand(batch, device=cuda) * 1e3
    pk = dict(base_index=12_345, hist_init=hist, carry_init=carry)
    full = F.minn_rtl_metric_planar_fused(x, quarter_len=q, **KW, **pk)
    st = minn_rtl_metric_planar(F._planar_view(x), quarter_len=q, **KW, base_index=12_345,
                                hist_init=F._planar_view(hist), carry_init=carry)
    assert _rel(full.corr_positive, st.corr_positive) <= 2e-5
    assert torch.equal(full.energy_total, st.energy_total)
    assert _rel(full.smooth_metric, st.smooth_metric) <= 1e-5
    e_s = st.energy_total * float(KW["threshold_value"])
    margin = (st.smooth_metric * float(1 << KW["threshold_frac_bits"]) - e_s).abs()
    assert not ((full.above_threshold != st.above_threshold) & (margin > 1e-5 * e_s.abs())).any()
    corr, energy = F.minn_rtl_corr_energy_planar_fused(x, quarter_len=q, hist_init=hist)
    assert _rel(corr, st.corr_positive) <= 2e-5 and torch.equal(energy, st.energy_total)


def _codes(batch, L, q, events, seed, planted):
    """12-bit ADC codes (int16, clipped to +-2047) with preambles at the
    events; ``planted``: codes of +-32767 (and one -32768) in a few tiles."""
    x = np.clip(np.round(9.0 * _stimulus(batch, L, q, events, seed=seed)), -2047, 2047)
    if planted:
        x[:, 0, 5000:5100] = 32767
        x[1, batch - 1, L // 2] = -32768
        x[:, batch - 1, L - 4000: L - 3990] = -32767
    return torch.from_numpy(x.astype(np.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["corr_above", "full", "corr_energy"])
@pytest.mark.parametrize("q,batch,L,view,planted", [
    (512, 1, 3 * 2**16 + 37, False, False),
    (101, 5, 70_001, False, False),
    (37, 5, 40_003, False, False),
    (512, 2, 50_000, True, False),
    (512, 3, 100_003, False, True),
])
def test_cuda_metric_exact_i16_matches_float_path(cuda, mode, q, batch, L, view, planted):
    """Kernel A on int16 codes without a history (its exact integer path):
    corr and energy bit-identical to the float path on the same codes as
    float32, smooth and above by the plain version's rules, across span
    seams and on a strided view.  In-range codes: no tile leaves the exact
    route and the launch counts as exact_i16; planted out-of-range codes:
    their tiles take the float route (counted) and the outputs stay equal."""
    events = [(b, p) for b in range(batch) for p in range(2000 + 900 * b, L - 6 * q, 20_000)]
    buf = _codes(batch, L + 24, q, events, seed=q + batch, planted=planted).to(cuda)
    x = buf[..., 11: 11 + L] if view else buf[..., :L].contiguous()
    assert x.is_contiguous() != view
    fails = torch.zeros(1, dtype=torch.int32, device=cuda)
    reset_launch_counts()
    o = F._minn_metric(x, mode, quarter_len=q, **KW, failed_tiles=fails)
    torch.cuda.synchronize()
    modes = mode_launch_counts()
    assert modes.get("minn_rtl_metric/exact_i16") == launch_counts()["minn_rtl_metric"] == 1
    assert (int(fails) > 0) == planted
    f = F._minn_metric(x.float(), mode, quarter_len=q, **KW)
    assert mode_launch_counts().get("minn_rtl_metric/exact_i16") == 1
    assert torch.equal(o.corr, f.corr)
    if mode != "corr_above":
        assert torch.equal(o.energy, f.energy)
    if mode == "corr_energy":
        return
    st = minn_rtl_metric_planar(F._planar_view(x.float().cpu()), quarter_len=q, **KW)
    e_s = st.energy_total * float(KW["threshold_value"])
    margin = (st.smooth_metric * float(1 << KW["threshold_frac_bits"]) - e_s).abs()
    for above in (o.above, f.above):
        assert not ((above.cpu() != st.above_threshold) & (margin > 1e-5 * e_s.abs())).any()
    if mode == "full":
        assert _rel(o.smooth.cpu(), st.smooth_metric) <= 1e-5
    assert int(o.above.sum()) > 0


def _seam_gates(batch, n, seed):
    """Above runs on and around every 4096-sample tile seam, sparse above
    samples elsewhere, a quantized track full of ties with -0.0 among its
    zeros."""
    g = torch.Generator().manual_seed(seed)
    above = torch.rand((batch, n), generator=g) < 0.002
    for s in range(4096, n, 4096):
        off = int(torch.randint(-40, 40, (1,), generator=g))
        above[:, max(s + off - 30, 0): s + off + 30: 3] = True
    track = torch.randint(0, 4, (batch, n), generator=g).float()
    track[torch.rand((batch, n), generator=g) < 0.2] = -0.0
    return above, track, g


@pytest.mark.gpu
@pytest.mark.parametrize("h,E,tie,emit,carried,lg_off,n_extra", [
    (2, 8, "last", False, False, None, 0),
    (7, 8, "first", True, True, -300, 0),
    (40_000, 8, "last", True, True, 500, 1),  # h larger than a span
    (1, 1, "first", True, False, None, 3),    # E = 1: overflow
    (1, 128, "last", True, True, -5000, 3),   # dense ties, full capacity
])
def test_cuda_gate_events_spans_match_plain(cuda, h, E, tie, emit, carried, lg_off, n_extra):
    """Kernel B over several spans per stream: gates across the seams, a
    carried gate, Lg inside or past the call, captures."""
    batch, n, base = 3, 200_000, (1 << 29) if carried else 0
    above, track, g = _seam_gates(batch, n, h + E)
    extras = tuple(torch.randn((batch, n), generator=g) for _ in range(n_extra))
    kw = dict(hysteresis=h, max_events=E, valid_from=base + 10, tie=tie, emit_unclosed=emit,
              base_index=base)
    if carried:
        gi = torch.tensor([[base - min(h, 5), 2], [-1, 0], [base - 1, 1]], dtype=torch.int32)
        kw.update(stream_len_global=base + n + lg_off, gate_init=gi)
    ref, ref_cap, ref_gate = extract_gate_events_carried(above, track, extras, **kw)
    dev = lambda t: t.to(cuda)  # noqa: E731
    kw_c = {k: dev(v) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    if extras:
        table, cap, gate_out = F.gate_events_capture(dev(above), dev(track), tuple(map(dev, extras)),
                                                     **kw_c, emit_state=True)
        assert torch.equal(cap.cpu(), ref_cap)
    else:
        table, gate_out = F.gate_events(dev(above), dev(track), **kw_c, emit_state=True)
    assert_tables_equal(ref, table, "kernel B over spans")
    assert torch.equal(table.peak_value.cpu(), ref.peak_value)
    assert torch.equal(torch.signbit(table.peak_value.cpu()), torch.signbit(ref.peak_value))
    assert torch.equal(gate_out.cpu(), ref_gate)
    assert int(ref.count.sum()) > 0


# ---------------------------------------------------------------------------
# Kernels C and D walk spans too: several spans per stream at batch 1 and 3,
# lengths off the tile size, the largest lag kernel C's parent took, and the
# kernels' other layouts (kernel C with more than two branches; D with 1-4).


def _zc_knife_only(above, ref_above, mag_ext, W, T):
    """Kernel D's above vs the plain bits: differences only where |mag * 2^15
    - local * T| is within 1e-6 of local * T (mag_ext: the plain magnitudes
    with any history before the compared samples)."""
    n = above.shape[-1]
    e_s = running_sum_stream(mag_ext, W)[..., -n:] * float(T)
    margin = (mag_ext[..., -n:] * float(1 << 15) - e_s).abs()
    assert not ((above != ref_above) & (margin > 1e-6 * e_s.abs())).any()


@pytest.mark.gpu
@pytest.mark.parametrize("lag,branches", [(37, 2), (128, 2), (512, 2), (5546, 2), (512, 4),
                                          (2000, 3), (5546, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("batch", [1, 3])
def test_cuda_aa_metric_spans_match_plain(cuda, lag, branches, dtype, batch):
    """Kernel C in both modes, plain and primed, bit-equal to the plain
    version over several spans per stream (5546: the parent's largest lag;
    4 branches at that lag: no ring fits, the delayed samples come from
    global memory)."""
    L = 100_003 if lag < 5000 else 70_001
    g = torch.Generator(device=cuda).manual_seed(lag + batch)
    noise = lambda n: (torch.randn((2 * branches, batch, n), generator=g,  # noqa: E731
                                   device=cuda) * 8).round()
    x = noise(L)
    half = (torch.randn((2, lag), generator=g, device=cuda) * 72).round()  # [A][A] halves
    for b in range(batch):
        for p in range(2000 + 300 * b, L - 2 * lag - 10, 20_000):
            x[:, b, p: p + 2 * lag] += half.repeat(branches, 2)
    x = x.to(dtype)
    for primed in (False, True):
        base = 123_457 if primed else 0
        hist = noise(2 * lag + 77) if primed else None
        pk = dict(base_index=base, hist_init=hist)
        st = aa_metric_planar(F._planar_view(x), lag, base_index=base,
                              hist=None if hist is None else F._planar_view(hist))
        m = AF.aa_metric(x, half_len=lag, **pk)
        o = AF.aa_metric(x, half_len=lag, threshold=0.15, **pk)
        track, M, above = aa_detect_step(st.P_re, st.P_im, st.R, lag, 0.15, base)
        for out, ref in ((m.P_re, st.P_re), (m.P_im, st.P_im), (m.R, st.R), (o.P_re, st.P_re),
                         (o.P_im, st.P_im), (o.track, track), (o.M, M), (o.above, above)):
            assert torch.equal(out, ref)
        assert int(above.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("R,W,branches", [(127, 256, 1), (256, 127, 2), (2048, 2048, 2),
                                          (2048, 256, 3), (127, 2048, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
def test_cuda_zc_metric_spans_match_plain(cuda, R, W, branches, dtype):
    """Kernel D in IQ mode (mag bit-equal, above knife-only) and in
    magnitude mode (dyadic magnitudes: above bit-equal) across span seams,
    with rows of odd length."""
    g = torch.Generator(device=cuda).manual_seed(R + W + branches)
    batch, n, T = 3, 60_001, int(4.0 * (1 << 15) / W)
    C = 2 * branches
    iq = (torch.randn((C, batch, n), generator=g, device=cuda) * 8).round()
    mf = torch.randn((C, batch, n + R - 1), generator=g, device=cuda) * (40.0 * R ** 0.5)
    mf[:, :, 5000::7919] *= 60.0  # peaks, several per span
    cfar = dict(corr_window=W, threshold_value=T, threshold_frac_bits=15, min_corr_mag=0.25)
    kw = dict(ref_len=R, ref_norm=3.0 * R ** 0.5, **cfar)
    o = ZF.zc_metric(mf, iq.to(dtype), **kw)
    mag, above = zc_iq_planar(mf, iq, **kw)
    assert torch.equal(o.mag, mag)
    _zc_knife_only(o.above, above, mag, W, T)
    assert int(above.sum()) > 0
    dy = (mag * 1024).round() / 1024
    m = ZF.zc_metric(dy, **cfar)
    assert torch.equal(m.above, zc_cfar_planar(dy, **cfar))


@pytest.mark.gpu
@pytest.mark.parametrize("R,W,h,dtype", [(128, 128, 16, torch.float32),
                                         (2048, 2048, 256, torch.int16),
                                         (127, 256, 300, torch.float32)])
def test_cuda_zc_iq_primed_matches_plain(cuda, R, W, h, dtype):
    """Kernel D's primed IQ mode (the shard mode of #9) at a random global
    base: mag, above, gate_init and the D + B table against the plain
    version over [halo; shard]."""
    g = torch.Generator(device=cuda).manual_seed(R + h)
    batch, n, T = 3, 40_003, int(4.0 * (1 << 15) / W)
    base = int(torch.randint(W, 1 << 30, (1,), generator=g, device=cuda))
    Wh = ZF.zc_tm_halo_rows(R, W, h)
    iq = (torch.randn((4, batch, n + Wh), generator=g, device=cuda) * 8).round()
    mf = torch.randn((4, batch, n + Wh), generator=g, device=cuda) * (40.0 * R ** 0.5)
    mf[:, [0, 2], Wh - max(h // 2, 1)] *= 100.0  # a gate open across the seam
    mf[:, :, Wh + 3000::9001] *= 60.0
    mf_h, mf_s = mf[..., :Wh].contiguous(), mf[..., Wh:].contiguous()
    iq_h, iq_s = iq[..., :Wh].contiguous(), iq[..., Wh:].contiguous()
    cfar = dict(corr_window=W, threshold_value=T, threshold_frac_bits=15, min_corr_mag=0.25)
    kw = dict(ref_len=R, ref_norm=3.0 * R ** 0.5, **cfar)
    reset_launch_counts()
    o = ZF.zc_metric(mf_s, iq_s.to(dtype), **kw, base_index=base,
                     hist_init=(mf_h, iq_h.to(dtype)), hysteresis=h)
    mag, above, gate = zc_iq_planar_primed(mf_s, iq_s, mf_h, iq_h, **kw, base_index=base,
                                           hysteresis=h)
    assert torch.equal(o.mag, mag)
    mag_ext, _ = zc_iq_planar(mf, iq, **kw, base_index=base - Wh)
    _zc_knife_only(o.above, above, mag_ext, W, T)
    assert torch.equal(o.gate_init, gate) and int(gate[:, 1].sum()) >= 2
    Lg = base + n - 5
    table = ZF.zc_iq_cfar_detect(mf_s, iq_s.to(dtype), **kw, hysteresis=h, base_index=base,
                                 stream_len_global=Lg, shard_init=(mf_h, iq_h.to(dtype)))
    ref, _, _ = extract_gate_events_carried(o.above, o.mag, (), hysteresis=h, max_events=16,
                                            valid_from=W, tie="first", emit_unclosed=True,
                                            base_index=base, stream_len_global=Lg,
                                            gate_init=gate)
    assert_tables_equal(ref, table, "primed D + B")
    assert mode_launch_counts()["zc_metric/primed_iq"] == 2


def _oracle(q, L, positions=(900,), seed=0, E=16):
    iq = rtl_stimulus(np.random.default_rng(seed), q, L=L, positions=positions)
    det = minn_rtl_detect_native(iq, quarter_len=q, **KW, hysteresis=2, max_events=E,
                                 return_traces=True)
    assert det.count >= 1 and not det.overflow
    return iq, det


@pytest.mark.gpu
@pytest.mark.parametrize("q,L", [(64, 4000), (512, 7000), (64, 3 * 2**16 + 37)])
def test_cuda_kernel_a_equals_cpp_traces(cuda, q, L):
    """Kernel A's corr/energy mode on the int16 codes: the C++ model's
    integer corr_total (clipped at 0) and energy_total, rounded once to
    float32 (its window sums are exact float64), across span seams."""
    iq, det = _oracle(q, L, positions=range(900, L - 8 * q, 16384))
    corr, energy = F.minn_rtl_corr_energy_planar_fused(rtl_channel_leading(iq, cuda),
                                                       quarter_len=q)
    np.testing.assert_array_equal(corr[0].cpu().numpy(),
                                  np.maximum(det.corr_total, 0).astype(np.float32))
    np.testing.assert_array_equal(energy[0].cpu().numpy(), det.energy_total.astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("snr_db", [0.0, 10.0])
def test_cuda_kernel_b_on_cpp_traces_equals_cpp_events(cuda, snr_db):
    iq = rtl_stimulus(np.random.default_rng(1), 64, snr_db=snr_db)
    det = minn_rtl_detect_native(iq, quarter_len=64, hysteresis=2, max_events=16,
                                 return_traces=True)
    track = np.maximum(det.corr_total, 0).astype(np.float32)
    table = F.gate_events(torch.as_tensor(det.above.astype(bool), device=cuda)[None],
                          torch.as_tensor(track, device=cuda)[None], hysteresis=2,
                          max_events=16, tie="last", emit_unclosed=False)
    want = [e[:3] + (float(np.float32(e[3])),) + e[4:] for e in native_events(det)]
    assert want and event_tuples(table) == want


@pytest.mark.gpu
@pytest.mark.parametrize("q,L", [(64, 4000), (512, 7000)])
def test_cuda_fused_frame_start_within_rtl_tolerance(cuda, q, L):
    iq, det = _oracle(q, L)
    table = F.minn_rtl_detect_fused(rtl_channel_leading(iq, cuda, torch.float32),
                                    quarter_len=q, **KW, hysteresis=2, max_events=16)
    peaks = [e[2] for e in event_tuples(table)]
    assert len(peaks) == det.count
    assert all(abs(a - int(b)) <= 16 for a, b in zip(peaks, det.peak_idx))
    assert abs(peaks[0] - (900 + 6 * q - 1)) <= 16  # 1Q after the preamble


@pytest.mark.gpu
@pytest.mark.parametrize("primed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("row", ["aligned", "odd"])
@pytest.mark.parametrize("offset", [0, 1, 4, 512])
def test_cuda_metric_strided_view(cuda, offset, row, dtype, primed):
    """Kernel A reads a view x[..., a:a + n] of a wider buffer in place (its
    strided mode, the counterpart of in_block_stride / in_block_offset):
    outputs bit-equal to the same data made contiguous, and to the plain
    version by the phase-3 rules; unaligned rows take the scalar loads."""
    q, batch, n = 64, 3, 40_003
    width = offset + n + (5 if row == "aligned" else 6)
    width += (-width % 4) if row == "aligned" else (1 - width % 2)
    buf = torch.from_numpy(_stimulus(batch, width, q, [(0, offset + 1000), (2, offset + 30_000)],
                                     seed=offset)).to(dtype).to(cuda)
    view = buf[..., offset: offset + n]
    assert not view.is_contiguous() and view.stride(1) == width
    pk = {}
    if primed:
        pk = dict(base_index=4096 + offset, carry_init=torch.rand(batch, device=cuda) * 1e4,
                  hist_init=torch.from_numpy(_stimulus(batch, 3 * q, q, [], seed=7)).to(cuda))
    reset_launch_counts()
    corr, above, carry = F.minn_rtl_metric(view, quarter_len=q, **KW, **pk, emit_state=True)
    torch.cuda.synchronize()
    assert mode_launch_counts().get("minn_rtl_metric/strided") == 1
    c2, a2, k2 = F.minn_rtl_metric(view.contiguous(), quarter_len=q, **KW, **pk, emit_state=True)
    assert mode_launch_counts().get("minn_rtl_metric/strided") == 1
    assert torch.equal(corr, c2) and torch.equal(above, a2) and torch.equal(carry, k2)
    hist = pk.get("hist_init")
    st = minn_rtl_metric_planar(F._planar_view(view), quarter_len=q, **KW,
                                base_index=pk.get("base_index", 0),
                                hist_init=None if hist is None else F._planar_view(hist),
                                carry_init=pk.get("carry_init"))
    assert _rel(corr, st.corr_positive) <= 2e-5
    e_s = st.energy_total * float(KW["threshold_value"])
    margin = (st.smooth_metric * float(1 << KW["threshold_frac_bits"]) - e_s).abs()
    assert not ((above != st.above_threshold) & (margin > 1e-5 * e_s.abs())).any()
    assert int(above.sum()) > 0
    with pytest.raises(ValueError, match="unit stride"):
        F.minn_rtl_metric(buf[..., ::2], quarter_len=q, **KW)


@pytest.mark.gpu
def test_cuda_sharded_minn_two_ranks_on_one_card(cuda):
    """`parallel.shard.sharded_minn_rtl_detect_fused` over two gloo ranks
    sharing the card (mesh (1, 2)), the overlap split off and on, equals
    the one-shot kernels A + B; the split runs kernel A strided."""
    from ofdm_sync_tpu_torch.kernels import build
    from ofdm_sync_tpu_torch.parallel import distributed
    from torch_shard_ranks import cuda_minn_rank

    q, batch, L, rows = 512, 4, 2 * 65_536, 2048
    seam = L // 2
    x = _stimulus(batch, L, q, [(0, seam - 6 * q), (1, seam - 3 * q), (2, seam + rows - 5 * q),
                                (3, 20_000)], seed=11)
    kw = dict(quarter_len=q, **KW, hysteresis=2)
    build.library()  # the ranks load the library built here
    ranks = distributed.run_ranks(cuda_minn_rank, 2, (x, kw, rows), timeout_s=300)
    ref = F.minn_rtl_detect_fused(torch.from_numpy(x).to(cuda), **kw)
    assert (ref.count >= 1).all()
    for r, out in enumerate(ranks):
        for overlap in (False, True):
            assert_tables_equal(ref, GateEvents(*(torch.from_numpy(out[overlap][f])
                                                  for f in GateEvents._fields)),
                                f"rank {r} overlap {overlap}", 1e-6)
        assert out["modes"].get("minn_rtl_metric/strided", 0) == 2


@pytest.mark.gpu
def test_cuda_sharded_rest_two_ranks_on_one_card(cuda):
    """The per-sample sharded path over two gloo ranks sharing the card
    (mesh (1, 2)) against the one-shot kernels: the Minn-RTL metric with
    the blocked IIR (corr and energy equal, smooth within 1e-5 of its
    largest value, above equal on this integer stimulus) and its detect
    (tables equal); the ZC CFAR detect on dyadic magnitudes (tables equal);
    the ZC detect from IQ through kernel E against D + B on the one-shot
    magnitudes truncated to L (integer fields equal, peaks within 1e-4).
    Kernel A's full mode, D's primed magnitude mode with B carried, E and
    D's primed IQ mode must launch on each rank."""
    from ofdm_sync_tpu_torch.kernels import build
    from ofdm_sync_tpu_torch.parallel import distributed
    from torch_shard_ranks import cuda_rest_rank

    q, batch, L = 512, 4, 2 * 65_536
    seam = L // 2
    x = _stimulus(batch, L, q, [(0, seam - 6 * q), (1, seam - 3 * q), (2, 20_000),
                                (3, seam + 7_000)], seed=12)
    kw = dict(quarter_len=q, **KW, hysteresis=2)
    rng = np.random.default_rng(12)
    mag = np.round(0.05 * np.abs(rng.standard_normal((batch, L))) * 1024) / 1024
    for b, pos in enumerate((seam - 1, seam + 3, 9_000, seam - 2_500)):
        mag[b, pos - 2: pos + 3] += [0.5, 2.0, 5.0, 2.0, 0.5]
    mag = mag.astype(np.float32)
    cfar = dict(corr_window=2048, hysteresis=256, max_events=16)
    ref = np.asarray(build_pss_symbol(SystemParams(n_fft=256, num_active=144, cp_len=64)))
    zx = np.round(8 * rng.standard_normal((4, batch, L))).astype(np.float32)
    for b in range(batch):
        pos = seam - 128 + 64 * b
        for c, part in enumerate((ref.real, ref.imag) * 2):
            zx[c, b, pos: pos + len(ref)] += np.round(24 * part)
    zkw = dict(corr_window=256, min_corr_mag=0.1, hysteresis=64, max_events=8)
    build.library()  # the ranks load the library built here
    ranks = distributed.run_ranks(cuda_rest_rank, 2, (x, kw, mag, cfar, zx, ref, zkw),
                                  timeout_s=300)
    xt = torch.from_numpy(x).to(cuda)
    st = F.minn_rtl_metric_planar_fused(xt, quarter_len=q, **KW)
    ref_detect = F.minn_rtl_detect_fused(xt, **kw)
    ref_cfar = ZF.zc_cfar_detect(torch.from_numpy(mag).to(cuda), **cfar)
    zt = torch.from_numpy(zx).to(cuda)
    taps = torch.as_tensor(ref).flip(-1).conj()
    zmag = ZF.zc_metric(MF.matched_filter_ols(zt, taps), zt, ref_len=len(ref),
                        ref_norm=float(np.sqrt(np.sum(np.abs(ref) ** 2))),
                        corr_window=256, min_corr_mag=0.1).mag[:, :L].contiguous()
    ref_zc = ZF.zc_cfar_detect(zmag, **zkw)
    assert (ref_detect.count >= 1).all() and (ref_cfar.count >= 1).all()
    assert (ref_zc.count >= 1).all()
    table = lambda a: GateEvents(*(torch.from_numpy(a[f]) for f in GateEvents._fields))  # noqa: E731
    for r, out in enumerate(ranks):
        sl = slice(r * L // 2, (r + 1) * L // 2)
        corr, smooth, energy, above = (torch.from_numpy(a) for a in out["metric"])
        assert torch.equal(corr, st.corr_positive[:, sl].cpu())
        assert torch.equal(energy, st.energy_total[:, sl].cpu())
        ref_s = st.smooth_metric[:, sl].cpu()
        assert float((smooth - ref_s).abs().max()) <= 1e-5 * float(ref_s.abs().max())
        assert torch.equal(above, st.above_threshold[:, sl].cpu())
        assert_tables_equal(ref_detect, table(out["detect"]), f"rank {r} detect", 1e-6)
        assert_tables_equal(ref_cfar, table(out["cfar"]), f"rank {r} cfar")
        assert_tables_equal(ref_zc, table(out["zc"]), f"rank {r} zc", 1e-4)
        for key, modes in (("metric", ("minn_rtl_metric/full", "minn_rtl_metric/primed")),
                           ("detect", ("minn_rtl_metric/full",)),
                           ("cfar", ("zc_metric/primed", "gate_events/primed")),
                           ("zc", ("matched_filter_ols", "zc_metric/primed_iq"))):
            got = out[key, "modes"]
            assert all(got.get(m, 0) >= 1 for m in modes), (r, key, got)


@pytest.mark.gpu
def test_cuda_bench_checks_small(cuda):
    """The bench's five on-card checks (`ofdm_sync_tpu_torch.bench`) at a
    small shape: kernels A + B, D (IQ) + B, C + B with capture and C's
    metric mode, E, and the sharded detect at mesh (1, 1) over NCCL, each
    against its plain version; every kernel of them (A-E) launched."""
    from ofdm_sync_tpu_torch import bench
    from ofdm_sync_tpu_torch.testing import minn_stimulus, zc_iq_stimulus

    ref, taps, _ = bench.zc_template()
    reset_launch_counts()
    bench.check_minn_rtl(minn_stimulus(16, 8192, 512, cuda, seed=1)[0])
    bench.check_zc_iq(*bench.zc_check_inputs(8, 8192, cuda, 2))
    bench.check_aa(aa_stimulus(8, 8192, 512, cuda, seed=3, events=[(0, 2048), (1, 4000)]))
    assert bench.check_mf(zc_iq_stimulus(2, 8192, ref, cuda, seed=4, events=[(0, 1000)]),
                          taps) <= bench.MF_RTOL
    bench.check_sharded(minn_stimulus(16, 8192, 512, cuda, seed=5)[0])
    # kernels A-E; F, the stream step, is no part of the five checks
    counts = launch_counts()
    assert counts.pop("minn_rtl_step") == 0
    assert all(n >= 1 for n in counts.values()), counts
