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
captured values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu_torch.kernels import aa_fused as AF  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import launch_counts, reset_launch_counts  # noqa: E402
from ofdm_sync_tpu_torch.kernels.streaming import minn_rtl_metric_planar  # noqa: E402
from ofdm_sync_tpu_torch.kernels.streaming import aa_detect_step, aa_metric_planar  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import MinnRTLDetector  # noqa: E402
from ofdm_sync_tpu_torch.ops.detect import (  # noqa: E402
    extract_gate_events,
    extract_gate_events_capture,
)
from ofdm_sync_tpu_torch.ops.waveforms import build_minn_rtl_preamble  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import common  # noqa: E402
from ofdm_sync_tpu_torch.pipelines.fused_rx import run_fused_rx  # noqa: E402
from ofdm_sync_tpu_torch.testing import aa_stimulus, assert_tables_equal  # noqa: E402

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
                               cfo_hz=1000.0, two_frames=True)
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
