"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX and uses no fixture of tests/conftest.py, so on a machine
with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Stimulus is integer-valued (window sums exact in both versions).  Kernel A's
corr_positive must match within ``2e-5 * max(1, |ref|max)``; an above bit
may differ only on the threshold's knife edge (margin within 1e-5 of
energy*T), since the two smoothing scans round in another order; kernel B
tables must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels.streaming import minn_rtl_metric_planar  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import MinnRTLDetector  # noqa: E402
from ofdm_sync_tpu_torch.ops.detect import extract_gate_events  # noqa: E402
from ofdm_sync_tpu_torch.ops.waveforms import build_minn_rtl_preamble  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import common  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402

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
    F.reset_launch_counts()
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
    assert F.launch_counts()["minn_rtl_metric"] == 1
    assert F.launch_counts()["gate_events"] == 2


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
