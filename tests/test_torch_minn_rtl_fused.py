"""Port's fused Minn-RTL detect vs the JAX fused kernels.

On the CPU the port's `minn_rtl_detect_fused` runs the plain versions of
its two CUDA kernels; the JAX side runs both TPU kernels in Pallas
interpret mode: `minn_rtl_detect_fused_tm` (time-major, the bench
headline) and `minn_rtl_detect_fused_pallas(channel_leading=True)`.
Tables must match field by field; `peak_value` within
``1e-4 * max(1, |ref|max)`` (the JAX kernels sum windows in float32, the
port in float64).  The stimulus is that of tests/test_pallas_minn_tm.py
(Q = 64, R = 512).  The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels.pallas_minn import minn_rtl_detect_fused_pallas  # noqa: E402
from ofdm_sync_tpu.kernels.pallas_minn_tm import (  # noqa: E402
    minn_rtl_detect_fused_tm,
    to_time_tiled,
)
from ofdm_sync_tpu.parallel.shard import _minn_halo_width  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import (  # noqa: E402
    launch_counts,
    mode_launch_counts,
    reset_launch_counts,
)
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402

Q = 64
R = 512
KW = dict(smooth_shift=3, threshold_value=3276, threshold_frac_bits=15)
PEAK_RTOL = 1e-4


def _stimulus(rng, batch, L, events_at=(), q=Q):
    x = (0.25 * rng.standard_normal((4, batch, L))).astype(np.float32)
    A = rng.standard_normal(q) + 1j * rng.standard_normal(q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    for b, pos in events_at:
        for c, comp in ((0, pre.real), (1, pre.imag), (2, pre.real), (3, pre.imag)):
            x[c, b, pos: pos + 5 * q] += 3 * comp.astype(np.float32)
    return x


def _check_all(x, *, q=Q, h=2, E=8, tie="last", emit=False):
    """Port (CPU) vs JAX lane-major vs JAX time-major, on one input."""
    _, batch, L = x.shape
    kw = dict(quarter_len=q, **KW, hysteresis=h, max_events=E, tie=tie,
              emit_unclosed=emit)
    out = F.minn_rtl_detect_fused(torch.from_numpy(x), **kw)
    cl = jnp.asarray(x)
    lane = minn_rtl_detect_fused_pallas(cl, **kw, block=1024, channel_leading=True)
    xt, _, _ = to_time_tiled(cl, R)
    tm = minn_rtl_detect_fused_tm(xt, **kw, rows=R, stream_len=L, batch=batch)
    assert_tables_equal(lane, out, "vs lane-major", peak_rtol=PEAK_RTOL)
    assert_tables_equal(tm, out, "vs time-major", peak_rtol=PEAK_RTOL)
    return out


@pytest.mark.parametrize("tie,emit,h", [("last", False, 2), ("first", True, 5)])
def test_fused_matches_jax_kernels(rng, tie, emit, h):
    """Events spanning block boundaries, several gates, a noise floor."""
    batch, L = 6, 4 * R - 100
    events = [(0, 300), (1, R - 3 * Q), (2, 2 * R - Q), (3, 700),
              (3, 2 * R + 200), (5, 3 * R - 300)]
    out = _check_all(_stimulus(rng, batch, L, events), h=h, tie=tie, emit=emit)
    assert int(out.count.sum()) >= len(events) - 2


def test_fused_int16_matches_jax_kernels(rng):
    """int16 ADC codes go in as they are on both sides."""
    batch, L = 3, 3 * R + 11
    x = _stimulus(rng, batch, L, [(0, 200), (2, 900)])
    xi = np.round(x * 400).astype(np.int16)
    out = _check_all(xi)
    assert int(out.count.sum()) >= 2


def test_fused_zero_signal_unclosed(rng):
    """Zero stream -> threshold trivially met -> one unclosed gate."""
    x = np.zeros((4, 3, 2 * R), np.float32)
    out = _check_all(x, h=1, E=3, emit=True)
    assert out.count.tolist() == [1, 1, 1] and not out.closed.any()


def test_fused_stream_length_padding(rng):
    """L not a multiple of anything; a gate runs into the stream end."""
    L = 2 * R + 37
    _check_all(_stimulus(rng, 2, L, [(0, L - 6 * Q), (1, 500)]))


def test_fused_non_power_of_two_q(rng):
    qn, batch, L = 48, 3, 3 * R
    x = _stimulus(rng, batch, L, [(0, 400), (1, R - qn), (2, 2 * R - 300)], q=qn)
    out = _check_all(x, q=qn)
    assert int(out.count.sum()) >= 2


def test_metric_halo_matches_shard_halo():
    """Kernel A's halo is the sharded path's halo without the h gate tail
    (1792 samples at the flagship Q = 512, smooth_shift 3)."""
    for q, s in ((512, 3), (64, 3), (16, 0), (24, 5)):
        assert F.metric_halo(q, s) == _minn_halo_width(q, s, 0)
    assert F.metric_halo(512, 3) == 1792


def test_wrapper_rejects_bad_input():
    x = torch.zeros((3, 2, 100))
    with pytest.raises(ValueError):
        F.minn_rtl_detect_fused(x, quarter_len=8, **KW, hysteresis=2)
    with pytest.raises(TypeError):
        F.minn_rtl_metric(torch.zeros((4, 2, 100), dtype=torch.float64),
                          quarter_len=8, **KW)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent path
        F.minn_rtl_metric(torch.zeros((4, 2, 100), device="meta"), quarter_len=8, **KW)
    with pytest.raises(ValueError):
        F.gate_events(torch.zeros((1, 10), dtype=torch.bool), torch.zeros((1, 10)),
                      hysteresis=2, max_events=129)


def test_cpu_path_counts_no_launch(rng):
    reset_launch_counts()
    F.minn_rtl_detect_fused(torch.from_numpy(_stimulus(rng, 2, 1000)), quarter_len=Q,
                            **KW, hysteresis=2)
    assert launch_counts() == dict.fromkeys(
        ("minn_rtl_metric", "gate_events", "aa_metric", "zc_metric", "matched_filter_ols",
         "minn_rtl_step"), 0)


@pytest.mark.parametrize("dtype,C,q,hist,exact", [
    (torch.int16, 4, 512, False, True),     # the sweep cell's codes
    (torch.int16, 2, 37, False, True),
    (torch.float32, 4, 512, False, False),  # float32 input
    (torch.int16, 4, 512, True, False),     # a float history
    (torch.int16, 8, 512, False, False),    # more than two branches
    (torch.int16, 4, 4481, False, False),   # its rings past the shared memory
])
def test_exact_path_follows_the_input(monkeypatch, dtype, C, q, hist, exact):
    """Kernel A's wrapper picks the exact int16 path from what the input
    shows (dtype, a history, the branches, its shared memory) and counts
    the launch as exact_i16; a fake library stands in for the card."""
    calls = []

    class Library:
        def minn_rtl_metric(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(F.build, "library", Library)
    monkeypatch.setattr(F, "check_kernel_device", lambda *t: "cuda")
    monkeypatch.setattr(F, "_stream", lambda x: 0)
    reset_launch_counts()
    try:
        x = torch.zeros((C, 2, 4096), dtype=dtype)
        h = torch.zeros((C, 2, 3 * q)) if hist else None
        F.minn_rtl_metric(x, quarter_len=q, **KW, hist_init=h)
        assert len(calls) == 1 and calls[0][:2] == (int(dtype == torch.int16), int(exact))
        assert mode_launch_counts().get("minn_rtl_metric/exact_i16", 0) == int(exact)
    finally:
        reset_launch_counts()
