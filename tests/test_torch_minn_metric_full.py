"""Port's kernel-A modes vs the JAX TPU kernels #2, #3 and #4.

On the CPU the port's wrappers run kernel A's plain versions:
`minn_rtl_metric_planar_fused` (#3, `pallas_minn.py:_minn_kernel`),
`minn_rtl_corr_energy_planar_fused` (#4, `_corr_energy_kernel`),
`minn_rtl_detect_planar_fused` (#3 then kernel B, the counterpart of
`minn_rtl_detect_planar_pallas`) and `minn_rtl_detect_fused` in its
carried-state mode (#2 with base_index / shard_init / emit_state).  The JAX
side runs in Pallas interpret mode.

The stimulus is integer-valued (float32 or int16), so corr_positive and
energy_total are exact on both sides and must be equal; smooth_metric
within SMOOTH_RTOL of max|smooth| and the emitted register within
SMOOTH_RTOL (the TPU kernel's truncated log-depth scan and the port's
recurrence round in another order);
above_threshold and event tables equal.  Q = 48 takes the TPU kernel's
non-power-of-two window branch (`pallas_minn.py:107-109`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels.pallas_minn import (  # noqa: E402
    minn_rtl_corr_energy_planar_pallas,
    minn_rtl_detect_fused_pallas,
    minn_rtl_detect_planar_pallas,
    minn_rtl_metric_planar_pallas,
)
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import (  # noqa: E402
    launch_counts,
    mode_launch_counts,
    reset_launch_counts,
)
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402

KW = dict(smooth_shift=3, threshold_value=3276, threshold_frac_bits=15)
SMOOTH_RTOL = 1e-6
BLOCK = 1024


def _stimulus(batch, L, q, events, seed=0):
    """(4, batch, L) integer-valued float32: noise round(8 N(0,1)) plus 5Q
    preambles [-A, A, A, -A, -A] as round(72 x) on both branches."""
    rng = np.random.default_rng(seed)
    x = np.round(8 * rng.standard_normal((4, batch, L)))
    A = rng.standard_normal(q) + 1j * rng.standard_normal(q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    for b, pos in events:
        for c, comp in ((0, pre.real), (1, pre.imag), (2, pre.real), (3, pre.imag)):
            x[c, b, pos: pos + 5 * q] += np.round(72 * comp)
    return x.astype(np.float32)


def _assert_smooth_close(out, ref):
    """|out - ref| <= SMOOTH_RTOL * (|ref| + max|ref|): relative to the
    array's scale, since the warm-up values are near zero."""
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=SMOOTH_RTOL,
                               atol=SMOOTH_RTOL * float(np.abs(ref).max()))


def _natural(x):
    """channel-leading (4, batch, L) -> (batch, 2, 2, L)."""
    C, batch, L = x.shape
    return np.ascontiguousarray(x.transpose(1, 0, 2).reshape(batch, C // 2, 2, L))


CASES = [(32, np.float32), (48, np.float32), (32, np.int16), (48, np.int16)]


@pytest.mark.parametrize("q,dt", CASES)
def test_full_metric_matches_jax(q, dt):
    batch, L = 3, 3 * BLOCK + 77
    x = _stimulus(batch, L, q, [(0, 300), (1, BLOCK - 2 * q), (2, 2 * BLOCK + 100)],
                  seed=q).astype(dt)
    j = minn_rtl_metric_planar_pallas(jnp.asarray(x), quarter_len=q, **KW, block=BLOCK,
                                      channel_leading=True)
    t = F.minn_rtl_metric_planar_fused(torch.from_numpy(x), quarter_len=q, **KW)
    np.testing.assert_array_equal(t.corr_positive.numpy(), np.asarray(j.corr_positive))
    np.testing.assert_array_equal(t.energy_total.numpy(), np.asarray(j.energy_total))
    _assert_smooth_close(t.smooth_metric.numpy(), j.smooth_metric)
    np.testing.assert_array_equal(t.above_threshold.numpy(), np.asarray(j.above_threshold))
    assert t.valid_from == j.valid_from == 3 * q - 1
    assert int(t.above_threshold.sum()) > 0


@pytest.mark.parametrize("q,dt", CASES)
def test_corr_energy_matches_jax(q, dt):
    batch, L = 3, 2 * BLOCK + 5
    x = _stimulus(batch, L, q, [(1, 700)], seed=100 + q).astype(dt)
    jc, je = minn_rtl_corr_energy_planar_pallas(jnp.asarray(x), quarter_len=q, block=BLOCK,
                                                channel_leading=True)
    tc, te = F.minn_rtl_corr_energy_planar_fused(torch.from_numpy(x), quarter_len=q)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("q", [32, 48])
def test_detect_planar_matches_jax(q):
    batch, L = 3, 3 * BLOCK + 77
    x = _stimulus(batch, L, q, [(0, 300), (1, BLOCK - 2 * q), (2, 2 * BLOCK + 100),
                                (2, 500)], seed=200 + q)
    jst, jt = minn_rtl_detect_planar_pallas(jnp.asarray(_natural(x)), quarter_len=q, **KW,
                                            hysteresis=2, block=BLOCK)
    tst, tt = F.minn_rtl_detect_planar_fused(torch.from_numpy(x), quarter_len=q, **KW,
                                             hysteresis=2)
    assert_tables_equal(jt, tt, "detect_planar")
    np.testing.assert_array_equal(tst.corr_positive.numpy(), np.asarray(jst.corr_positive))
    assert int(tt.count.sum()) >= 3


@pytest.mark.parametrize("dt", [np.float32, np.int16])
def test_primed_detect_matches_jax_shard_mode(dt):
    """`minn_rtl_detect_fused` with base_index / shard_init / emit_state vs
    `minn_rtl_detect_fused_pallas` with the same arguments: a random IQ
    history, smoothing register and gate carry, a finite global length."""
    q, batch, n = 32, 3, 2 * BLOCK
    rng = np.random.default_rng(300)
    x = _stimulus(batch, n, q, [(0, 100), (1, BLOCK - 50)], seed=301).astype(dt)
    hist = np.round(8 * rng.standard_normal((4, batch, 128))).astype(np.float32)
    carry = (1e3 * rng.random(batch)).astype(np.float32)
    gate = np.array([[4999, 1], [-1, 0], [4998, 1]], np.int32)
    kw = dict(quarter_len=q, **KW, hysteresis=2, emit_unclosed=True, base_index=5000,
              stream_len_global=5000 + n + 40)
    jt, (jc, jg) = minn_rtl_detect_fused_pallas(
        jnp.asarray(x), **kw, block=BLOCK, channel_leading=True,
        shard_init=(jnp.asarray(hist), jnp.asarray(carry), jnp.asarray(gate)), emit_state=True)
    tt, (tc, tg) = F.minn_rtl_detect_fused(
        torch.from_numpy(x), **kw, emit_state=True,
        shard_init=(torch.from_numpy(hist), torch.from_numpy(carry), torch.from_numpy(gate)))
    assert_tables_equal(jt, tt, "primed detect")
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=SMOOTH_RTOL)
    assert int(tt.count.sum()) >= 2


def test_primed_metric_continues_the_stream():
    """Kernel A's primed mode over the second half of a stream, given the
    first half's tail and register, equals the one-shot metric there."""
    q, batch, L = 32, 2, 2 * BLOCK
    x = torch.from_numpy(_stimulus(batch, L, q, [(0, BLOCK - 40), (1, 300)], seed=400))
    one = F.minn_rtl_metric_planar_fused(x, quarter_len=q, **KW)
    h = BLOCK
    tail = x[..., h - 128: h]
    second = F.minn_rtl_metric_planar_fused(
        x[..., h:].contiguous(), quarter_len=q, **KW, base_index=h, hist_init=tail,
        carry_init=one.smooth_metric[:, h - 1])
    torch.testing.assert_close(second.corr_positive, one.corr_positive[:, h:], rtol=0, atol=0)
    torch.testing.assert_close(second.energy_total, one.energy_total[:, h:], rtol=0, atol=0)
    _assert_smooth_close(second.smooth_metric, one.smooth_metric[:, h:])
    assert torch.equal(second.above_threshold, one.above_threshold[:, h:])
    c, e = F.minn_rtl_corr_energy_planar_fused(x[..., h:].contiguous(), quarter_len=q,
                                               hist_init=tail)
    assert torch.equal(c, one.corr_positive[:, h:]) and torch.equal(e, one.energy_total[:, h:])
    _, _, carry = F.minn_rtl_metric(x[..., h:].contiguous(), quarter_len=q, **KW, base_index=h,
                                    hist_init=tail, carry_init=one.smooth_metric[:, h - 1],
                                    emit_state=True)
    torch.testing.assert_close(carry, one.smooth_metric[:, -1], rtol=SMOOTH_RTOL, atol=0)


def test_modes_reject_bad_input():
    x = torch.zeros((4, 2, 300))
    with pytest.raises(ValueError):  # a history of the wrong lead shape
        F.minn_rtl_metric_planar_fused(x, quarter_len=8, **KW, hist_init=torch.zeros((4, 3, 24)))
    with pytest.raises(ValueError):
        F.minn_rtl_metric(x, quarter_len=8, **KW, carry_init=torch.zeros(3))
    with pytest.raises(ValueError):  # a base index on the card would need a sync
        F.host_index(torch.zeros((), device="meta"))
    with pytest.raises(ValueError):
        F.check_index_range(2**31 - 10, 300)
    with pytest.raises(ValueError):  # gate_init of the wrong shape
        F.gate_events(torch.zeros((2, 10), dtype=torch.bool), torch.zeros((2, 10)),
                      hysteresis=2, gate_init=torch.zeros((3, 2), dtype=torch.int32))


def test_cpu_modes_count_no_launch():
    reset_launch_counts()
    x = torch.from_numpy(_stimulus(2, 1000, 32, [(0, 200)]))
    F.minn_rtl_metric_planar_fused(x, quarter_len=32, **KW)
    F.minn_rtl_corr_energy_planar_fused(x, quarter_len=32)
    F.minn_rtl_detect_fused(x, quarter_len=32, **KW, hysteresis=2, base_index=7,
                            emit_state=True)
    assert not any(launch_counts().values()) and mode_launch_counts() == {}
