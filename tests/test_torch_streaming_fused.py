"""Port's fused streaming steps vs the JAX fused steps, chunk by chunk.

`minn_rtl_fused_stream_step`, `aa_fused_stream_step` and
`zc_cfar_fused_stream_step` of the port run, on CPU tensors, the plain
versions of kernels A + B, C + B and D + B in their carried-state modes;
the JAX steps run `pallas_minn.py` / `pallas_aa.py` / `pallas_zc.py` in
Pallas interpret mode.  Sizes are those of tests/test_streaming_fused.py
(Q = 32, chunks of 1024, four steps).

The stimulus is integer-valued (Minn, [A][A]) or dyadic (ZC magnitudes),
so every window sum is exact on both sides: each chunk's table must equal
JAX's field by field (peak values included) and so must the gate carry
``gate_out``.  The smoothing register ``carry_out`` may differ by the
rounding of the two smoothing scans: relative tolerance CARRY_RTOL.
Stitched tables must equal the one-shot tables.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels import streaming_chunked as J  # noqa: E402
from ofdm_sync_tpu.kernels.pallas_aa import aa_detect_fused_pallas  # noqa: E402
from ofdm_sync_tpu.kernels.pallas_minn import minn_rtl_detect_fused_pallas  # noqa: E402
from ofdm_sync_tpu.kernels.pallas_zc import zc_cfar_detect_pallas  # noqa: E402
from ofdm_sync_tpu_torch.kernels import streaming_chunked as T  # noqa: E402
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import (  # noqa: E402
    minn_rtl_detect_fused,
    minn_rtl_metric_planar_fused,
)
from ofdm_sync_tpu_torch.kernels.zc_fused import zc_cfar_detect  # noqa: E402
from ofdm_sync_tpu_torch.testing import aa_stimulus, assert_tables_equal  # noqa: E402

Q = 32
PARAMS = dict(quarter_len=Q, smooth_shift=3, threshold_value=3276, threshold_frac_bits=15,
              hysteresis=2, max_events=8, tie="last")
KW = {k: v for k, v in PARAMS.items()}
CHUNK = 1024
L = 4 * CHUNK
#: the smoothing register: the port's plain scan and the TPU kernel's
#: truncated log-depth scan round in another order
CARRY_RTOL = 1e-6


def _minn_stream(batch, positions, seed=0):
    """(4, batch, L) float32 integer-valued: noise round(8 N(0,1)) plus 5Q
    preambles [-A, A, A, -A, -A] scaled to round(72 x) at ``positions``."""
    rng = np.random.default_rng(seed)
    x = np.round(8 * rng.standard_normal((4, batch, L)))
    A = rng.standard_normal(Q) + 1j * rng.standard_normal(Q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    for b, ps in enumerate(positions):
        for p in ps:
            for c, comp in ((0, pre.real), (1, pre.imag), (2, 0.8 * pre.real),
                            (3, 0.8 * pre.imag)):
                x[c, b, p: p + 5 * Q] += np.round(72 * comp)
    return x.astype(np.float32)


def _jax_params():
    return J.MinnRTLStreamParams(**PARAMS)


def _t_params():
    return T.MinnRTLStreamParams(**PARAMS)


def _check_state(ts, js, what):
    np.testing.assert_array_equal(ts.gate.numpy(), np.asarray(js.gate), err_msg=what)
    np.testing.assert_array_equal(ts.hist.numpy(), np.asarray(js.hist), err_msg=what)
    assert int(ts.base) == int(js.base), what


def _run_minn(x, chunk=CHUNK):
    """Both steps chunk by chunk; every table, gate and carry compared.
    Returns (port tables, port state)."""
    jp, tp = _jax_params(), _t_params()
    batch = x.shape[1]
    js = J.minn_rtl_fused_stream_init(jp, batch)
    ts = T.minn_rtl_fused_stream_init(tp, batch, device="cpu")
    tables = []
    for o in range(0, x.shape[-1], chunk):
        js, jt = J.minn_rtl_fused_stream_step(js, jnp.asarray(x[..., o: o + chunk]), params=jp)
        ts, tt = T.minn_rtl_fused_stream_step(ts, torch.from_numpy(x[..., o: o + chunk]),
                                              params=tp)
        assert_tables_equal(jt, tt, f"chunk at {o}")
        _check_state(ts, js, f"state after {o}")
        np.testing.assert_allclose(ts.carry.numpy(), np.asarray(js.carry), rtol=CARRY_RTOL)
        tables.append(tt)
    return tables, ts


def _check_stitched(tables, ref, b, **kw):
    got = T.stitch_chunk_tables([t.select(b) for t in tables], stream_end=L,
                                emit_unclosed=True, **kw)
    k = int(ref.count[b])
    assert len(got) == k, (b, got)
    for e in range(k):
        assert got[e]["start"] == int(ref.gate_start[b, e])
        assert got[e]["close"] == int(ref.gate_close[b, e])
        assert got[e]["pidx"] == int(ref.peak_idx[b, e])
        assert got[e]["closed"] == bool(ref.closed[b, e])
        assert got[e]["pval"] == float(ref.peak_value[b, e])
    return got


@pytest.mark.parametrize("seam", [False, True])
def test_fused_stream_matches_jax_and_oneshot(seam):
    """Chunk by chunk against JAX; stitched against the port's one-shot
    table; preambles inside chunks or straddling the seams."""
    batch = 3
    if seam:
        positions = [[CHUNK - 3 * Q], [2 * CHUNK - 2 * Q, 3 * CHUNK - 4 * Q], [CHUNK - Q]]
    else:
        positions = [[300], [900, 2600], [3500]]
    x = _minn_stream(batch, positions, seed=int(seam))
    tables, _ = _run_minn(x)
    ref = minn_rtl_detect_fused(torch.from_numpy(x), **KW, emit_unclosed=True)
    for b in range(batch):
        assert len(_check_stitched(tables, ref, b, hysteresis=2)) >= 1


def test_fused_stream_carry_matches_oneshot_smooth():
    """The emitted smoothing register equals the one-shot full metric's
    last smooth value (#3) within CARRY_RTOL, as the JAX test pins it to the
    one-shot TPU kernel."""
    x = _minn_stream(2, [[500], [2000]], seed=2)
    _, ts = _run_minn(x)
    st = minn_rtl_metric_planar_fused(torch.from_numpy(x), quarter_len=Q, smooth_shift=3,
                                      threshold_value=3276, threshold_frac_bits=15)
    torch.testing.assert_close(ts.carry, st.smooth_metric[:, -1], rtol=CARRY_RTOL, atol=0)


def test_fused_stream_quiet_tail_and_continued_gate():
    """A stream ending in silence keeps a stale gate carry; a gate carried
    into a chunk with no above sample of its own surfaces with close h - 1
    (its last above index stays -1), and the stitch absorbs it."""
    x = _minn_stream(1, [[200, 3 * CHUNK + 200]], seed=3)
    tables, ts = _run_minn(x)
    got = T.stitch_chunk_tables([t.select(0) for t in tables], hysteresis=2, stream_end=L)
    ref = minn_rtl_detect_fused(torch.from_numpy(x), **KW)
    assert len(got) == int(ref.count[0]) >= 2
    # a preamble ending exactly at a seam continues into the next chunk
    x = _minn_stream(1, [[CHUNK - 5 * Q - 20]], seed=4)
    tables, _ = _run_minn(x)
    ref = minn_rtl_detect_fused(torch.from_numpy(x), **KW, emit_unclosed=True)
    _check_stitched(tables, ref, 0, hysteresis=2)


def test_fused_stream_rebase_epoch():
    """After a rebase, indices restart at 3Q - 1: an event at P of the new
    epoch reports P + 3Q - 1, as in JAX."""
    x1 = _minn_stream(1, [[500]], seed=5)
    x2 = _minn_stream(1, [[CHUNK + 700]], seed=6)
    tp, jp = _t_params(), _jax_params()
    ts = T.minn_rtl_fused_stream_init(tp, 1, device="cpu")
    js = J.minn_rtl_fused_stream_init(jp, 1)
    for o in range(0, L, 2 * CHUNK):
        ts, _ = T.minn_rtl_fused_stream_step(ts, torch.from_numpy(x1[..., o: o + 2 * CHUNK]),
                                             params=tp)
        js, _ = J.minn_rtl_fused_stream_step(js, jnp.asarray(x1[..., o: o + 2 * CHUNK]),
                                             params=jp)
    ts = T.minn_rtl_fused_stream_rebase(ts, params=tp)
    js = J.minn_rtl_fused_stream_rebase(js, params=jp)
    _check_state(ts, js, "after rebase")
    tables = []
    for o in range(0, L, 2 * CHUNK):
        ts, tt = T.minn_rtl_fused_stream_step(ts, torch.from_numpy(x2[..., o: o + 2 * CHUNK]),
                                              params=tp)
        js, jt = J.minn_rtl_fused_stream_step(js, jnp.asarray(x2[..., o: o + 2 * CHUNK]),
                                              params=jp)
        assert_tables_equal(jt, tt, f"epoch 2 at {o}")
        tables.append(tt)
    got = T.stitch_chunk_tables([t.select(0) for t in tables], hysteresis=2,
                                stream_end=L + 3 * Q - 1, emit_unclosed=True)
    ref = minn_rtl_detect_fused(torch.from_numpy(x2), **KW, emit_unclosed=True)
    assert got[0]["pidx"] == int(ref.peak_idx[0, 0]) + 3 * Q - 1


def test_fused_state_checkpoint_roundtrip():
    """A fused state survives torch.save / torch.load mid-stream."""
    x = torch.from_numpy(_minn_stream(2, [[900], [1500]], seed=7))
    tp = _t_params()
    s = T.minn_rtl_fused_stream_init(tp, 2, device="cpu")
    s, _ = T.minn_rtl_fused_stream_step(s, x[..., :CHUNK], params=tp)
    buf = io.BytesIO()
    torch.save(s, buf)
    buf.seek(0)
    r = torch.load(buf)
    assert isinstance(r, T.MinnRTLFusedStreamState)
    a, ta = T.minn_rtl_fused_stream_step(s, x[..., CHUNK: 2 * CHUNK], params=tp)
    b, tb = T.minn_rtl_fused_stream_step(r, x[..., CHUNK: 2 * CHUNK], params=tp)
    assert_tables_equal(ta, tb, "restored")
    for fa, fb in zip(a, b):
        assert torch.equal(fa, fb)


# ---------------------------------------------------------------------------
# [A][A] fused streaming


AA_L = 128
AA_CHUNK = 1024
AA_LEN = 4 * AA_CHUNK


@pytest.mark.parametrize("seam", [False, True])
def test_aa_fused_stream_matches_jax(seam):
    """Chunk by chunk against JAX, P / M captures through the stitch
    (``tie_last=False``), stitched equal to the port's one-shot table."""
    from ofdm_sync_tpu_torch.kernels.aa_fused import aa_detect_fused

    batch = 2
    events = ([(0, AA_CHUNK - AA_L), (1, 2 * AA_CHUNK - AA_L // 2)] if seam
              else [(0, 700), (1, 2200)])
    x = aa_stimulus(batch, AA_LEN, AA_L, "cpu", seed=9 + seam, events=events)
    xn = x.numpy()
    js = J.aa_fused_stream_init(AA_L, batch)
    ts = T.aa_fused_stream_init(AA_L, batch, device="cpu")
    tables, extras = [], []
    for o in range(0, AA_LEN, AA_CHUNK):
        js, (jt, jP, jM) = J.aa_fused_stream_step(js, jnp.asarray(xn[..., o: o + AA_CHUNK]),
                                                  half_len=AA_L)
        ts, (tt, tP, tM) = T.aa_fused_stream_step(ts, x[..., o: o + AA_CHUNK], half_len=AA_L)
        assert_tables_equal(jt, tt, f"aa chunk at {o}")
        np.testing.assert_array_equal(tP.numpy(), np.asarray(jP))
        np.testing.assert_array_equal(tM.numpy(), np.asarray(jM))
        _check_state(ts, js, f"aa state after {o}")
        tables.append(tt)
        extras.append((tP, tM))
    ref, rP, rM = aa_detect_fused(x, half_len=AA_L, emit_unclosed=True)
    for b in range(batch):
        got = _check_stitched(tables, ref, b, hysteresis=128, tie_last=False, extras_list=[
            {"p_re": P[b, 0], "p_im": P[b, 1], "m": M[b]} for P, M in extras])
        assert len(got) >= 1
        for e, ev in enumerate(got):
            assert ev["extras"]["p_re"] == rP[b, 0, e] and ev["extras"]["p_im"] == rP[b, 1, e]
            assert ev["extras"]["m"] == rM[b, e]


def test_aa_primed_detect_matches_jax_shard_mode():
    """`aa_detect_fused` in its carried-state mode vs `aa_detect_fused_pallas`."""
    from ofdm_sync_tpu_torch.kernels.aa_fused import aa_detect_fused

    batch, n = 2, AA_CHUNK
    x = aa_stimulus(batch, n, AA_L, "cpu", seed=12, events=[(0, 30), (1, 600)])
    rng = np.random.default_rng(12)
    hist = np.round(8 * rng.standard_normal((4, batch, 256))).astype(np.float32)
    gate = np.array([[9999, 1], [-1, 0]], np.int32)
    kw = dict(half_len=AA_L, emit_unclosed=True, base_index=10_000,
              stream_len_global=10_000 + n - 100)
    jt, jP, jM, jg = aa_detect_fused_pallas(
        jnp.asarray(x.numpy()), **kw, block=n, channel_leading=True,
        shard_init=(jnp.asarray(hist), jnp.asarray(gate)), emit_state=True)
    tt, tP, tM, tg = aa_detect_fused(x, **kw, emit_state=True,
                                     shard_init=(torch.from_numpy(hist), torch.from_numpy(gate)))
    assert_tables_equal(jt, tt, "aa primed")
    np.testing.assert_array_equal(tP.numpy(), np.asarray(jP))
    np.testing.assert_array_equal(tM.numpy(), np.asarray(jM))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


# ---------------------------------------------------------------------------
# ZC CFAR fused streaming (matched-filter magnitudes in)


def _zc_mags(batch, n, bursts, seed):
    """Dyadic magnitudes (multiples of 1/64): noise floor plus peak bursts."""
    rng = np.random.default_rng(seed)
    m = 0.02 * np.abs(rng.standard_normal((batch, n)))
    for b, centers in enumerate(bursts):
        for c in centers:
            m[b, c - 3: c + 4] += [0.4, 0.8, 1.5, 2.0, 1.5, 0.8, 0.4]
    return (np.round(64 * m) / 64).astype(np.float32)


def test_zc_cfar_fused_stream_matches_jax():
    W, CH = 512, 1024
    N = 4 * CH
    batch = 2
    x = _zc_mags(batch, N, [[CH - 4, 2500], [2 * CH - 2]], seed=13)
    kw = dict(corr_window=W, hysteresis=64, max_events=8)
    js = J.zc_cfar_fused_stream_init(W, batch)
    ts = T.zc_cfar_fused_stream_init(W, batch, device="cpu")
    tables = []
    for o in range(0, N, CH):
        js, jt = J.zc_cfar_fused_stream_step(js, jnp.asarray(x[:, o: o + CH]), **kw)
        ts, tt = T.zc_cfar_fused_stream_step(ts, torch.from_numpy(x[:, o: o + CH]), **kw)
        assert_tables_equal(jt, tt, f"zc chunk at {o}")
        _check_state(ts, js, f"zc state after {o}")
        tables.append(tt)
    ref = zc_cfar_detect(torch.from_numpy(x), **kw, emit_unclosed=True)
    for b in range(batch):
        got = T.stitch_chunk_tables([t.select(b) for t in tables], hysteresis=64,
                                    stream_end=N, emit_unclosed=True, tie_last=False)
        assert len(got) == int(ref.count[b]) >= 1
        for e, ev in enumerate(got):
            assert (ev["start"], ev["pidx"]) == (int(ref.gate_start[b, e]),
                                                 int(ref.peak_idx[b, e]))
            assert ev["pval"] == float(ref.peak_value[b, e])


def test_zc_primed_detect_matches_jax_shard_mode():
    W, n, batch = 512, 1024, 2
    x = _zc_mags(batch, n, [[40], [700]], seed=14)
    hist = _zc_mags(batch, 640, [[], []], seed=15)
    gate = np.array([[20_000 - 30, 1], [-1, 0]], np.int32)
    kw = dict(corr_window=W, hysteresis=64, max_events=8, emit_unclosed=True,
              base_index=20_000, stream_len_global=20_000 + n)
    jt, jg = zc_cfar_detect_pallas(jnp.asarray(x), **kw, block=n,
                                   shard_init=(jnp.asarray(hist), jnp.asarray(gate)),
                                   emit_state=True)
    tt, tg = zc_cfar_detect(torch.from_numpy(x), **kw, emit_state=True,
                            shard_init=(torch.from_numpy(hist), torch.from_numpy(gate)))
    assert_tables_equal(jt, tt, "zc primed")
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_stitch_rejects_batched_tables_and_warns_on_overflow():
    x = torch.from_numpy(_minn_stream(2, [[300], [900]], seed=16)[..., :CHUNK])
    s = T.minn_rtl_fused_stream_init(_t_params(), 2, device="cpu")
    _, t = T.minn_rtl_fused_stream_step(s, x, params=_t_params())
    with pytest.raises(ValueError):
        T.stitch_chunk_tables([t], hysteresis=2)
    over = t.select(0)._replace(overflow=torch.tensor(True))
    with pytest.warns(RuntimeWarning):
        T.stitch_chunk_tables([over], hysteresis=2)
    assert jax.tree.leaves(J.minn_rtl_fused_stream_init(_jax_params(), 1))
