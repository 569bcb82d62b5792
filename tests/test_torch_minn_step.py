"""Kernel F's function, the Minn-RTL stream step, against the JAX step.

`minn_rtl_step_plain` (the composition kernel F computes in one launch)
and the port's `minn_rtl_fused_stream_step` run on CPU tensors here, where
the step's wrapper takes the plain composition; JAX's
`streaming_chunked.minn_rtl_fused_stream_step` runs
`minn_rtl_detect_fused_pallas` in Pallas interpret mode, as the JAX
package's own tests run it.  Q = 32, two branches, batch 1 and 3, chunks of
128 and 512, float32 and int16 codes; stimuli from NumPy with a seed,
integer-valued (noise round(8 N(0, 1)) plus 5Q preambles), so every window
sum is exact on both sides.

Tolerances: each chunk's table equal to JAX's field by field (peak values
included) and so are gate_out and the new history; the smoothing register
``carry`` within CARRY_RTOL relative (the port's plain recurrence and the
TPU kernel's truncated log-depth scan round in another order), the bound
`test_torch_streaming_fused.py` uses.  The first `gpu` test holds kernel F
on the card to the plain step: tables and gate equal, the register within
1e-5 of max(1, |register|) (the kernel's chunk-parallel scan against the
plain recurrence), history equal.  The second holds F to its composition on
the card, kernels A and B, bit for bit: the two walk the metric with one
device function.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels import streaming_chunked as T  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import launch_counts, reset_launch_counts  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402

Q = 32
PARAMS = dict(quarter_len=Q, smooth_shift=3, threshold_value=3276, threshold_frac_bits=15,
              hysteresis=2, max_events=8, tie="last")
H_HYST = PARAMS["hysteresis"]
CARRY_RTOL = 1e-6
L = 2048


def _stream(batch, positions, seed, n=L, q=Q):
    """(4, batch, n) float32 integer-valued: round(8 N(0,1)) noise plus 5q
    preambles [-A, A, A, -A, -A] scaled to round(72 x) (the second branch
    0.8 of it) at ``positions``; a preamble may run past the end."""
    rng = np.random.default_rng(seed)
    x = np.round(8 * rng.standard_normal((4, batch, n)))
    A = rng.standard_normal(q) + 1j * rng.standard_normal(q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    for b, ps in enumerate(positions):
        for p in ps:
            k = min(5 * q, n - p)
            for c, comp in ((0, pre.real), (1, pre.imag), (2, 0.8 * pre.real),
                            (3, 0.8 * pre.imag)):
                x[c, b, p: p + k] += np.round(72 * comp[:k])
    return x.astype(np.float32)


def _jax():
    """JAX's stream-step module and jax.numpy, imported by the tests that
    compare with them, so that the `gpu` test below also runs where JAX
    is not installed (with ``--noconftest``, as tests/test_torch_cuda.py)."""
    import jax.numpy as jnp
    from ofdm_sync_tpu.kernels import streaming_chunked as J

    return J, jnp


def _params():
    J, _ = _jax()
    return J.MinnRTLStreamParams(**PARAMS), T.MinnRTLStreamParams(**PARAMS)


def _check(ts, tt, js, jt, what):
    assert_tables_equal(jt, tt, what)
    np.testing.assert_array_equal(ts.gate.numpy(), np.asarray(js.gate), err_msg=what)
    np.testing.assert_array_equal(ts.hist.numpy(), np.asarray(js.hist), err_msg=what)
    np.testing.assert_allclose(ts.carry.numpy(), np.asarray(js.carry), rtol=CARRY_RTOL,
                               err_msg=what)
    assert int(ts.base) == int(js.base), what


def _chunks(x, chunk, dtype):
    for o in range(0, x.shape[-1], chunk):
        c = x[..., o: o + chunk]
        yield o, (c.astype(np.int16) if dtype == "int16" else c)


def _run(x, chunk, dtype, js=None, ts=None):
    """Both steps over x, chunk by chunk, every table and state compared;
    returns the final states and the port's tables."""
    J, jnp = _jax()
    jp, tp = _params()
    batch = x.shape[1]
    js = J.minn_rtl_fused_stream_init(jp, batch) if js is None else js
    ts = T.minn_rtl_fused_stream_init(tp, batch, device="cpu") if ts is None else ts
    tables = []
    for o, c in _chunks(x, chunk, dtype):
        js, jt = J.minn_rtl_fused_stream_step(js, jnp.asarray(c), params=jp)
        ts, tt = T.minn_rtl_fused_stream_step(ts, torch.from_numpy(c), params=tp)
        _check(ts, tt, js, jt, f"{dtype} chunk {chunk} at {o}")
        tables.append(tt)
    return js, ts, tables


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("chunk", [128, 512])
@pytest.mark.parametrize("batch", [1, 3])
def test_step_matches_jax(batch, chunk, dtype):
    """Gates inside chunks, across 128- and 512-sample seams, and one open
    at the last chunk's edge: every chunk's table and state equal JAX's,
    and the stitched tables equal the one-shot table."""
    # stream 0: a gate across the first 512-sample seam, and one whose
    # above run reaches the last sample (open at the last chunk's edge)
    positions = [[512 - 3 * Q, L - 6 * Q], [300, 1024 - 2 * Q], [1536 - Q, 1700]][:batch]
    x = _stream(batch, positions, seed=batch + chunk)
    _, ts, tables = _run(x, chunk, dtype)
    ref = F.minn_rtl_detect_fused(torch.from_numpy(x), **PARAMS, emit_unclosed=True)
    for b in range(batch):
        got = T.stitch_chunk_tables([t.select(b) for t in tables], hysteresis=H_HYST,
                                    stream_end=L, emit_unclosed=True)
        want = [(int(ref.gate_start[b, e]), int(ref.peak_idx[b, e]), bool(ref.closed[b, e]))
                for e in range(int(ref.count[b]))]
        assert [(e["start"], e["pidx"], e["closed"]) for e in got] == want
    assert any(not e for e in np.asarray(ref.closed[0, : int(ref.count[0])]))  # open at the end


@pytest.mark.parametrize("gap", [H_HYST, H_HYST + 1])
def test_gap_of_h_and_h_plus_one_at_a_seam(gap):
    """The gate carried into a chunk continues iff its last above sample
    lies within h of the seam.  The first chunk ends just after an above
    run, so its last sample is above and the next one below; the next
    chunk's state is given the base ``gap`` after that last above sample.
    Both steps give the same table: at gap h the carried gate holds the
    chunk's first sample, at h + 1 it does not."""
    _, jnp = _jax()
    x = _stream(1, [[700]], seed=11)
    above = F.minn_rtl_metric_planar_fused(
        torch.from_numpy(x), **{k: PARAMS[k] for k in ("quarter_len", "smooth_shift",
                                                       "threshold_value",
                                                       "threshold_frac_bits")}
    ).above_threshold[0]
    ends = [i for i in range(700, L) if above[i - 1] and not above[i]]
    seam = ends[0]
    js, ts, _ = _run(x[..., :seam], seam, "float32")
    la = int(ts.gate[0, 0])
    assert la == seam - 1
    base = la + gap
    js = js._replace(base=jnp.int32(base))
    ts = ts._replace(base=torch.tensor(base, dtype=torch.int32))
    _, _, tables = _run(x[..., seam: seam + 512], 512, "float32", js, ts)
    continued = bool(tables[0].count[0] >= 1 and tables[0].gate_start[0, 0] == base)
    assert continued == (gap <= H_HYST)


def test_rebase_mid_stream():
    """A rebase between chunks on both sides: the next chunks' tables and
    states equal JAX's, indices from 3Q - 1 on."""
    J, _ = _jax()
    jp, tp = _params()
    x = _stream(3, [[300], [900, 1500], [1700]], seed=5)
    js, ts, _ = _run(x[..., :1024], 512, "float32")
    js = J.minn_rtl_fused_stream_rebase(js, params=jp)
    ts = T.minn_rtl_fused_stream_rebase(ts, params=tp)
    assert int(ts.base) == int(js.base) == 3 * Q - 1
    np.testing.assert_array_equal(ts.gate.numpy(), np.asarray(js.gate))
    _, _, tables = _run(x[..., 1024:], 512, "float32", js, ts)
    assert sum(int(t.count.sum()) for t in tables) >= 2


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_plain_step_matches_jax_from_a_carried_state(dtype):
    """`minn_rtl_step_plain` from a state with a random history, register,
    gate carry and base against JAX's step from the same state."""
    J, jnp = _jax()
    jp, tp = _params()
    rng = np.random.default_rng(21)
    batch, n = 3, 512
    x = _stream(batch, [[10], [200], [n - 2 * Q]], seed=22, n=n)
    hist = _stream(batch, [[60], [], [100]], seed=23, n=128)
    carry = (rng.random(batch) * 1e4).astype(np.float32)
    base = 1 << 20
    gate = np.array([[base - 1, 3], [base - H_HYST - 1, 1], [-1, 0]], np.int32)
    js = J.MinnRTLFusedStreamState(hist=jnp.asarray(hist), carry=jnp.asarray(carry),
                                   gate=jnp.asarray(gate), base=jnp.int32(base))
    c = x.astype(np.int16) if dtype == "int16" else x
    js, jt = J.minn_rtl_fused_stream_step(js, jnp.asarray(c), params=jp)
    table, carry_out, gate_out, new_hist = F.minn_rtl_step_plain(
        torch.from_numpy(c), torch.from_numpy(hist), torch.from_numpy(carry),
        torch.from_numpy(gate), base_index=base, **PARAMS, stream_len_global=T.EPOCH_HORIZON)
    assert_tables_equal(jt, table, f"plain step {dtype}")
    np.testing.assert_array_equal(gate_out.numpy(), np.asarray(js.gate))
    np.testing.assert_array_equal(new_hist.numpy(), np.asarray(js.hist))
    assert new_hist.dtype == torch.float32
    np.testing.assert_allclose(carry_out.numpy(), np.asarray(js.carry), rtol=CARRY_RTOL)
    assert int(table.count.sum()) >= 2


def test_step_leaves_the_old_state_unchanged():
    """The state is functional: a step returns fresh tensors and the old
    state's stay as they were, so stepping it again gives the same result."""
    tp = T.MinnRTLStreamParams(**PARAMS)
    x = torch.from_numpy(_stream(2, [[100], [400]], seed=31, n=1024))
    s0 = T.minn_rtl_fused_stream_init(tp, 2, device="cpu")
    s1, _ = T.minn_rtl_fused_stream_step(s0, x[..., :512], params=tp)
    before = [t.clone() for t in s1]
    s2, t2 = T.minn_rtl_fused_stream_step(s1, x[..., 512:], params=tp)
    for a, b in zip(s1, before):
        assert torch.equal(a, b)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(s2[:3], s1[:3]))
    s3, t3 = T.minn_rtl_fused_stream_step(s1, x[..., 512:], params=tp)
    assert_tables_equal(t2, t3, "stepped twice from one state")
    for a, b in zip(s2, s3):
        assert torch.equal(a, b)


def test_wrapper_rejects_a_mixed_device_state():
    """Kernel F's wrapper raises on a state whose tensors lie on another
    device than the chunk (no silent path), and on a state of the wrong
    shape; on the CPU it counts no launch."""
    tp = T.MinnRTLStreamParams(**PARAMS)
    s = T.minn_rtl_fused_stream_init(tp, 2, device="cpu")
    x = torch.from_numpy(_stream(2, [[100], []], seed=41, n=256))
    kw = dict(base_index=0, **PARAMS, stream_len_global=T.EPOCH_HORIZON)
    with pytest.raises(ValueError, match="different devices"):
        F.minn_rtl_step(x, s.hist.to("meta"), s.carry, s.gate, **kw)
    with pytest.raises(ValueError, match="different devices"):
        T.minn_rtl_fused_stream_step(s._replace(gate=s.gate.to("meta")), x, params=tp)
    with pytest.raises(ValueError):
        F.minn_rtl_step(x, s.hist[:, :1], s.carry, s.gate, **kw)
    reset_launch_counts()
    T.minn_rtl_fused_stream_step(s, x, params=tp)
    assert launch_counts()["minn_rtl_step"] == 0


@pytest.mark.gpu
def test_cuda_step_kernel_matches_plain_step():
    """Kernel F on the card against the plain step on the CPU over a short
    stream (Q = 64, batch 3, chunks of 1024 and 4096 codes, float32 and
    int16): tables and gate equal, history equal, the register within 1e-5
    of max(1, |register|); one launch a step.  On the card:
    ``python -m pytest --noconftest -p no:cacheprovider -m gpu
    tests/test_torch_minn_step.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel F has no CPU mode)")
    tp = T.MinnRTLStreamParams(**dict(PARAMS, quarter_len=64))
    x = _stream(3, [[4096 - 3 * 64], [9000], [2000, 16384 - 2 * 64]], seed=51, n=16384, q=64)
    for dtype in (torch.float32, torch.int16):
        for chunk in (1024, 4096):
            xs = torch.from_numpy(x).to(dtype)
            sg = T.minn_rtl_fused_stream_init(tp, 3, device="cuda")
            sc = T.minn_rtl_fused_stream_init(tp, 3, device="cpu")
            reset_launch_counts()
            for o in range(0, xs.shape[-1], chunk):
                c = xs[..., o: o + chunk]
                sg, tg = T.minn_rtl_fused_stream_step(sg, c.cuda(), params=tp)
                sc, tc = T.minn_rtl_fused_stream_step(sc, c, params=tp)
                assert_tables_equal(tc, tg, f"{dtype} chunk {chunk} at {o}")
                assert torch.equal(sg.gate.cpu(), sc.gate)
                assert torch.equal(sg.hist.cpu(), sc.hist)
                err = ((sg.carry.cpu() - sc.carry).abs() / sc.carry.abs().clamp_min(1.0)).max()
                assert float(err) <= 1e-5
            counts = launch_counts()
            assert counts["minn_rtl_step"] == xs.shape[-1] // chunk
            assert counts["minn_rtl_metric"] == counts["gate_events"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("q", [37, 64, 512])
def test_cuda_step_kernel_equals_kernels_a_and_b(q):
    """Kernel F and its composition on the card (`minn_rtl_step_plain`:
    kernel A primed, then kernel B carried) compute one function bit for
    bit: F and A's float path walk the metric with one device function
    (`csrc/minn_walk.cuh`).  From a random state (history, register, gate
    carry, base 2^20), batch 3, chunks of 1024 and 4096 samples of float32
    and int16 codes, each side carrying its own state: every chunk's table
    equal, and carry_out, gate_out and the history `torch.equal`.  An odd Q
    (37) runs the walk's unaligned delayed reads.  On the card:
    ``python -m pytest --noconftest -p no:cacheprovider -m gpu
    tests/test_torch_minn_step.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels A, B and F have no CPU mode)")
    tp = T.MinnRTLStreamParams(**dict(PARAMS, quarter_len=q))
    n, batch, base = 16384, 3, 1 << 20
    x = _stream(batch, [[4096 - 3 * q], [9000], [2000, n - 2 * q]], seed=61 + q, n=n, q=q)
    width = T.minn_rtl_fused_stream_init(tp, batch, device="cpu").hist.shape[-1]
    rng = np.random.default_rng(q)
    state0 = (torch.from_numpy(_stream(batch, [[10], [], [width - 3 * q]], seed=62 + q,
                                       n=width, q=q)).cuda(),
              torch.from_numpy((rng.random(batch) * 1e4).astype(np.float32)).cuda(),
              torch.tensor([[base - 1, 3], [base - H_HYST - 1, 1], [-1, 0]],
                           dtype=torch.int32).cuda())
    events = 0
    for dtype in (torch.float32, torch.int16):
        xs = torch.from_numpy(x).to(dtype).cuda()
        for chunk in (1024, 4096):
            kernel, composed = state0, state0
            reset_launch_counts()
            for o in range(0, n, chunk):
                c, kw = xs[..., o: o + chunk], T.minn_step_kwargs(tp, base + o)
                tf, *out_f = F.minn_rtl_step(c, *kernel, **kw)
                tc, *out_c = F.minn_rtl_step_plain(c, *composed, **kw)
                what = f"Q {q} {dtype} chunk {chunk} at {o}"
                assert_tables_equal(tc, tf, what)
                for name, a, b in zip(("carry_out", "gate_out", "history"), out_f, out_c):
                    assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: {name}"
                # (carry_out, gate_out, history) -> the next state (hist, carry, gate)
                kernel, composed = [(out[2], out[0], out[1]) for out in (out_f, out_c)]
                events += int(tf.count.sum())
            counts = launch_counts()
            assert counts["minn_rtl_step"] == counts["minn_rtl_metric"] == n // chunk
            assert counts["gate_events"] == n // chunk
    assert events > 0
