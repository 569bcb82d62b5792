"""The port's sharded metrics (`parallel.shard`) against the JAX package,
over four gloo ranks on the CPU.

One module-scoped `run_ranks` of 4 ranks (`tests/torch_shard_ranks.py`,
which imports no JAX) runs, on meshes (1, 4) and (2, 2):
`blocked_linear_recurrence`, `sharded_minn_rtl_planar`,
`sharded_minn_rtl_metric` (one complex stream), `sharded_aa_metric`,
`sharded_sc_metric` and `shard_batch`.  Each rank's block is held to JAX's
sharded function on its own 4-device CPU mesh of the same shape and to
JAX's unsharded metric.  Stimulus after tests/test_sharding.py:53-175 (L =
4,096, Q = 64, lag 64 for [A][A], n_fft = 256), integer-valued (round(8
N(0, 1)) plus 5Q Minn preambles, two of them across seams), so every
window sum is exact on both sides.

Tolerances:

* blocked linear recurrence, random a in [0.6, 1), b ~ N(0, 1): within
  1e-6 of the largest |s| (both sides scan in float32, in other orders);
* Minn-RTL (planar): corr_positive and energy equal; smooth within 1e-6
  of the largest smooth (kernel A's sequential register against JAX's
  associative scan); above equal.  The complex one-stream form: JAX forms
  powers as |x|^2 through a square root, the port as i*i + q*q, so corr
  equal, energy and smooth within 1e-6 of their largest values;
* [A][A]: P equal; R and M within 1e-6 of their largest values (JAX forms
  |x|^2 and |P|^2 through a square root, the port as re*re + im*im), valid
  equal;
* Schmidl-Cox: P, R and M within 1e-6 of their largest values (complex
  window sums in another order);
* `shard_batch`: the rank's slice equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ofdm_sync_tpu.kernels.streaming import minn_rtl_metric_planar  # noqa: E402
from ofdm_sync_tpu.ops import metrics as jm  # noqa: E402
from ofdm_sync_tpu.ops.windows import linear_recurrence  # noqa: E402
from ofdm_sync_tpu.parallel import shard as jshard  # noqa: E402
from ofdm_sync_tpu_torch.parallel import distributed  # noqa: E402
from test_torch_sc import no_jax_cache_writes  # noqa: E402,F401
from torch_shard_ranks import metrics_rank  # noqa: E402

L = 4096
BATCH = 4
Q = 64
LAG = 64
N_FFT = 256
KW = dict(quarter_len=Q, smooth_shift=3, threshold_value=3276, threshold_frac_bits=15)
MESHES = [(1, 4), (2, 2)]
REL = 1e-6
#: (stream, position) of a 5Q preamble; streams 1 and 2 across a (1, 4) seam
PREAMBLES = [(0, 500), (1, L // 4 - 3 * Q), (2, L // 2 - 2 * Q), (3, 3000)]


def _stimulus(rng):
    """Channel-leading (4, BATCH, L) integer-valued IQ and the blocked
    recurrence's (a, b), each (BATCH, L)."""
    x = np.round(8 * rng.standard_normal((4, BATCH, L))).astype(np.float32)
    A = np.round(12 * (rng.standard_normal(Q) + 1j * rng.standard_normal(Q)))
    pre = np.concatenate([-A, A, A, -A, -A])
    for b, pos in PREAMBLES:
        for c, comp in enumerate((pre.real, pre.imag, pre.real, pre.imag)):
            x[c, b, pos: pos + 5 * Q] += comp.astype(np.float32)
    a = rng.uniform(0.6, 1.0, (BATCH, L)).astype(np.float32)
    b = rng.standard_normal((BATCH, L)).astype(np.float32)
    return x, a, b


def _complex(x, b):
    """Stream b of channel-leading x as complex (branches, L)."""
    return (x[0::2, b] + 1j * x[1::2, b]).astype(np.complex64)


def _jmesh(nd, ns):
    return jshard.make_stream_mesh(nd, ns, devices=jax.devices()[:4])


def _close(got, want, what, rel=REL):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _slice(d, s, nd, ns):
    """The (streams, samples) of rank (d, s) in a (BATCH, L) array."""
    bb, bl = BATCH // nd, L // ns
    return slice(d * bb, (d + 1) * bb), slice(s * bl, (s + 1) * bl)


@pytest.fixture(scope="module")
def runs():
    x, a, b = _stimulus(np.random.default_rng(0))
    rx = _complex(x, 1)
    ranks = distributed.run_ranks(metrics_rank, 4, (a, b, x, rx, KW, LAG, N_FFT), timeout_s=600)
    return x, a, b, rx, ranks


def _each(ranks, key):
    for r, out in enumerate(ranks):
        for nd, ns in MESHES:
            d, s, got = out[key, nd, ns]
            yield f"rank {r} mesh {(nd, ns)}", nd, ns, _slice(d, s, nd, ns), got


def test_ranks_import_no_jax(runs):
    for out in runs[-1]:
        assert out["modules"] == []


def test_blocked_linear_recurrence_matches_jax(runs):
    _, a, b, _, ranks = runs
    want = np.asarray(jax.jit(linear_recurrence)(jnp.asarray(a), jnp.asarray(b)))
    sharded = {}
    for nd, ns in MESHES:
        fn = jax.jit(shard_map(lambda p, q: jshard.blocked_linear_recurrence(p, q, "seq"),
                               mesh=_jmesh(nd, ns), in_specs=(P("data", "seq"),) * 2,
                               out_specs=P("data", "seq"), check_vma=False))
        sharded[nd, ns] = np.asarray(fn(jnp.asarray(a), jnp.asarray(b)))
        _close(sharded[nd, ns], want, f"JAX sharded {(nd, ns)} vs unsharded")
    for what, nd, ns, sl, got in _each(ranks, "blr"):
        _close(got, sharded[nd, ns][sl], what + " vs JAX sharded")
        _close(got, want[sl], what + " vs JAX unsharded")


def test_sharded_minn_planar_matches_jax(runs):
    x, _, _, _, ranks = runs
    iq = x.reshape(2, 2, BATCH, L).transpose(2, 0, 1, 3)  # (batch, branches, 2, L)
    one = [minn_rtl_metric_planar(jnp.asarray(iq[b]), **KW) for b in range(BATCH)]
    one = [np.stack([np.asarray(getattr(st, f)) for st in one])
           for f in ("corr_positive", "smooth_metric", "energy_total", "above_threshold")]
    assert one[3].sum() > 0 and one[3].sum(axis=1).all()
    sharded = {m: [np.asarray(t) for t in jshard.sharded_minn_rtl_planar(
        jnp.asarray(iq), _jmesh(*m), **KW)] for m in MESHES}
    for what, nd, ns, sl, got in _each(ranks, "planar"):
        for ref, name in ((sharded[nd, ns], "JAX sharded"), (one, "JAX unsharded")):
            corr, smooth, energy, above = (r[sl] for r in ref)
            np.testing.assert_array_equal(got[0], corr, err_msg=f"{what} corr vs {name}")
            np.testing.assert_array_equal(got[2], energy, err_msg=f"{what} energy vs {name}")
            _close(got[1], smooth, f"{what} smooth vs {name}")
            np.testing.assert_array_equal(got[3], above, err_msg=f"{what} above vs {name}")


def test_sharded_minn_metric_one_stream_matches_jax(runs):
    _, _, _, rx, ranks = runs
    ref = jm.minn_rtl_metric(jnp.asarray(rx), **KW)
    one = [np.asarray(getattr(ref, f))
           for f in ("corr_positive", "smooth_metric", "energy_total", "above_threshold")]
    for nd, ns in MESHES:
        sharded = [np.asarray(t) for t in jshard.sharded_minn_rtl_metric(
            jnp.asarray(rx), _jmesh(nd, ns), **KW)]
        for r, out in enumerate(ranks):
            _, s, got = out["metric", nd, ns]
            sl = slice(s * (L // ns), (s + 1) * (L // ns))
            for want, name in ((sharded, "JAX sharded"), (one, "JAX unsharded")):
                what = f"rank {r} mesh {(nd, ns)} vs {name}"
                np.testing.assert_array_equal(got[0], want[0][sl], err_msg=what + " corr")
                _close(got[2], want[2][sl], what + " energy")
                _close(got[1], want[1][sl], what + " smooth")
                np.testing.assert_array_equal(got[3], want[3][sl], err_msg=what + " above")


@pytest.mark.parametrize("metric", ["aa", "sc"])
def test_sharded_aa_sc_metrics_match_jax(runs, metric):
    """Per stream (JAX's sharded [A][A] and S&C metrics take one stream):
    JAX's sharded function on the same mesh shape and its unsharded
    metric."""
    x, _, _, _, ranks = runs
    out_len = L - N_FFT + 1
    for nd, ns in MESHES:
        mesh = _jmesh(nd, ns)
        for b in range(BATCH):
            rxb = jnp.asarray(_complex(x, b))
            if metric == "aa":
                sharded = [np.asarray(t) for t in jshard.sharded_aa_metric(rxb, mesh, LAG)]
                st = jm.aa_metric(rxb, LAG)
                one = [np.asarray(t) for t in (st.P, st.R, st.M, st.valid)]
            else:
                sharded = [np.asarray(t) for t in jshard.sharded_sc_metric(rxb, mesh, N_FFT)]
                M, Pc, R = (np.asarray(t) for t in jm.sc_metric(rxb, N_FFT))
                one = [M, Pc, R]
            for r, out in enumerate(ranks):
                d, s, got = out[metric, nd, ns]
                bb, bl = BATCH // nd, L // ns
                if not d * bb <= b < (d + 1) * bb:
                    continue
                lo, row = s * bl, b - d * bb
                what = f"rank {r} mesh {(nd, ns)} stream {b} {metric}"
                if metric == "aa":
                    for want, ref in ((sharded, "sharded"), (one, "unsharded")):
                        np.testing.assert_array_equal(got[0][row], want[0][lo: lo + bl],
                                                      err_msg=f"{what} P vs {ref}")
                        _close(got[1][row], want[1][lo: lo + bl], f"{what} R vs {ref}")
                        _close(got[2][row], want[2][lo: lo + bl], f"{what} M vs {ref}")
                        np.testing.assert_array_equal(got[3][row], want[3][lo: lo + bl])
                else:
                    hi = min(lo + bl, out_len)  # JAX leaves the last N - 1 undefined
                    for k, name in enumerate(("M", "P", "R")):
                        _close(got[k][row][: hi - lo], sharded[k][lo:hi], f"{what} {name}")
                        _close(got[k][row][: hi - lo], one[k][lo:hi], f"{what} {name} one")


def test_shard_batch_slices(runs):
    x, a, _, _, ranks = runs
    for r, out in enumerate(ranks):
        for nd, ns in MESHES:
            d, s, xs, as_ = out["batch", nd, ns]
            bb = BATCH // nd
            np.testing.assert_array_equal(xs, x[:, d * bb: (d + 1) * bb])
            np.testing.assert_array_equal(as_, a[d * bb: (d + 1) * bb])
            assert xs.flags["C_CONTIGUOUS"]
