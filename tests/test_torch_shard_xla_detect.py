"""The port's per-sample sharded detection (`parallel.shard.
sharded_minn_rtl_detect` and its closed-form merge `cross_shard_event_merge`)
against the JAX package, over four gloo ranks on the CPU.

One module-scoped `run_ranks` of 4 ranks (`tests/torch_shard_ranks.py`,
which imports no JAX) runs on meshes (1, 4) and (2, 2):

* `sharded_minn_rtl_detect` on tests/test_sharded_detect.py:21-92's
  stimulus (Q = 32, 4 streams of 4,096 samples, preambles inside shards or
  on the seams of the four 1,024-sample shards, and a zero stream whose
  gate never closes), ``emit_unclosed`` both ways, held to JAX's
  `sharded_minn_rtl_detect` on its 8-device mesh (2, 4) and to JAX's
  unsharded `minn_rtl_metric_planar` + `extract_gate_events`;
* `cross_shard_event_merge` on random above / track / extras arrays (8
  streams of 1,024 samples: clusters whose gaps are h - 1, h and h + 1,
  gates across the seams, peak values drawn from three levels so that the
  tie rule decides, gates closing at the stream's last sample, more gates
  than slots), both tie rules, ``emit_unclosed`` both ways, E = 1, 3, 8,
  h = 1, 2, 7, with 0, 1 and 2 extras, held to JAX's
  `_cross_shard_event_merge` run in a `shard_map` over a 4-device mesh (1,
  4) and to JAX's unsharded `extract_gate_events`;
* on mesh (1, 4), the same cases through three mutants of the merge, each
  of which must disagree with JAX somewhere: the gap rule (a gap of h
  opens a new gate), the tie rule (reversed) and the close rule (a gate
  closing at the last sample counts as open).

Tolerances: every integer and boolean field equal; the merge only selects,
so its peak values and extras are equal too; the detect's peak values
within 1e-4 of the largest peak (tests/test_sharded_detect.py's tolerance;
the smoothing register rounds otherwise on each side, which moves no
integer field on this stimulus).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ofdm_sync_tpu.kernels.streaming import minn_rtl_metric_planar, to_planar  # noqa: E402
from ofdm_sync_tpu.ops.detect import extract_gate_events  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_minn_rtl_preamble  # noqa: E402
from ofdm_sync_tpu.parallel import shard as jshard  # noqa: E402
from ofdm_sync_tpu_torch.parallel import distributed  # noqa: E402
from ofdm_sync_tpu_torch.testing import TABLE_FIELDS, assert_tables_equal  # noqa: E402
from test_torch_sc import no_jax_cache_writes  # noqa: E402,F401
from torch_shard_ranks import xla_detect_rank  # noqa: E402

Q = 32
KW = dict(quarter_len=Q, smooth_shift=3, threshold_value=3276, threshold_frac_bits=15,
          hysteresis=2)
L = 4096
BATCH = 4
PEAK_RTOL = 1e-4
MESHES = [(1, 4), (2, 2)]
#: the merge cases: (E, h, tie_last, emit_unclosed, number of extras)
MERGE_CFG = [(1, 2, True, False, 0), (3, 1, False, True, 1), (8, 2, True, True, 2),
             (8, 7, False, False, 1), (3, 2, False, False, 2), (8, 1, True, False, 0)]
MERGE_B, MERGE_N = 8, 1024
#: (old, new) source edits of each mutant of `cross_shard_event_merge`
MUTANTS = {
    "gap": [("> h)", ">= h)"), ("<= h)", "< h)")],
    "tie": [("sign = 1 if tie_last else -1", "sign = -1 if tie_last else 1")],
    "close": [("closed = (close_raw <= n - 1)", "closed = (close_raw < n - 1)")],
}


def _streams(rng, boundary):
    """tests/test_sharded_detect.py:_streams, as the channel-leading (4,
    4, 4096) layout."""
    iq = np.zeros((BATCH, 2, 2, L), np.float32)
    for b in range(BATCH):
        sig = np.zeros(L, complex)
        pos = L // 4 - 3 * Q + (b % 2) * (L // 4) if boundary else 500 + 700 * b
        pre = build_minn_rtl_preamble("qpsk_freq", rng=np.random.default_rng(b), Q=Q)
        sig[pos: pos + 5 * Q] = pre
        rx = np.stack([sig, 0.8 * sig])
        rx = rx + 0.05 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
        iq[b] = np.asarray(to_planar(jnp.asarray(rx)))
    return np.ascontiguousarray(iq.reshape(BATCH, 4, L).transpose(1, 0, 2))


def _merge_case(rng, E, h, tie_last, emit, n_extras):
    """Random above / track / extras (MERGE_B, MERGE_N): per stream runs of
    above samples separated by gaps of h - 1, h, h + 1 or more (so gates
    join, split and cross the seams at 256, 512, 768), track on three
    levels (ties); stream 0 without a gate, the last one with two, the
    second closing at the last sample."""
    above = np.zeros((MERGE_B, MERGE_N), bool)
    for b in range(MERGE_B):
        t = int(rng.integers(0, 40))
        while t < MERGE_N:
            run = min(int(rng.integers(1, 6)), MERGE_N - t)
            above[b, t: t + run] = rng.random(run) < 0.8
            above[b, t] = True
            t += run + int(rng.choice([h - 1, h, h + 1, h + 1, 3 * h + 5, 60]))
    above[0] = False  # a stream with no gate
    above[-1] = False  # two gates: one across a seam, one closing at the last sample
    above[-1, [250, 253, 258, MERGE_N - 1 - h]] = True
    track = rng.choice([1.0, 2.0, 3.0], (MERGE_B, MERGE_N)).astype(np.float32)
    extras = [rng.standard_normal((MERGE_B, MERGE_N)).astype(np.float32)
              for _ in range(n_extras)]
    return dict(above=above, track=track, extras=extras,
                kw=dict(h=h, E=E, n=MERGE_N, tie_last=tie_last, emit_unclosed=emit))


def _cases():
    rng = np.random.default_rng(7)
    return [_merge_case(rng, *cfg) for cfg in MERGE_CFG]


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    streams = [_streams(rng, False), _streams(rng, True), np.zeros((4, 2, 2048), np.float32)]
    cases = _cases()
    ranks = distributed.run_ranks(xla_detect_rank, 4, (streams, KW, cases, MUTANTS),
                                  timeout_s=600)
    return streams, cases, ranks


def _rows(arrays, d, nd, n):
    bb = n // nd
    return SimpleNamespace(**{f: np.asarray(a)[d * bb: (d + 1) * bb] for f, a in arrays.items()})


def _fields(table) -> dict:
    return {f: np.asarray(getattr(table, f)) for f in TABLE_FIELDS}


def test_ranks_import_no_jax(runs):
    for out in runs[2]:
        assert out["modules"] == []


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("stim", [0, 1], ids=["inside", "boundary"])
def test_sharded_detect_matches_jax(runs, stim, emit):
    streams, _, ranks = runs
    x = streams[stim]
    iq = x.reshape(2, 2, BATCH, L).transpose(2, 0, 1, 3)
    mesh = jshard.make_stream_mesh(n_data=2, n_seq=4)
    ref_s = _fields(jshard.sharded_minn_rtl_detect(jnp.asarray(iq), mesh, **KW,
                                                   emit_unclosed=emit))
    one = []
    for b in range(BATCH):
        st = minn_rtl_metric_planar(jnp.asarray(iq[b]), **{k: KW[k] for k in KW
                                                          if k != "hysteresis"})
        one.append(_fields(extract_gate_events(
            st.above_threshold, st.corr_positive, hysteresis=KW["hysteresis"], max_events=8,
            valid_from=st.valid_from, tie="last", emit_unclosed=emit)))
    ref_u = {f: np.stack([t[f] for t in one]) for f in TABLE_FIELDS}
    assert (ref_u["count"] >= 1).all()
    assert_tables_equal(SimpleNamespace(**ref_u), SimpleNamespace(**ref_s), "JAX", PEAK_RTOL)
    for r, out in enumerate(ranks):
        for nd, ns in MESHES:
            d, got = out["detect", nd, ns, stim, emit]
            for ref, name in ((ref_s, "JAX sharded"), (ref_u, "JAX unsharded")):
                assert_tables_equal(_rows(ref, d, nd, BATCH), SimpleNamespace(**got),
                                    f"rank {r} mesh {(nd, ns)} vs {name}", PEAK_RTOL)


def test_sharded_detect_emit_unclosed(runs):
    """tests/test_sharded_detect.py:76-92: a zero stream's gate never
    closes; it is emitted only with ``emit_unclosed``."""
    _, _, ranks = runs
    for out in ranks:
        for nd, ns in MESHES:
            (_, closed), (_, open_) = (out["detect", nd, ns, 2, e] for e in (False, True))
            assert (closed["count"] == 0).all()
            assert (open_["count"] == 1).all() and not open_["closed"][:, 0].any()


def _jax_merge(case):
    """JAX's `_cross_shard_event_merge` in a shard_map over a 4-device
    mesh (1, 4)."""
    mesh = jshard.make_stream_mesh(1, 4, devices=jax.devices()[:4])
    kw, k = case["kw"], len(case["extras"])
    block = MERGE_N // 4

    def fn(above, track, *extras):
        gi = jax.lax.axis_index("seq") * block + jnp.arange(block, dtype=jnp.int32)
        return jshard._cross_shard_event_merge(
            above, track, jnp.broadcast_to(gi, above.shape), h=kw["h"], E=kw["E"], n=kw["n"],
            tie_last=kw["tie_last"], emit_unclosed=kw["emit_unclosed"], extras=tuple(extras))

    out = jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("data", "seq"),) * (2 + k),
                            out_specs=(P("data"),) * (8 + k), check_vma=False))(
        jnp.asarray(case["above"]), jnp.asarray(case["track"]),
        *(jnp.asarray(e) for e in case["extras"]))
    out = [np.asarray(o) for o in out]
    return dict(zip(TABLE_FIELDS, out[:8])), out[8:]


def _check_merge(got, want, what):
    table, extras = got
    for f in TABLE_FIELDS:
        assert table[f].dtype == want[0][f].dtype, f"{what} {f} dtype"
        np.testing.assert_array_equal(table[f], want[0][f], err_msg=f"{what} {f}")
    assert len(extras) == len(want[1]), what
    for k, (e, w) in enumerate(zip(extras, want[1])):
        np.testing.assert_array_equal(e, w, err_msg=f"{what} extra {k}")


@pytest.mark.parametrize("i", range(len(MERGE_CFG)))
def test_cross_shard_merge_matches_jax(runs, i):
    _, cases, ranks = runs
    case = cases[i]
    want = _jax_merge(case)
    kw = case["kw"]
    one = _fields(jax.vmap(lambda a, t: extract_gate_events(
        a, t, hysteresis=kw["h"], max_events=kw["E"], tie="last" if kw["tie_last"] else "first",
        emit_unclosed=kw["emit_unclosed"]))(jnp.asarray(case["above"]),
                                            jnp.asarray(case["track"])))
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(want[0][f], one[f], err_msg=f"JAX sharded vs unsharded {f}")
    assert (want[0]["count"][1:] >= 1).all()  # every stream but the first holds a gate
    for r, out in enumerate(ranks):
        for nd, ns in MESHES:
            d, table, extras = out["merge", nd, ns, i]
            bb = MERGE_B // nd
            ref = ({f: a[d * bb: (d + 1) * bb] for f, a in want[0].items()},
                   [e[d * bb: (d + 1) * bb] for e in want[1]])
            _check_merge((table, extras), ref, f"rank {r} mesh {(nd, ns)} case {i}")


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_merge_mutants_fail(runs, name):
    """Each mutant of the gap, tie and close rules disagrees with JAX's
    merge on some case, on every rank: the cases pin each rule."""
    _, cases, ranks = runs
    wants = [_jax_merge(c) for c in cases]
    for r, out in enumerate(ranks):
        caught = 0
        for got, want in zip(out["mutant", name], wants):
            try:
                _check_merge(got, want, name)
            except AssertionError:
                caught += 1
        assert caught, f"rank {r}: mutant {name} matched JAX on every case"
