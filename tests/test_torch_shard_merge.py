"""The port's collective-free event-table merge and halo arithmetic against
the JAX package, in one process.

* `parallel.shard.merge_stacked_event_tables` against JAX's
  `_merge_stacked_event_tables` on random stacked tables: 1-5 pieces, E
  1-8, K 1 and 3 packed float fields, both peak tie rules, both
  ``emit_unclosed``, each piece's first gate starting h - 1, h or h + 1
  after the trailing gate's last above sample (or far from it), some of
  them closing at, just before or just after the trailing gate's close,
  equal peaks planted so that the tie rule decides.  The merge only selects, so
  every field, the float ones included, must be equal.
* `minn_halo_width` (kernel A's `metric_halo` plus h) equals JAX's
  `_minn_halo_width`, and the gate carry of a halo tail equals JAX's
  `_gate_init_from_tail`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.parallel import shard as jshard  # noqa: E402
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import metric_halo  # noqa: E402
from ofdm_sync_tpu_torch.parallel import shard  # noqa: E402
from test_torch_sc import no_jax_cache_writes  # noqa: E402,F401

FIELDS = ("valid", "closed", "gate_start", "gate_close", "peak_idx", "peak_value", "count",
          "overflow")

# (pieces, E, K, tie_last, emit_unclosed, h): every value of each axis appears
CASES = [
    (1, 1, 1, True, False, 2),
    (1, 8, 3, False, True, 1),
    (2, 1, 3, True, True, 2),
    (2, 3, 1, False, False, 7),
    (2, 8, 1, True, True, 2),
    (3, 2, 3, True, False, 1),
    (3, 5, 1, False, True, 2),
    (4, 4, 3, False, False, 2),
    (4, 8, 1, True, False, 7),
    (5, 1, 1, False, True, 2),
    (5, 6, 3, True, True, 1),
    (5, 8, 3, False, False, 2),
]


def _stacked(rng, P, B, E, K, h):
    """Random per-piece tables of B streams, in time order, as JAX's merge
    takes them: (start, close, peak_idx, packed f32 (P, B, K*E), closed,
    count, overflow)."""
    start, close, pidx = (np.zeros((P, B, E), np.int32) for _ in range(3))
    pval = np.zeros((P, B, K * E), np.float32)
    closed = np.zeros((P, B, E), bool)
    count = np.zeros((P, B), np.int32)
    overflow = np.zeros((P, B), bool)
    for b in range(B):
        t, trail_la = int(rng.integers(0, 50)), None
        for p in range(P):
            cnt = int(rng.integers(0, E + 1))
            for e in range(cnt):
                if e == 0 and trail_la is not None and rng.random() < 0.8:
                    s = trail_la + int(rng.choice([h - 1, h, h + 1]))
                    # a continuation may hold no above sample of its own: its
                    # close then sits at, just before or just after the old one
                    last_above = (trail_la + int(rng.integers(-1, 2)) if rng.random() < 0.35
                                  else s + int(rng.integers(0, 12)))
                else:
                    s = t + int(rng.integers(h + 2, 4 * h + 12))
                    last_above = s + int(rng.integers(0, 12))
                start[p, b, e], close[p, b, e] = s, last_above + h
                pidx[p, b, e] = int(rng.integers(s, max(s, last_above) + 1))
                pval[p, b, e] = float(rng.choice([0.5, 1.0, 2.0]))  # ties across pieces
                pval[p, b, e + E::E] = rng.standard_normal(K - 1)
                closed[p, b, e] = rng.random() < 0.85
                t = max(t, last_above + h)
            count[p, b] = cnt
            overflow[p, b] = cnt == E and rng.random() < 0.3
            if cnt:
                trail_la = int(close[p, b, cnt - 1]) - h
    return start, close, pidx, pval, closed, count, overflow


@pytest.mark.parametrize("P,E,K,tie_last,emit,h", CASES)
def test_merge_stacked_matches_jax(P, E, K, tie_last, emit, h):
    rng = np.random.default_rng(1000 * P + 10 * E + K)
    g = _stacked(rng, P, 64, E, K, h)
    kw = dict(h=h, E=E, K=K, tie_last=tie_last, emit_unclosed=emit)
    ref = jshard._merge_stacked_event_tables(tuple(jnp.asarray(a) for a in g), **kw)
    table, extras = shard.merge_stacked_event_tables(tuple(torch.from_numpy(a) for a in g), **kw)
    got = [getattr(table, f) for f in FIELDS] + list(extras)
    assert len(got) == len(ref) == 8 + K - 1
    for name, r, o in zip(FIELDS + tuple(f"extra{k}" for k in range(1, K)), ref, got):
        r = np.asarray(r)
        assert o.numpy().dtype == r.dtype, name
        np.testing.assert_array_equal(o.numpy(), r, err_msg=name)
    assert int(np.asarray(ref[6]).sum()) > 0  # the case holds events


@pytest.mark.parametrize("Q,shift,hyst", [(32, 3, 2), (64, 6, 0), (512, 3, 256)])
def test_halo_width_matches_jax(Q, shift, hyst):
    assert shard.minn_halo_width(Q, shift, hyst) == jshard._minn_halo_width(Q, shift,
                                                                           max(hyst, 1))
    assert metric_halo(Q, shift) + max(hyst, 1) == jshard._minn_halo_width(Q, shift,
                                                                          max(hyst, 1))


@pytest.mark.parametrize("h", [1, 2, 16])
def test_gate_carry_matches_jax(h):
    rng = np.random.default_rng(h)
    first = 5000
    above = rng.random((40, h)) < 0.15
    above[:5] = False
    gi = first - h + np.arange(h, dtype=np.int32)
    ref = np.asarray(jshard._gate_init_from_tail(jnp.asarray(above), jnp.asarray(gi)))
    out = shard._gate_from_tail(torch.from_numpy(above), first, h)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref[:, 1] == 0).any() and (ref[:, 1] == 1).any()
