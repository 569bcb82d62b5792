"""A plain-torch model of kernel B's span decomposition (`gate_events.cu`).

Kernel B cuts each stream into spans.  The gate state entering a sample is
the pair (last-above index, cluster count); a span changes it through three
numbers only (its first above index, its last above index and the cluster
starts counted inside it), and those compose associatively, so an
exclusive scan of the span summaries, offset by ``gate_init``, gives every
span the pair it starts from.  Each span then folds its gated samples into
the slots of their clusters -- start by min, last above by max, the peak by
the max of a 64-bit key (order-preserving value bits, index for tie "last"
or INT_MAX - index for "first"; -0.0 keyed as +0.0) -- and a last step
writes the table by the Lg rule.

`span_model` below is that decomposition in plain torch.  On integer
streams made with NumPy from a seed, with spans of 7-64 samples so that
gates cross many seams, it must give the table, the captured channels and
the gate carry of the port's `ops.detect.extract_gate_events_carried` and,
for uncarried calls, the table of the JAX package's
`ofdm_sync_tpu.ops.detect.extract_gate_events`, field by field.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.ops import detect as jdet  # noqa: E402
from ofdm_sync_tpu_torch.ops.detect import GateEvents, extract_gate_events_carried  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402

I32_MAX = 2**31 - 1
NO_KEY = -(2**63)


def peak_keys(track: torch.Tensor, idx: torch.Tensor, tie_last: bool) -> torch.Tensor:
    """int64 keys ordered as (value, index) under the tie rule: the
    order-preserving bits of the value (-0.0 as +0.0) above the index
    part, shifted by 2^31 so that they fit a signed 64-bit integer."""
    t = torch.where(track == 0, torch.zeros_like(track), track)
    u = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(u >= 2**31, 0xFFFFFFFF - u, u + 2**31)
    part = idx if tie_last else I32_MAX - idx
    return (ordered - 2**31) * 2**32 + part


def span_summaries(ab: torch.Tensor, idx: torch.Tensor, h: int, span: int):
    """Per stream and span: first above, last above (-1: none) and the
    cluster starts counted from inside the span."""
    batch, n = ab.shape
    S = -(-n // span)
    first = torch.full((batch, S), -1, dtype=torch.int64)
    last = torch.full((batch, S), -1, dtype=torch.int64)
    starts = torch.zeros((batch, S), dtype=torch.int64)
    for s in range(S):
        a, i = ab[:, s * span:(s + 1) * span], idx[s * span:(s + 1) * span]
        marked = torch.where(a, i, -1)
        la = torch.cummax(marked, dim=-1).values
        prev = torch.cat([torch.full((batch, 1), -1, dtype=torch.int64), la[:, :-1]], dim=-1)
        starts[:, s] = (a & ((prev < 0) | (i - prev > h))).sum(-1)
        last[:, s] = marked.amax(-1)
        first[:, s] = torch.where(a.any(-1), torch.where(a, i, 2**62).amin(-1), -1)
    return first, last, starts


def entering_pairs(first, last, starts, la0, cnt0, h: int):
    """The (last-above, count) pair entering each span: an exclusive scan of
    the summaries from gate_init, and the pair after the last span."""
    la_in = torch.maximum(torch.cummax(torch.cat([la0, last], -1), -1).values[:, :-1], la0)
    new = (first >= 0) & ((la_in < 0) | (first - la_in > h))
    inc = torch.where(first >= 0, starts - 1 + new.long(), torch.zeros_like(starts))
    cnt_in = cnt0 + torch.cumsum(inc, -1) - inc
    return la_in, cnt_in, (torch.maximum(la0[:, 0], last.amax(-1)), cnt0[:, 0] + inc.sum(-1))


def span_model(above, track, extras=(), *, hysteresis, max_events=8, valid_from=0, tie="first",
               emit_unclosed=True, base_index=0, stream_len_global=None, gate_init=None,
               span=16):
    """Kernel B's decomposition: summaries, their scan, per-span slot
    updates with packed keys, the table.  Returns (table, captured or None,
    gate_out) like `extract_gate_events_carried`."""
    batch, n = above.shape
    h, E, tie_last = max(int(hysteresis), 1), max_events, tie == "last"
    Lg = base_index + n if stream_len_global is None else stream_len_global
    track_end = min(Lg, base_index + n)
    idx = base_index + torch.arange(n, dtype=torch.int64)
    ab = above & (idx >= valid_from) & (idx < Lg)
    if gate_init is None:
        la0 = torch.full((batch, 1), -1, dtype=torch.int64)
        cnt0 = torch.zeros((batch, 1), dtype=torch.int64)
    else:
        la0, cnt0 = gate_init[:, :1].long(), gate_init[:, 1:].long()
    first, last, starts = span_summaries(ab, idx, h, span)
    la_in, cnt_in, (la_out, total) = entering_pairs(first, last, starts, la0, cnt0, h)

    g_start = torch.full((batch, E), I32_MAX, dtype=torch.int64)
    g_last = torch.full((batch, E), -1, dtype=torch.int64)
    g_key = torch.full((batch, E), NO_KEY, dtype=torch.int64)
    keys = peak_keys(track, idx.expand(batch, n), tie_last)
    for s in range(first.shape[1]):
        sl = slice(s * span, (s + 1) * span)
        a, i = ab[:, sl], idx[sl]
        la = torch.maximum(torch.cummax(torch.where(a, i, -1), -1).values, la_in[:, s:s + 1])
        prev = torch.cat([la_in[:, s:s + 1], la[:, :-1]], -1)
        cid = cnt_in[:, s:s + 1] + torch.cumsum(a & ((prev < 0) | (i - prev > h)), -1)
        gated = (la >= 0) & (i - la <= h) & (cid >= 1) & (i < track_end)
        for c in range(1, E + 1):  # clusters past E own no slot
            m = gated & (cid == c)
            g_start[:, c - 1] = torch.minimum(g_start[:, c - 1], torch.where(m, i, I32_MAX).amin(-1))
            g_last[:, c - 1] = torch.maximum(g_last[:, c - 1], torch.where(m & a, i, -1).amax(-1))
            g_key[:, c - 1] = torch.maximum(g_key[:, c - 1],
                                            torch.where(m, keys[:, sl], NO_KEY).amax(-1))

    # the table: the Lg rule, the peak from its key, the value read there
    exists = torch.arange(E) < total.unsqueeze(-1)
    part = g_key % 2**32
    pidx = torch.where(g_key == NO_KEY, -1 if tie_last else I32_MAX,
                       part if tie_last else I32_MAX - part)
    local = (pidx - base_index).clamp(0, n - 1)
    pval = torch.where(g_key == NO_KEY, float("-inf"), track.gather(-1, local))
    close_raw = g_last + h
    closed = exists & (close_raw <= Lg - 1)
    valid = exists & (closed | emit_unclosed)
    zero = torch.zeros((), dtype=torch.int64)
    table = GateEvents(
        valid=valid, closed=closed,
        gate_start=torch.where(exists, g_start, zero).int(),
        gate_close=torch.where(exists, close_raw.clamp(0, Lg - 1), zero).int(),
        peak_idx=torch.where(exists, pidx, zero).int(),
        peak_value=torch.where(exists, pval, torch.zeros(())),
        count=valid.sum(-1, dtype=torch.int32), overflow=total > E)
    cap = None
    if extras:
        ok = exists & (pidx - base_index >= 0) & (pidx - base_index < n)
        cap = torch.stack([torch.where(ok, e.gather(-1, local), 0.0) for e in extras], 1)
    return table, cap, torch.stack([la_out, total], -1).int()


def _streams(seed, batch, n, density, levels, neg_zero=False):
    rng = np.random.default_rng(seed)
    above = rng.random((batch, n)) < density
    # runs of above samples, so that gates span seams
    above |= np.roll(above, 1, axis=1) & (rng.random((batch, n)) < 0.6)
    track = rng.integers(0, levels, (batch, n)).astype(np.float32)
    if neg_zero:  # -0.0 and +0.0 tie under the float compare
        track[rng.random((batch, n)) < 0.5] = 0.0
        track[rng.random((batch, n)) < 0.3] = -0.0
    return above, track


CASES = [  # seed, batch, n, density, levels, h, E, tie, emit, span
    (0, 3, 700, 0.03, 20, 2, 8, "last", False, 7),
    (1, 3, 700, 0.03, 20, 2, 8, "first", True, 16),
    (2, 2, 1500, 0.01, 5, 9, 4, "last", True, 64),
    (3, 4, 901, 0.2, 3, 1, 1, "first", False, 13),    # E = 1: overflow, dense ties
    (4, 2, 1200, 0.005, 50, 100, 8, "last", True, 16),  # h larger than a span
    (5, 3, 640, 0.08, 4, 0, 128, "first", True, 32),  # h = 0, full capacity
    (6, 2, 333, 0.0, 9, 3, 8, "last", True, 8),       # nothing above
]


@pytest.mark.parametrize("seed,batch,n,density,levels,h,E,tie,emit,span", CASES)
def test_span_model_matches_plain_and_jax(seed, batch, n, density, levels, h, E, tie, emit,
                                          span):
    above, track = _streams(seed, batch, n, density, levels)
    kw = dict(hysteresis=h, max_events=E, valid_from=5, tie=tie, emit_unclosed=emit)
    a, t = torch.from_numpy(above), torch.from_numpy(track)
    table, _, gate_out = span_model(a, t, span=span, **kw)
    ref, _, ref_gate = extract_gate_events_carried(a, t, base_index=0, **kw)
    assert_tables_equal(ref, table, "span model vs the plain version")
    assert torch.equal(gate_out, ref_gate)
    for b in range(batch):
        jref = jdet.extract_gate_events(jnp.asarray(above[b]), jnp.asarray(track[b]), **kw)
        assert_tables_equal(jref, table.select(b), f"span model vs JAX, stream {b}")


@pytest.mark.parametrize("tie,span,neg_zero,n_extra", [
    ("last", 7, True, 0), ("first", 7, True, 1), ("last", 29, False, 3), ("first", 64, False, 0)])
def test_span_model_carried_matches_plain(tie, span, neg_zero, n_extra):
    """Global indices, a gate carried in mid-gate, Lg inside the call (the
    close clipped, later above samples masked), -0.0 ties, captures."""
    batch, n, base, h = 4, 1000, 1_000_000, 6
    above, track = _streams(11, batch, n, 0.04, 6, neg_zero=neg_zero)
    rng = np.random.default_rng(12)
    extras = tuple(torch.from_numpy(rng.standard_normal((batch, n)).astype(np.float32))
                   for _ in range(n_extra))
    # streams 0, 2: a gate continuing into the call (last above within h
    # before base, 1 or 3 clusters so far); 1, 3: none
    gi = torch.tensor([[base - 2, 1], [-1, 0], [base - h, 3], [-1, 0]], dtype=torch.int32)
    a, t = torch.from_numpy(above), torch.from_numpy(track)
    for Lg in (base + n - 150, base + n + 40):
        kw = dict(hysteresis=h, max_events=5, valid_from=0, tie=tie, emit_unclosed=True,
                  base_index=base, stream_len_global=Lg, gate_init=gi)
        table, cap, gate_out = span_model(a, t, extras, span=span, **kw)
        ref, rcap, ref_gate = extract_gate_events_carried(a, t, extras, **kw)
        assert_tables_equal(ref, table, f"carried span model, Lg = base + {Lg - base}")
        assert torch.equal(gate_out, ref_gate)
        assert torch.equal(table.peak_value, ref.peak_value)  # -inf in slots with no sample
        assert torch.equal(torch.signbit(table.peak_value), torch.signbit(ref.peak_value))
        if extras:
            assert torch.equal(cap, rcap)
        assert int(table.count.sum()) > 0
