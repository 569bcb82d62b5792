"""The sharded receive chain on `torch.distributed` (port of
`ofdm_sync_tpu.parallel.shard`).

Two parallel axes, as in the JAX package: ``data`` (independent streams,
no communication) and ``seq`` (the time axis of each stream, cut into
equal blocks).  PyTorch has no ``shard_map``, so the port is SPMD: every
rank calls the same function with its own block, channel-leading ``(C,
B_loc, block)``, and gets back its ``B_loc`` streams' share of the result:
a metric's own block, or the merged event table, the same on every rank of
its ``seq`` group (JAX's ``out_specs=P("data")``).  `StreamMesh` maps rank
r to ``data = r // n_seq``, ``seq = r % n_seq``; `shard_batch` keeps a
rank's ``data`` slice of a whole array.

The collectives, each within the rank's ``seq`` group:

* halo exchange (JAX ``ppermute``): point-to-point sends and receives
  (`dist.batch_isend_irecv`) of a block's trailing samples to the right
  neighbour (its leading ones to the left for a forward window); the ends
  of the stream get zeros; int16 stays int16 on the wire;
* the blocked IIR's carry (JAX ``all_gather`` of per-shard summaries): one
  all-gather of (prod a, final s) per stream;
* event-table merge (JAX ``all_gather`` of one packed int32 buffer): one
  all-gather; the float32 fields ride bit for bit as int32;
* the closed-form per-sample merge (JAX ``all_gather`` + ``pmin`` /
  ``pmax`` / ``psum``): one all-gather of per-shard gate summaries, then
  all-reduces (MAX, and SUM for captured channels) of the E slots;
* frame assembly (JAX ``psum``): one all-reduce; every window sample is
  held by exactly one shard and the others add zeros, so the sum is exact.

Host staging: gloo takes no CUDA tensor in point-to-point operations or
all-gathers.  Where a group's backend is gloo (ranks sharing one card) and
a tensor lies on the card, `_wire` copies it to host memory for the
collective and the result goes back to the card; this is the only place
the port moves data through the host for a collective.  The kernels run
on the card either way.  NCCL (a card per rank) takes the card's tensors
directly.

Two designs of detector, as in JAX.  The table-merged ones
(`sharded_minn_rtl_detect_fused`, `sharded_zc_iq_detect`,
`sharded_aa_detect_fused`, `sharded_zc_cfar_detect`) run their single-card
kernels in the carried (shard) mode with global indices, primed from the
left neighbour's halo, so a shard needs nothing else of its neighbours; the
per-shard tables then merge with the seam rule of
`merge_stacked_event_tables`.  The per-sample ones (`sharded_minn_rtl_detect`,
`sharded_zc_detect`) compute the sharded metric's gate input and merge it
with `cross_shard_event_merge`.  The metrics need only a left halo, except
the Minn-RTL smoothing IIR, whose register crosses every seam: each shard
runs it from zero and `carry_fixup` adds the exact carry
(`blocked_linear_recurrence`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ofdm_sync_tpu_torch.kernels.aa_fused import aa_detect_fused, aa_metric
from ofdm_sync_tpu_torch.kernels.matched_filter import MAX_TAPS, matched_filter_ols
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import (
    _check_input,
    _planar_view,
    gate_continuation,
    metric_halo,
    minn_rtl_detect_fused,
    minn_rtl_metric_planar_fused,
)
from ofdm_sync_tpu_torch.kernels.streaming import (
    _aa_normalized,
    aa_metric_planar,
    cfar_gate,
    minn_rtl_metric_planar,
)
from ofdm_sync_tpu_torch.kernels.zc_fused import (
    default_threshold,
    zc_cfar_detect,
    zc_iq_cfar_detect,
    zc_metric,
    zc_tm_halo_rows,
)
from ofdm_sync_tpu_torch.ops.channel import fft_convolve_full, fft_convolve_full_ols
from ofdm_sync_tpu_torch.ops.detect import GateEvents
from ofdm_sync_tpu_torch.ops.extract import gather_windows, pad_slots
from ofdm_sync_tpu_torch.ops.windows import (
    linear_recurrence,
    sliding_sum_valid,
)


class StreamMesh(NamedTuple):
    """The (data, seq) mesh as seen by one rank: its coordinates and the
    process group of its ``seq`` row.  ``data`` needs no group: its slices
    are independent streams, and no sharded function communicates across
    them (`shard_batch` only selects a rank's slice)."""

    n_data: int
    n_seq: int
    data: int
    seq: int
    seq_group: object

    def seq_rank(self, s: int) -> int:
        """Global rank of position ``s`` of this rank's ``seq`` group."""
        return dist.get_global_rank(self.seq_group, s)


def make_stream_mesh(n_data: int = 1, n_seq: int | None = None) -> StreamMesh:
    """(data, seq) mesh over the default process group, ``seq`` minor:
    rank r sits at ``data = r // n_seq``, ``seq = r % n_seq`` (default
    ``n_seq`` = world // n_data).  Creates one group per ``seq`` row, so
    every rank must call it, in the same order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_seq is None:
        n_seq = world // n_data
    if n_data * n_seq != world:
        raise ValueError(f"{n_data}x{n_seq} != {world} ranks")
    rows = [dist.new_group([d * n_seq + s for s in range(n_seq)]) for d in range(n_data)]
    d, s = divmod(rank, n_seq)
    return StreamMesh(n_data, n_seq, d, s, rows[d])


def shard_batch(x: torch.Tensor, mesh: StreamMesh, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of ``axis`` over ``data``
    (`shard.py:shard_batch` :1754: with one process a rank, placing an
    array with ``P('data')`` means keeping the ``data``-th of n_data equal
    slices; every rank of a ``seq`` row keeps the same one).  A copy, so
    the kernels can read it."""
    n = x.shape[axis]
    if n % mesh.n_data:
        raise ValueError(f"axis {axis} of {n} does not divide over {mesh.n_data} data slices")
    b = n // mesh.n_data
    return x.narrow(axis, mesh.data * b, b).contiguous()


# ---------------------------------------------------------------------------
# Collectives (within the seq group)
# ---------------------------------------------------------------------------

def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective of ``group`` takes for t: a host copy where
    the backend is gloo and t lies on the card (host staging, module
    docstring), else t itself, contiguous."""
    if t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return t.cpu()
    return t.contiguous()


class PendingHalos:
    """Posted halo sends and receives; `wait` returns, per block, the
    (from_left, from_right) halos on the block's device.  It holds the send
    buffers until then: a send reads its buffer until it completes."""

    def __init__(self, works, recvs, sends, devices):
        self._works, self._recvs, self._sends, self._devices = works, recvs, sends, devices

    def wait(self) -> list[tuple[torch.Tensor | None, torch.Tensor | None]]:
        for w in self._works:
            w.wait()
        return [tuple(None if r is None else r.to(dev) for r in pair)
                for pair, dev in zip(self._recvs, self._devices)]


def post_halos(blocks, left: int, right: int, mesh: StreamMesh) -> PendingHalos:
    """Send each block's trailing ``left`` samples to the right ``seq``
    neighbour and its leading ``right`` samples to the left one, and post
    the matching receives, without waiting: the caller works on while the
    halos travel.  Boundary shards receive zeros (the zero-filled delay
    line of the RTL model, reference ref/minn_delay_line.sv:58-74).  Last
    axis; each halo keeps its block's dtype."""
    s, n, g = mesh.seq, mesh.n_seq, mesh.seq_group
    ops, recvs, sends = [], [], []
    for k, blk in enumerate(blocks):
        pair = []
        for width, lo, to, frm, tag in ((left, blk.shape[-1] - left, s + 1, s - 1, 2 * k),
                                        (right, 0, s - 1, s + 1, 2 * k + 1)):
            if width <= 0:
                pair.append(None)
                continue
            out = _wire(blk[..., lo: lo + width], g)
            recv = torch.zeros_like(out)
            if 0 <= to < n:
                sends.append(out)
                ops.append(dist.P2POp(dist.isend, out, mesh.seq_rank(to), g, tag))
            if 0 <= frm < n:
                ops.append(dist.P2POp(dist.irecv, recv, mesh.seq_rank(frm), g, tag))
            pair.append(recv)
        recvs.append(tuple(pair))
    works = dist.batch_isend_irecv(ops) if ops else []
    return PendingHalos(works, recvs, sends, [b.device for b in blocks])


def halo_exchange(block: torch.Tensor, left: int, right: int, mesh: StreamMesh) -> torch.Tensor:
    """The block extended by ``left`` trailing samples of its left ``seq``
    neighbour and ``right`` leading samples of its right one (zeros at the
    ends of the stream); last axis (`shard.py:45`)."""
    from_left, from_right = post_halos((block,), left, right, mesh).wait()[0]
    return torch.cat([t for t in (from_left, block, from_right) if t is not None], dim=-1)


def _all_gather_seq(t: torch.Tensor, mesh: StreamMesh) -> torch.Tensor:
    """(n_seq,) + t.shape: every rank's t, in seq order, on t's device."""
    src = _wire(t, mesh.seq_group)
    out = [torch.empty_like(src) for _ in range(mesh.n_seq)]
    dist.all_gather(out, src, group=mesh.seq_group)
    return torch.stack(out).to(t.device)


def _all_reduce_seq(t: torch.Tensor, mesh: StreamMesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` (the sum by default) of every rank's t over the seq group, on
    t's device (a contiguous t not staged through the host holds it too)."""
    buf = _wire(t, mesh.seq_group)
    dist.all_reduce(buf, op=op, group=mesh.seq_group)
    return buf.to(t.device)


# ---------------------------------------------------------------------------
# Blocked linear recurrence (the exact IIR across shards)
# ---------------------------------------------------------------------------

def carry_in(A_tot: torch.Tensor, s_last: torch.Tensor, mesh: StreamMesh) -> torch.Tensor:
    """The register carried into this shard: one all-gather of each shard's
    (prod a, final s from zero) per stream, A_tot and s_last (...), then the
    exclusive shard-order combine ``sum_{j<s} S_j prod_{j<m<s} A_m``.
    Every rank of the seq group must call it."""
    g = _all_gather_seq(torch.stack([A_tot, s_last]), mesh)  # (n_seq, 2, ...)
    carry = torch.zeros_like(s_last)
    for j in range(mesh.seq):
        carry = carry * g[j, 0] + g[j, 1]
    return carry


def carry_fixup(s_local: torch.Tensor, cum_a: torch.Tensor, mesh: StreamMesh) -> torch.Tensor:
    """The carry fix-up of `blocked_linear_recurrence`: s_local (..., block)
    solved from zero at the shard's start, cum_a (block,) or (..., block)
    the running product of its a.  Returns ``s_local + carry * cum_a``
    (`carry_in`).  cum_a underflows to exact zero within a few thousand
    samples of a decaying IIR, and then the carry no longer reaches: that
    is the recurrence, not a loss."""
    A_tot = cum_a[..., -1].expand(s_local.shape[:-1])
    return s_local + carry_in(A_tot, s_local[..., -1], mesh).unsqueeze(-1) * cum_a


def blocked_linear_recurrence(a: torch.Tensor, b: torch.Tensor, mesh: StreamMesh) -> torch.Tensor:
    """Exact ``s[n] = a[n] s[n-1] + b[n]`` over the stream cut on ``seq``
    (`shard.py:blocked_linear_recurrence` :82), ``s[-1] = 0`` at the
    stream's start: each shard scans its (a, b) from zero
    (`ops.windows.linear_recurrence`), then `carry_fixup`.  a, b (...,
    block): this rank's block of the last axis."""
    return carry_fixup(linear_recurrence(a, b), torch.cumprod(a, dim=-1), mesh)


# ---------------------------------------------------------------------------
# Event-table merge
# ---------------------------------------------------------------------------

def merge_stacked_event_tables(gathered, *, h: int, E: int, K: int, tie_last: bool,
                               emit_unclosed: bool):
    """Merge event tables stacked on a leading axis in time order, with no
    collective (`shard.py:_merge_stacked_event_tables`).  ``gathered`` is
    (start, close, peak_idx, packed float32 (K * E: peak_value, then the
    captured fields), closed, count, overflow), each (n_pieces, B, ...).

    A piece's first gate continues the output's trailing gate iff its start
    lies within h of that gate's last above sample (the close minus h); the
    larger peak wins, and of equal peaks the later (``tie_last``) or the
    earlier index, and the K fields follow it; the later close wins (a
    continuation with no above sample of its own carries an earlier one).
    Returns (GateEvents (B, E), the K - 1 captured fields, each (B, E))."""
    start, close, pidx, pval, closed, count, overflow = gathered
    B, dev, i64 = start.shape[1], start.device, torch.int64
    slot = torch.arange(E, device=dev)[None, :]
    o_start = torch.zeros((B, E), dtype=i64, device=dev)
    o_close, o_pidx = o_start.clone(), o_start.clone()
    o_pval = torch.zeros((B, K, E), dtype=torch.float32, device=dev)  # field k of slot e
    o_closed = torch.zeros((B, E), dtype=torch.bool, device=dev)
    cnt = torch.zeros(B, dtype=i64, device=dev)
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    trail_la = torch.full((B,), -(2**30), dtype=i64, device=dev)
    for p in range(start.shape[0]):
        s_start, s_close, s_pidx = (a[p].to(i64) for a in (start, close, pidx))
        s_pval, s_closed = pval[p].to(torch.float32).reshape(B, K, E), closed[p].to(torch.bool)
        s_cnt, s_ovf = count[p].to(i64), overflow[p].to(torch.bool)
        has = s_cnt > 0
        merge = has & (cnt > 0) & (s_start[:, 0] - trail_la <= h)

        # the piece's first gate into the output's trailing one
        last = (cnt - 1).clamp(0, E - 1)[:, None]
        sel_last = (slot == last) & merge[:, None]
        cur_f = o_pval.gather(2, last[:, None, :].expand(B, K, 1))[..., 0]  # (B, K)
        cur_pi, new_pi = o_pidx.gather(1, last)[:, 0], s_pidx[:, 0]
        later = new_pi > cur_pi if tie_last else new_pi < cur_pi
        take = (s_pval[:, 0, 0] > cur_f[:, 0]) | ((s_pval[:, 0, 0] == cur_f[:, 0]) & later)
        mg_f = torch.where(take[:, None], s_pval[:, :, 0], cur_f)
        o_pval = torch.where(sel_last[:, None, :], mg_f[:, :, None], o_pval)
        o_pidx = torch.where(sel_last, torch.where(take, new_pi, cur_pi)[:, None], o_pidx)
        cur_close, cur_closed = o_close.gather(1, last)[:, 0], o_closed.gather(1, last)[:, 0]
        adv = s_close[:, 0] >= cur_close
        o_close = torch.where(sel_last, torch.where(adv, s_close[:, 0], cur_close)[:, None],
                              o_close)
        o_closed = torch.where(sel_last, torch.where(adv, s_closed[:, 0], cur_closed)[:, None],
                               o_closed)

        # the piece's other gates appended in order
        drop = merge.to(i64)
        for e in range(E):
            sel = (((e < s_cnt) & ~(merge & (e == 0)))[:, None]
                   & (slot == (cnt + e - drop)[:, None]))
            o_start = torch.where(sel, s_start[:, e: e + 1], o_start)
            o_close = torch.where(sel, s_close[:, e: e + 1], o_close)
            o_pidx = torch.where(sel, s_pidx[:, e: e + 1], o_pidx)
            o_pval = torch.where(sel[:, None, :], s_pval[:, :, e: e + 1], o_pval)
            o_closed = torch.where(sel, s_closed[:, e: e + 1], o_closed)
        total = cnt + torch.where(has, s_cnt - drop, 0)
        ovf = ovf | s_ovf | (total > E)
        cnt = total.clamp(max=E)
        s_last = (s_cnt - 1).clamp(0, E - 1)[:, None]
        trail_la = torch.where(has, s_close.gather(1, s_last)[:, 0] - h, trail_la)

    exists = slot < cnt[:, None]
    valid = exists & (o_closed | emit_unclosed)
    fvals = torch.where(exists[:, None, :], o_pval, 0.0)
    i32 = torch.int32
    table = GateEvents(
        valid=valid, closed=o_closed & exists,
        gate_start=torch.where(exists, o_start, 0).to(i32),
        gate_close=torch.where(exists, o_close, 0).to(i32),
        peak_idx=torch.where(exists, o_pidx, 0).to(i32),
        peak_value=fvals[:, 0], count=valid.sum(dim=-1, dtype=i32), overflow=ovf)
    return table, tuple(fvals[:, k] for k in range(1, K))


def stack_tables(tables) -> tuple:
    """The tables of a stream's pieces in time order -> the ``gathered``
    tuple of `merge_stacked_event_tables` with K = 1."""
    return tuple(torch.stack([getattr(t, f) for t in tables])
                 for f in ("gate_start", "gate_close", "peak_idx", "peak_value", "closed",
                           "count", "overflow"))


def merge_shard_event_tables(table: GateEvents, mesh: StreamMesh, *, h: int, E: int,
                             tie_last: bool, emit_unclosed: bool, extras=()):
    """This shard's table (global indices, unclosed gates emitted) merged
    with every other shard's of its ``seq`` group: the fields and the
    float32 ones (peak_value and the ``extras`` captured at the peak) as
    int32, bit for bit, in one buffer, one all-gather, then
    `merge_stacked_event_tables` (`shard.py:_merge_shard_event_tables`).
    Returns (GateEvents, merged extras)."""
    i32 = torch.int32
    K = 1 + len(extras)
    fpacked = torch.cat([table.peak_value, *extras], dim=-1).to(torch.float32).contiguous()
    packed = torch.cat([table.gate_start, table.gate_close, table.peak_idx,
                        table.closed.to(i32), table.count.to(i32)[:, None],
                        table.overflow.to(i32)[:, None], fpacked.view(i32)], dim=-1)
    g = _all_gather_seq(packed, mesh)  # (n_seq, B, (4 + K) E + 2)
    gathered = (g[..., :E], g[..., E: 2 * E], g[..., 2 * E: 3 * E],
                g[..., 4 * E + 2:].contiguous().view(torch.float32),
                g[..., 3 * E: 4 * E].to(torch.bool), g[..., 4 * E],
                g[..., 4 * E + 1].to(torch.bool))
    return merge_stacked_event_tables(gathered, h=h, E=E, K=K, tie_last=tie_last,
                                      emit_unclosed=emit_unclosed)


# ---------------------------------------------------------------------------
# Closed-form event merge (per sample, across seq)
# ---------------------------------------------------------------------------

_I32_MAX = 2**31 - 1


def cross_shard_event_merge(above: torch.Tensor, track: torch.Tensor, start: int,
                            mesh: StreamMesh, *, h: int, E: int, n: int, tie_last: bool,
                            emit_unclosed: bool, extras=()):
    """Gate/peak events of a stream cut over ``seq``, from every shard's
    per-sample gate input (`shard.py:_cross_shard_event_merge` :437).

    above bool, track float32, each (B_loc, block): this rank's samples,
    global indices ``start + arange(block)``; ``n`` the global length of
    the close rule; ``extras`` float32 (B_loc, block) arrays read at each
    slot's peak.  Gates are above-clusters with gaps <= h (the closed form
    of the fused kernels).  The only state that crosses a seam is the last
    above index and the number of clusters before it: one all-gather of
    each shard's (last above, first above, clusters after its first) gives
    every shard both by exclusive scans.  Each shard then reduces its gated
    samples of the first E clusters (found by one `nonzero`, a host sync)
    into the E slots by cluster id, one `scatter_reduce` per quantity (a
    spare slot for the other samples would serialize millions of atomic
    updates of one address on the card), and the slots combine across
    ``seq`` with all-reduces: one MAX of (-start, last above, peak value)
    in float64 (exact for int32 indices and float32 values), one MAX of
    the peak index among the shards whose own best equals the peak value
    (negated for tie 'first', which takes the earliest), and one SUM of
    the extras, which only the sample at the peak index contributes.
    Returns (GateEvents (B_loc, E), the merged extras, each (B_loc, E)),
    the same on every rank of the seq group."""
    B, blk = above.shape
    dev, i32 = above.device, torch.int32
    gi = start + torch.arange(blk, dtype=i32, device=dev)
    la_local = torch.where(above, gi, -1).cummax(dim=-1).values
    prev_local = torch.cat([torch.full((B, 1), -1, dtype=i32, device=dev), la_local[:, :-1]], 1)
    first = torch.where(above, gi, _I32_MAX).amin(dim=-1)
    rest = (above & (prev_local >= 0) & (gi - prev_local > h)).sum(dim=-1, dtype=i32)
    g = _all_gather_seq(torch.stack([la_local[:, -1], first, rest]), mesh)  # (n_seq, 3, B)
    carry_la_all = torch.cat([torch.full_like(g[:1, 0], -1), g[:-1, 0].cummax(dim=0).values])
    first_new = (g[:, 1] < _I32_MAX) & ((carry_la_all < 0) | (g[:, 1] - carry_la_all > h))
    counts = g[:, 2] + first_new
    carry_count = (counts.cumsum(dim=0, dtype=i32) - counts)[mesh.seq][:, None]
    carry_la = carry_la_all[mesh.seq][:, None]
    total = counts.sum(dim=0)

    prev = torch.maximum(prev_local, carry_la)
    new_cluster = above & ((prev < 0) | (gi - prev > h))
    cluster_id = carry_count + new_cluster.cumsum(dim=-1, dtype=i32)
    last_above = torch.maximum(la_local, carry_la)
    in_gate = (last_above >= 0) & (gi - last_above <= h) & (cluster_id >= 1)
    # the gated samples of the E slots, and each one's slot b * E + cluster - 1
    b_idx, j = (in_gate & (cluster_id <= E)).nonzero(as_tuple=True)
    slot = b_idx * E + cluster_id[b_idx, j].long() - 1
    gs, tr = gi[j].long(), track[b_idx, j]

    def reduce(src, how, fill):
        out = torch.full((B * E,), fill, dtype=src.dtype, device=dev)
        return out.scatter_reduce_(0, slot, src, how).view(B, E)

    start_loc = reduce(gs, "amin", _I32_MAX)
    last_loc = reduce(torch.where(above[b_idx, j], gs, -1), "amax", -1)
    pv_loc = reduce(tr, "amax", float("-inf"))
    sign = 1 if tie_last else -1
    pidx_loc = reduce(torch.where(tr == pv_loc.view(-1)[slot], sign * gs, -_I32_MAX), "amax",
                      -_I32_MAX)

    packed = torch.stack([-start_loc, last_loc, pv_loc], dim=1).to(torch.float64)
    packed = _all_reduce_seq(packed, mesh, dist.ReduceOp.MAX)
    gate_start, last_seg = (-packed[:, 0]).long(), packed[:, 1].long()
    peak_val = packed[:, 2].to(torch.float32)
    winner = (start_loc < _I32_MAX) & (pv_loc == peak_val)
    peak_idx = sign * _all_reduce_seq(torch.where(winner, pidx_loc, -_I32_MAX), mesh,
                                      dist.ReduceOp.MAX)
    extra_vals = ()
    if extras:
        at_peak = gs == peak_idx.view(-1)[slot]
        cols = torch.stack([reduce(torch.where(at_peak, a[b_idx, j], 0.0), "sum", 0.0)
                            for a in extras], dim=1)
        extra_vals = tuple(_all_reduce_seq(cols, mesh).unbind(dim=1))

    exists = torch.arange(E, device=dev) < total.clamp_max(E)[:, None]
    close_raw = last_seg + h
    closed = (close_raw <= n - 1) & exists
    valid = exists if emit_unclosed else exists & closed
    table = GateEvents(
        valid=valid, closed=closed, gate_start=torch.where(exists, gate_start, 0).to(i32),
        gate_close=torch.where(exists, close_raw.clamp(0, n - 1), 0).to(i32),
        peak_idx=torch.where(exists, peak_idx, 0).to(i32),
        peak_value=torch.where(exists, peak_val, 0.0), count=valid.sum(dim=-1, dtype=i32),
        overflow=total > E)
    return table, tuple(torch.where(exists, v, 0.0) for v in extra_vals)


# ---------------------------------------------------------------------------
# Sharded metrics
# ---------------------------------------------------------------------------

def _left_halo(x: torch.Tensor, width: int, mesh: StreamMesh) -> torch.Tensor:
    """The ``width`` samples before this rank's block (zeros at the
    stream's start), in x's dtype; x must hold at least that many."""
    if x.shape[-1] < width:
        raise ValueError(f"seq shard of {x.shape[-1]} samples is shorter than its {width}-sample "
                         "halo; use fewer seq shards")
    return post_halos((x,), width, 0, mesh).wait()[0][0]


def sharded_minn_rtl_planar(
    x: torch.Tensor,
    mesh: StreamMesh,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
):
    """The Minn-RTL metric of a stream cut over ``seq``
    (`shard.py:sharded_minn_rtl_planar` :357, channel-leading).

    x: this rank's block (2*branches, B_loc, block) float32 or int16.  Per
    shard a 3Q left halo primes kernel A's full-metric mode (its delay line
    and windows; ``base_index`` the shard's start), with the smoothing
    register started at zero: its smooth is then the s_local of
    `blocked_linear_recurrence` (a = 1 - alpha from valid_from = 3Q - 1
    on, 1 before; b = alpha corr_positive), in the kernel's rounding order
    (sequential ``(1 - alpha) s + alpha c``, where JAX scans).
    `minn_fixup` adds the register carried in from the shards before, and
    recomputes ``above`` from the fixed-up smooth where the carry reaches
    (kernel A's own is right past that and on the first shard).  On the
    CPU kernel A's plain version runs.  Returns (corr_positive, smooth,
    energy_total, above), each (B_loc, block)."""
    _check_input(x)
    Q = quarter_len
    block, start = x.shape[-1], mesh.seq * x.shape[-1]
    halo = _left_halo(x, 3 * Q, mesh)
    st = minn_rtl_metric_planar_fused(
        x, quarter_len=Q, smooth_shift=smooth_shift, threshold_value=threshold_value,
        threshold_frac_bits=threshold_frac_bits, base_index=start, hist_init=halo,
        carry_init=torch.zeros(x.shape[1], device=x.device))
    smooth, above = minn_fixup(st, start, mesh, smooth_shift=smooth_shift,
                               threshold_value=threshold_value,
                               threshold_frac_bits=threshold_frac_bits)
    return st.corr_positive, smooth, st.energy_total, above


def minn_fixup(st, start: int, mesh: StreamMesh, *, smooth_shift: int, threshold_value: int,
               threshold_frac_bits: int):
    """`sharded_minn_rtl_planar`'s step after kernel A: the register
    carried in (`carry_in`; a = 1 - alpha from valid_from on, 1 before)
    and ``above`` from the fixed-up smooth.  st: kernel A's full metric of
    the shard, register started at zero; ``start`` its global index.

    The carry reaches only as far as the running product of a is above
    zero, and (1 - alpha)^n underflows float32 within 149 ln 2 / -ln(1 -
    alpha) samples past valid_from (~770 at shift 3).  So only a prefix of
    the shard, twice that reach and 64 samples more, is fixed up, in place
    in st's smooth and above; past it kernel A's own smooth and above are
    already the recurrence's.  The stream's first shard has no carry and
    keeps them whole.  Returns (smooth, above)."""
    smooth, above = st.smooth_metric, st.above_threshold
    block = smooth.shape[-1]
    alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0
    decay = -math.log1p(-alpha) if alpha < 1.0 else math.inf
    lead = min(max(st.valid_from - start, 0), block)
    P = min(block, lead + 2 * math.ceil(149 * math.log(2) / decay) + 64)
    valid = start + torch.arange(P, device=smooth.device) >= st.valid_from
    cum_a = torch.cumprod(torch.where(valid, 1.0 - alpha, 1.0).to(torch.float32), dim=-1)
    A_tot = cum_a[-1] if P == block else torch.zeros((), device=smooth.device)
    carry = carry_in(A_tot.expand(smooth.shape[:-1]), smooth[..., -1], mesh)
    if mesh.seq:
        head = smooth[..., :P] + carry.unsqueeze(-1) * cum_a
        smooth[..., :P] = head
        above[..., :P] = valid & (head * float(1 << threshold_frac_bits)
                                  >= st.energy_total[..., :P] * float(threshold_value))
    return smooth, above


def sharded_minn_rtl_metric(rx: torch.Tensor, mesh: StreamMesh, **metric):
    """One stream's Minn-RTL metric (`shard.py:sharded_minn_rtl_metric`
    :176): rx, this rank's block (branches, block) complex, through
    `sharded_minn_rtl_planar` (the same arithmetic, i*i + q*q powers).
    Returns (corr_positive, smooth, energy_total, above), each (block,)."""
    x = torch.stack([rx.real, rx.imag], dim=1).to(torch.float32).reshape(-1, 1, rx.shape[-1])
    return tuple(t[0] for t in sharded_minn_rtl_planar(x, mesh, **metric))


def sharded_aa_metric(x: torch.Tensor, mesh: StreamMesh, half_len: int):
    """The [A][A] metric of a stream cut over ``seq``
    (`shard.py:sharded_aa_metric` :267, channel-leading): per shard kernel
    C's metric mode primed from a 2L left halo (the metric has no IIR, so
    the halo alone makes each shard exact).  M is formed from P and R as
    kernel C's detect mode forms it, ``min(|P|^2 / max(R, 1e-12)^2, 1)``
    where ``n >= L`` and ``R > 1e-6 L`` (JAX's noise floor), else 0.
    x: (2*branches, B_loc, block) float32 or int16.  Returns (P complex64,
    R, M, valid), each (B_loc, block)."""
    _check_input(x)
    L = half_len
    start = mesh.seq * x.shape[-1]
    o = aa_metric(x, half_len=L, base_index=start, hist_init=_left_halo(x, 2 * L, mesh))
    M, valid = _aa_normalized(o.P_re * o.P_re + o.P_im * o.P_im, o.R, L, start)
    return torch.complex(o.P_re, o.P_im), o.R, M, valid.expand(o.R.shape)


def sharded_sc_metric(x: torch.Tensor, mesh: StreamMesh, n_fft: int):
    """The Schmidl-Cox metric of a stream cut over ``seq``
    (`shard.py:sharded_sc_metric` :314, channel-leading): a forward window,
    so each shard takes a RIGHT halo of n_fft samples, then computes
    `ops.metrics.sc_metric`'s windowed sums over [block; halo] in plain
    torch (the family has no TPU kernel).  x: (2*branches, B_loc, block).
    Returns (M, P complex64, R), each (B_loc, block); the stream's last
    n_fft - 1 offsets read the zeros past its end, as in JAX."""
    _check_input(x)
    half, block = n_fft // 2, x.shape[-1]
    if n_fft % 2 or block < n_fft:
        raise ValueError(f"n_fft must be even and at most the {block}-sample block, got {n_fft}")
    ext = halo_exchange(x.to(torch.float32), 0, n_fft, mesh)
    xc = torch.complex(ext[0::2], ext[1::2])
    P = sliding_sum_valid(xc[..., :-half] * xc[..., half:].conj(), half).sum(dim=0)[..., :block]
    R = sliding_sum_valid(xc.abs() ** 2, half)[..., half: half + block].sum(dim=0)
    return P.abs() ** 2 / R.clamp_min(1e-12) ** 2, P, R


# ---------------------------------------------------------------------------
# Sharded detectors
# ---------------------------------------------------------------------------

def _gate_from_tail(above_tail: torch.Tensor, first_index: int, h: int) -> torch.Tensor:
    """Kernel B's gate_init at ``first_index`` from the above bits of the h
    samples before it (`shard.py:_gate_init_from_tail`): the last above
    index la, as the gate carry [la, 1] of `minn_rtl_fused.gate_continuation`
    ([-1, 0] where none)."""
    gi = first_index - h + torch.arange(h, device=above_tail.device)
    la = torch.where(above_tail, gi, -1).amax(dim=-1).to(torch.int32)
    return gate_continuation(torch.stack([la, torch.zeros_like(la)], dim=-1), first_index, h)


def minn_halo_width(quarter_len: int, smooth_shift: int, hysteresis: int) -> int:
    """Left-halo samples that prime a shard exactly (`shard.py:
    _minn_halo_width`): kernel A's halo (`metric_halo`: 3Q of delay line
    and the smoothing memory) plus the h samples whose above bits prime
    the gate."""
    return metric_halo(quarter_len, smooth_shift) + max(int(hysteresis), 1)


def _seq_block(x: torch.Tensor, mesh: StreamMesh, halo: int, stream_len: int | None):
    """(block, global stream length, shard start) of this rank's block."""
    block = x.shape[-1]
    n = mesh.n_seq * block
    L = n if stream_len is None else int(stream_len)
    if block < halo:
        raise ValueError(f"seq shard of {block} samples is shorter than its {halo}-sample halo; "
                         "use fewer seq shards")
    if not (mesh.n_seq - 1) * block < L <= n:
        raise ValueError(f"stream_len {L} must lie in the last of {mesh.n_seq} blocks of {block}")
    return block, L, mesh.seq * block


def sharded_minn_rtl_detect_fused(
    x: torch.Tensor,
    mesh: StreamMesh,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    max_events: int = 8,
    tie: str = "last",
    emit_unclosed: bool = False,
    stream_len: int | None = None,
    overlap_halo: bool = False,
    rows: int | None = None,
) -> GateEvents:
    """Minn-RTL detection of a stream cut over the ``seq`` axis: kernels A
    and B per shard in their carried mode, primed from a halo, then the
    table merge (`shard.py:sharded_minn_rtl_detect_fused` :702, with the
    halo-overlap split of `sharded_minn_rtl_detect_fused_tm` :859).

    x: this rank's block, channel-leading (2*branches, B_loc, block)
    float32 or int16; ``stream_len`` the global length (padding allowed
    only in the last block; default n_seq * block).  The halo is the
    W = `minn_halo_width` samples before the shard, from the left
    neighbour (int16 on the wire for int16 input): kernel A's history, and,
    through the plain metric over those W samples, its smoothing register
    and kernel B's gate carry (`shard.py:951-967`).

    By default the shard runs as one primed call once the halo is in.
    ``overlap_halo=True`` splits it: only the first ``rows`` samples need
    the halo, so the halo's receive is posted, the interior ``x[...,
    rows:]`` runs first, primed from the shard's own samples [rows - W,
    rows), and then the first rows, primed from the halo; both calls read x
    in place (kernel A's strided mode) and their tables merge locally
    before the merge across ``seq``.  The split costs a second priming pass
    and a local merge, and pays only where the halo's transfer outlasts
    them, which no measurement has shown yet.  ``rows`` defaults to W
    rounded up to 1024.  Returns the merged `GateEvents` (B_loc, E), the
    same on every rank of the seq group and equal to the one-shot
    detection of the whole stream."""
    _check_input(x)
    Q, h = quarter_len, max(int(hysteresis), 1)
    W = minn_halo_width(Q, smooth_shift, hysteresis)
    block, L, start = _seq_block(x, mesh, W, stream_len)
    rows = -(-W // 1024) * 1024 if rows is None else int(rows)
    if overlap_halo and not W <= rows < block:
        raise ValueError(f"the overlap split needs W = {W} <= rows < block = {block}, got {rows}")
    metric = dict(quarter_len=Q, smooth_shift=smooth_shift, threshold_value=threshold_value,
                  threshold_frac_bits=threshold_frac_bits)
    det = dict(metric, hysteresis=hysteresis, max_events=max_events, tie=tie,
               emit_unclosed=True, stream_len_global=L)

    def prime(tail: torch.Tensor, first: int) -> tuple:
        """(hist, carry, gate) at global index ``first`` from the W samples
        before it, tail (C, B_loc, W)."""
        st = minn_rtl_metric_planar(_planar_view(tail), **metric)
        gi = first - h + torch.arange(h, device=tail.device)
        above = st.above_threshold[:, -h:] & (gi >= st.valid_from)
        return tail.to(torch.float32), st.smooth_metric[:, -1], _gate_from_tail(above, first, h)

    pending = post_halos((x,), W, 0, mesh)
    if overlap_halo:
        rest = minn_rtl_detect_fused(x[..., rows:], **det, base_index=start + rows,
                                     shard_init=prime(x[..., rows - W: rows], start + rows))
        halo = pending.wait()[0][0]
        first = minn_rtl_detect_fused(x[..., :rows], **det, base_index=start,
                                      shard_init=prime(halo, start))
        table, _ = merge_stacked_event_tables(stack_tables((first, rest)), h=h, E=max_events, K=1,
                                              tie_last=tie == "last", emit_unclosed=True)
    else:
        halo = pending.wait()[0][0]
        table = minn_rtl_detect_fused(x, **det, base_index=start, shard_init=prime(halo, start))
    return merge_shard_event_tables(table, mesh, h=h, E=max_events, tie_last=tie == "last",
                                    emit_unclosed=emit_unclosed)[0]


def sharded_zc_iq_detect(
    mf: torch.Tensor,
    iq: torch.Tensor,
    mesh: StreamMesh,
    *,
    ref_len: int,
    ref_norm: float,
    stream_len: int | None = None,
    corr_window: int = 2048,
    threshold_value: int | None = None,
    threshold_frac_bits: int = 15,
    min_corr_mag: float = 0.3,
    hysteresis: int = 256,
    max_events: int = 16,
    tie: str = "first",
    emit_unclosed: bool = True,
) -> GateEvents:
    """From-IQ ZC detection of a stream cut over the ``seq`` axis of the
    correlation outputs (`shard.py:sharded_zc_iq_detect_tm` :1471, on the
    channel-leading layout): kernel D in its primed IQ mode per shard, then
    kernel B carried, then the table merge.

    mf, iq: this rank's blocks of the planar matched-filter output and of
    the IQ zero-padded to the same length, each (2*BR, B_loc, block); mf
    float32, iq float32 or int16.  ``stream_len`` is the global correlation
    length Lc (padding only in the last block).  The halo is the
    `zc_tm_halo_rows` samples before the shard of both mf and IQ, from the
    left neighbour in one exchange; kernel D pushes it through its own
    datapath and primes kernel B's gate on the card."""
    if mf.shape != iq.shape:
        raise ValueError(f"mf and iq blocks must share a shape, got {tuple(mf.shape)} and "
                         f"{tuple(iq.shape)}")
    Wh = zc_tm_halo_rows(ref_len, corr_window, hysteresis)
    _, L, start = _seq_block(mf, mesh, Wh, stream_len)
    (mf_halo, _), (iq_halo, _) = post_halos((mf, iq), Wh, 0, mesh).wait()
    table = zc_iq_cfar_detect(
        mf, iq, ref_len=ref_len, ref_norm=ref_norm, corr_window=corr_window,
        threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits,
        min_corr_mag=min_corr_mag, hysteresis=hysteresis, max_events=max_events, tie=tie,
        emit_unclosed=True, base_index=start, stream_len_global=L,
        shard_init=(mf_halo, iq_halo))
    return merge_shard_event_tables(table, mesh, h=max(int(hysteresis), 1), E=max_events,
                                    tie_last=tie == "last", emit_unclosed=emit_unclosed)[0]


def sharded_aa_detect_fused(
    x: torch.Tensor,
    mesh: StreamMesh,
    *,
    half_len: int,
    threshold: float = 0.15,
    hysteresis: int = 128,
    max_events: int = 8,
    tie: str = "first",
    emit_unclosed: bool = True,
    stream_len: int | None = None,
):
    """[A][A] detection of a stream cut over the ``seq`` axis
    (`shard.py:sharded_aa_detect_fused` :1233, channel-leading): kernel C
    primed and kernel B carried with capture per shard, then the table
    merge with (P_re, P_im, M) at each peak as three packed fields.

    x: this rank's block (2*branches, B_loc, block) float32 or int16.  The
    halo is round_up(2L, 128) + h samples: kernel C's history (the metric
    has no IIR), and, through the plain metric over it, kernel B's gate
    carry.  Returns (GateEvents (B_loc, E), P_at_peak (B_loc, 2, E),
    M_at_peak (B_loc, E)), as `aa_detect_fused`."""
    _check_input(x)
    L_, h = half_len, max(int(hysteresis), 1)
    W = -(-2 * L_ // 128) * 128 + h
    _, L, start = _seq_block(x, mesh, W, stream_len)
    halo = _left_halo(x, W, mesh).to(torch.float32)
    M = aa_metric_planar(_planar_view(halo), L_).M
    gi = start - h + torch.arange(h, device=x.device)
    gate = _gate_from_tail((M[:, -h:] >= threshold) & (gi >= L_), start, h)
    table, P, Mk = aa_detect_fused(
        x, half_len=L_, threshold=threshold, hysteresis=hysteresis, max_events=max_events,
        tie=tie, emit_unclosed=True, base_index=start, stream_len_global=L,
        shard_init=(halo, gate))
    merged, (p_re, p_im, m) = merge_shard_event_tables(
        table, mesh, h=h, E=max_events, tie_last=tie == "last", emit_unclosed=emit_unclosed,
        extras=(P[:, 0], P[:, 1], Mk))
    return merged, torch.stack([p_re, p_im], dim=1), m


def sharded_minn_rtl_detect(
    x: torch.Tensor,
    mesh: StreamMesh,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    max_events: int = 8,
    tie: str = "last",
    emit_unclosed: bool = False,
) -> GateEvents:
    """Minn-RTL detection of a stream cut over ``seq`` through the
    per-sample merge (`shard.py:sharded_minn_rtl_detect` :602):
    `sharded_minn_rtl_planar`, then `cross_shard_event_merge` tracking
    corr_positive.  x: (2*branches, B_loc, block) float32 or int16.
    Returns `GateEvents` (B_loc, E), the same on every rank of the seq
    group, equal to `ops.detect.extract_gate_events` on the whole stream
    (valid from 3Q - 1)."""
    corr, _, _, above = sharded_minn_rtl_planar(
        x, mesh, quarter_len=quarter_len, smooth_shift=smooth_shift,
        threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits)
    return cross_shard_event_merge(
        above, corr, mesh.seq * x.shape[-1], mesh, h=max(int(hysteresis), 1), E=max_events,
        n=mesh.n_seq * x.shape[-1], tie_last=tie == "last", emit_unclosed=emit_unclosed)[0]


def sharded_zc_cfar_detect(
    corr_mag: torch.Tensor,
    mesh: StreamMesh,
    *,
    corr_window: int = 2048,
    threshold_value: int | None = None,
    threshold_frac_bits: int = 15,
    min_corr_mag: float = 0.3,
    hysteresis: int = 256,
    max_events: int = 16,
    tie: str = "first",
    emit_unclosed: bool = True,
) -> GateEvents:
    """ZC CFAR detection over matched-filter magnitudes cut over ``seq``
    (`shard.py:sharded_zc_cfar_detect` :1365): kernel D's magnitude mode
    primed per shard, kernel B carried, then the table merge.

    corr_mag: this rank's block (B_loc, block) float32.  The halo is the
    W + h magnitudes before the shard: its last W are kernel D's history
    (the local sum's reach), and the CFAR decisions of its last h, from the
    plain gate input over the halo, prime kernel B's gate.  (JAX rounds W
    up to a multiple of 128 lanes first, a TPU layout need that the card
    does not share.)  Returns `GateEvents` (B_loc, E), the same on every
    rank of the seq group, equal to `zc_cfar_detect` on the whole stream."""
    W, h = corr_window, max(int(hysteresis), 1)
    T = default_threshold(W, threshold_frac_bits) if threshold_value is None else threshold_value
    block, start = corr_mag.shape[-1], mesh.seq * corr_mag.shape[-1]
    cfar = dict(corr_window=W, threshold_value=T, threshold_frac_bits=threshold_frac_bits,
                min_corr_mag=min_corr_mag)
    halo = _left_halo(corr_mag, W + h, mesh)
    above_tail = cfar_gate(halo, **cfar, base_index=start - W - h)[0][:, -h:]
    table = zc_cfar_detect(
        corr_mag, **cfar, hysteresis=hysteresis, max_events=max_events, tie=tie,
        emit_unclosed=True, base_index=start, stream_len_global=mesh.n_seq * block,
        shard_init=(halo[:, h:], _gate_from_tail(above_tail, start, h)))
    return merge_shard_event_tables(table, mesh, h=h, E=max_events, tie_last=tie == "last",
                                    emit_unclosed=emit_unclosed)[0]


def fft_matched_filter(ext: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """The torch FFT route of `zc_matched_filter` (`ops.channel.
    fft_convolve_full`, overlap-save from 2^16 samples, as JAX's 'xla'
    mode), the same output."""
    n = ext.shape[-1]
    xc, k = torch.complex(ext[0::2], ext[1::2]), kern.to(ext.device)
    conv = (fft_convolve_full_ols(xc, k) if n >= 1 << 16 else fft_convolve_full(xc, k))[..., :n]
    return torch.stack([conv.real, conv.imag], dim=1).reshape(ext.shape)


def zc_matched_filter(ext: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """`sharded_zc_detect`'s matched filter of an extended block ext (C,
    B, n) planar float32 with the taps kern (R,) complex64 on the host:
    planar (C, B, n), output j the window ending at ext sample j (zeros
    before ext).  Kernel E (on the CPU its plain version) when the template
    fits it, R <= `MAX_TAPS`; the torch FFT convolution
    (`fft_matched_filter`) for a longer one."""
    if kern.shape[-1] <= MAX_TAPS:
        return matched_filter_ols(ext, kern, ext.shape[-1])
    return fft_matched_filter(ext, kern)


def sharded_zc_detect(
    x: torch.Tensor,
    mesh: StreamMesh,
    *,
    reference,
    corr_window: int = 2048,
    threshold_value: int | None = None,
    threshold_frac_bits: int = 15,
    min_corr_mag: float = 0.3,
    hysteresis: int = 256,
    max_events: int = 16,
    tie: str = "first",
    emit_unclosed: bool = True,
) -> GateEvents:
    """ZC detection from IQ of a stream cut over ``seq`` through the
    per-sample merge (`shard.py:sharded_zc_detect` :1611, channel-leading).

    x: this rank's block (2*branches, B_loc, block) float32, rows [b0_i,
    b0_q, b1_i, ...]; ``reference`` the complex template (R,).  Per shard,
    over the H = W + R - 1 samples before it (JAX's halo) and its own: the
    matched filter (`zc_matched_filter`: kernel E on the card), then kernel
    D's primed IQ mode on the shard's mf and IQ, with the halo's mf and IQ
    as its history (each branch normalized by its R-window energy and
    ||ref||, the branch sum's magnitude, the CFAR gate input), then
    `cross_shard_event_merge`.  Only the last W magnitudes of the halo
    reach a decision of the shard, and each needs R - 1 IQ samples before
    it, so a halo of H primes the shard exactly; the first R - 1 mf
    outputs of the halo see zeros before it and feed no decision (D's gate
    carry, which would need h more, is not used).  JAX's 'mxu' / 'xla' /
    'auto' choice of matched filter is made here from the template's
    length.  Events cover the correlation outputs k in [0, L): the 'full'
    convolution's tail past the stream is dropped (`sharded_zc_iq_detect`
    covers all L + R - 1 and merges tables).  Returns `GateEvents` (B_loc,
    E), the same on every rank of the seq group, equal to `zc_cfar_detect`
    on the one-shot normalized magnitudes truncated to L."""
    if x.dim() != 3 or x.shape[0] % 2 or x.dtype != torch.float32:
        raise ValueError(f"expected float32 (2*branches, B_loc, block), got {tuple(x.shape)} "
                         f"{x.dtype}")
    ref = torch.as_tensor(np.asarray(reference)).to(torch.complex64)
    R, W, h = ref.shape[-1], corr_window, max(int(hysteresis), 1)
    H = W + R - 1
    block, start = x.shape[-1], mesh.seq * x.shape[-1]
    halo = _left_halo(x, H, mesh)
    mf = zc_matched_filter(torch.cat([halo, x], dim=-1), ref.flip(-1).conj())
    o = zc_metric(mf[..., H:].contiguous(), x.contiguous(), ref_len=R,
                  ref_norm=float(torch.sqrt((ref.abs() ** 2).sum())), corr_window=W,
                  threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits,
                  min_corr_mag=min_corr_mag, base_index=start, hist_init=(mf[..., :H], halo),
                  hysteresis=h)
    return cross_shard_event_merge(
        o.above, o.mag, start, mesh, h=h, E=max_events, n=mesh.n_seq * block,
        tie_last=tie == "last", emit_unclosed=emit_unclosed)[0]


# ---------------------------------------------------------------------------
# Sharded frame re-emission
# ---------------------------------------------------------------------------

def _extract_local_frames(blk: torch.Tensor, table: GateEvents, *, shard_start: int,
                          stream_len: int, frame_len: int, timing_offset: int,
                          max_frames: int):
    """One shard's share of every frame window (`shard.py:1765`): each
    window read from the block in place at its local offset, zero where a
    position lies outside the shard, so the shards' shares sum exactly.
    Returns (frames (B_loc, max_frames, C, F) float32, global starts
    (B_loc, max_frames) int32, valid)."""
    K = min(max_frames, table.peak_idx.shape[-1])
    slot = torch.arange(K, device=blk.device)
    valid = table.valid[:, :K] & (slot < table.count[:, None])
    starts = (table.peak_idx[:, :K].to(torch.int64) + timing_offset).clamp(
        0, max(stream_len - frame_len, 0))
    frames = gather_windows(blk.transpose(0, 1), starts - shard_start, valid, frame_len)
    return pad_slots(frames.to(torch.float32), starts, valid, max_frames)


def sharded_extract_frames(
    x: torch.Tensor,
    table: GateEvents,
    mesh: StreamMesh,
    *,
    frame_len: int,
    timing_offset: int = 0,
    max_frames: int = 4,
    stream_len: int | None = None,
):
    """Aligned frame re-emission from the sharded stream
    (`shard.py:sharded_extract_frames` :1816, with the semantics of
    `sharded_extract_frames_tm` :1880: float32 or int16 blocks, a global
    ``stream_len``).  x: this rank's block (C, B_loc, block); table: the
    merged table of its streams (global indices).  Windows [start, start +
    frame_len), start = peak + timing_offset clipped into the stream, may
    span seams: each shard adds the samples it holds and one all-reduce
    over ``seq`` assembles them.  Returns (frames (B_loc, max_frames, C,
    frame_len) float32, starts int32, valid), equal to
    `ops.extract.extract_frames_batched` on the whole stream."""
    block = x.shape[-1]
    L = mesh.n_seq * block if stream_len is None else int(stream_len)
    frames, starts, valid = _extract_local_frames(
        x, table, shard_start=mesh.seq * block, stream_len=L, frame_len=frame_len,
        timing_offset=timing_offset, max_frames=max_frames)
    return _all_reduce_seq(frames, mesh), starts, valid


def sharded_minn_rtl_receive(
    x: torch.Tensor,
    mesh: StreamMesh,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    frame_len: int,
    max_events: int = 8,
    timing_offset: int = 0,
    max_frames: int = 4,
    stream_len: int | None = None,
    overlap_halo: bool = False,
    rows: int | None = None,
):
    """The Minn-RTL receive chain on the sharded stream
    (`shard.py:sharded_minn_rtl_receive_tm` :1979): `sharded_minn_rtl_
    detect_fused`, then `sharded_extract_frames`, with no stream ever
    gathered on one rank.  Windows open at ``peak + timing_offset``; the
    single-card chain (`MinnRTLDetector.detect_fused_frames`) opens them at
    ``peak + params.timing_offset - 6 * quarter_len`` (the RTL peak sits at
    s0 + 6Q), so pass that value to match it.  Returns (table, frames,
    starts, valid)."""
    table = sharded_minn_rtl_detect_fused(
        x, mesh, quarter_len=quarter_len, smooth_shift=smooth_shift,
        threshold_value=threshold_value, threshold_frac_bits=threshold_frac_bits,
        hysteresis=hysteresis, max_events=max_events, stream_len=stream_len,
        overlap_halo=overlap_halo, rows=rows)
    frames, starts, valid = sharded_extract_frames(
        x, table, mesh, frame_len=frame_len, timing_offset=timing_offset,
        max_frames=max_frames, stream_len=stream_len)
    return table, frames, starts, valid
