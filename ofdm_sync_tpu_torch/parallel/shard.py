"""The sharded receive chain on `torch.distributed` (port of
`ofdm_sync_tpu.parallel.shard`).

Two parallel axes, as in the JAX package: ``data`` (independent streams,
no communication) and ``seq`` (the time axis of each stream, cut into
equal blocks).  PyTorch has no ``shard_map``, so the port is SPMD: every
rank calls the same function with its own block, channel-leading ``(C,
B_loc, block)``, and gets back the merged table of its ``B_loc`` streams,
the same on every rank of its ``seq`` group (JAX's ``out_specs=P("data")``).
`StreamMesh` maps rank r to ``data = r // n_seq``, ``seq = r % n_seq``.

The collectives, each within the rank's ``seq`` group:

* halo exchange (JAX ``ppermute`` to the right neighbour): point-to-point
  sends and receives (`dist.batch_isend_irecv`); ``seq`` 0 gets zeros;
  int16 stays int16 on the wire;
* event-table merge (JAX ``all_gather`` of one packed int32 buffer): one
  all-gather; the float32 fields ride bit for bit as int32;
* frame assembly (JAX ``psum``): one all-reduce; every window sample is
  held by exactly one shard and the others add zeros, so the sum is exact.

Host staging: gloo takes no CUDA tensor in point-to-point operations or
all-gathers.  Where a group's backend is gloo (ranks sharing one card) and
a tensor lies on the card, `_wire` copies it to host memory for the
collective and the result goes back to the card; this is the only place
the port moves data through the host for a collective.  The kernels run
on the card either way.  NCCL (a card per rank) takes the card's tensors
directly.

Each per-shard detector runs its single-card kernels in their carried
(shard) mode with global indices, primed from the left neighbour's halo, so
a shard needs nothing else of its neighbours; the per-shard tables then
merge with the seam rule of `merge_stacked_event_tables`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ofdm_sync_tpu_torch.kernels.aa_fused import aa_detect_fused
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import (
    _check_input,
    _planar_view,
    metric_halo,
    minn_rtl_detect_fused,
)
from ofdm_sync_tpu_torch.kernels.streaming import aa_metric_planar, minn_rtl_metric_planar
from ofdm_sync_tpu_torch.kernels.streaming_chunked import _gate_init
from ofdm_sync_tpu_torch.kernels.zc_fused import zc_iq_cfar_detect, zc_tm_halo_rows
from ofdm_sync_tpu_torch.ops.detect import GateEvents
from ofdm_sync_tpu_torch.ops.extract import gather_windows, pad_slots


class StreamMesh(NamedTuple):
    """The (data, seq) mesh as seen by one rank: its coordinates and the
    process groups of its ``seq`` row and ``data`` column."""

    n_data: int
    n_seq: int
    data: int
    seq: int
    seq_group: object
    data_group: object

    def seq_rank(self, s: int) -> int:
        """Global rank of position ``s`` of this rank's ``seq`` group."""
        return dist.get_global_rank(self.seq_group, s)


def make_stream_mesh(n_data: int = 1, n_seq: int | None = None) -> StreamMesh:
    """(data, seq) mesh over the default process group, ``seq`` minor:
    rank r sits at ``data = r // n_seq``, ``seq = r % n_seq`` (default
    ``n_seq`` = world // n_data).  Creates one group per ``seq`` row and
    per ``data`` column, so every rank must call it, in the same order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_seq is None:
        n_seq = world // n_data
    if n_data * n_seq != world:
        raise ValueError(f"{n_data}x{n_seq} != {world} ranks")
    rows = [dist.new_group([d * n_seq + s for s in range(n_seq)]) for d in range(n_data)]
    cols = [dist.new_group([d * n_seq + s for d in range(n_data)]) for s in range(n_seq)]
    d, s = divmod(rank, n_seq)
    return StreamMesh(n_data, n_seq, d, s, rows[d], cols[s])


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


def _all_reduce_seq(t: torch.Tensor, mesh: StreamMesh) -> torch.Tensor:
    """The sum of every rank's t over the seq group, on t's device (a
    contiguous t not staged through the host holds it too)."""
    buf = _wire(t, mesh.seq_group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.seq_group)
    return buf.to(t.device)


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
# Sharded detectors
# ---------------------------------------------------------------------------

def _gate_from_tail(above_tail: torch.Tensor, first_index: int, h: int) -> torch.Tensor:
    """Kernel B's gate_init at ``first_index`` from the above bits of the h
    samples before it (`shard.py:_gate_init_from_tail`): the last above
    index la, as the gate carry [la, 1] of `streaming_chunked._gate_init`
    ([-1, 0] where none)."""
    gi = first_index - h + torch.arange(h, device=above_tail.device)
    la = torch.where(above_tail, gi, -1).amax(dim=-1).to(torch.int32)
    return _gate_init(torch.stack([la, torch.zeros_like(la)], dim=-1), first_index, h)


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
    halo = post_halos((x,), W, 0, mesh).wait()[0][0].to(torch.float32)
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
