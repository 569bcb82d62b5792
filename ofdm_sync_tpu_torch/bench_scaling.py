"""Scaling of the sharded Minn-RTL detect: the counterpart of the JAX
package's `bench_scaling.py`.

    python -m ofdm_sync_tpu_torch.bench_scaling [--seed N] [--out PATH]

It needs the card and prints one JSON line (``--out`` writes it to a file
too).  Four parts, as the JAX script's:

(a) card: `sharded_minn_rtl_detect_fused` at mesh (1, 1) over NCCL against
    the one-shot kernels A + B at the bench's headline (512 x 262,144 x 2,
    float32): the tables' equality and the overhead ratio sharded / one-shot,
    for the default schedule (one primed call) and the overlap split;
(b) ranks: RANKS = 8 gloo ranks on the CPU (`parallel.distributed.run_ranks`)
    run the sharded detect on meshes (n, 1), (2, n / 2) and (1, n) at
    Q = 32, float32 and int16, with a preamble across a seam; every rank's
    merged table must equal the one-shot table.  Each rank counts the
    collectives of one sharded call (`torch.distributed.batch_isend_irecv`,
    `all_gather` and `all_reduce`, wrapped inside the rank, with their
    bytes) twice: the counts must repeat and equal those the code implies
    (`expected_collectives`).  int16 input travels as int16 on the wire
    (`shard._wire`) and gives the same tables bit for bit;
(c) projection: weak-data, weak-seq and strong-seq efficiency at 8 cards
    over NVLink and at 2 hosts over InfiniBand, for float32 and int16 halos
    and for both schedules, from (a)'s one-shot rate and overhead ratios,
    (b)'s collective counts, and public H100 interconnect figures stated in
    the output as assumptions;
(d) structure: with the overlap split, in the rank that receives a halo,
    the interior call (kernel A, then B) is issued before
    `PendingHalos.wait()` and reads no received tensor; only the call after
    the wait reads the halo.  The order of calls, waits and kernel A
    launches is recorded (two gloo ranks sharing the card).

Nothing across cards is measured: the machine the bench was written for
has one card, so the line says so in ``cross_card``.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from ofdm_sync_tpu_torch import bench
from ofdm_sync_tpu_torch.kernels import build
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F
from ofdm_sync_tpu_torch.parallel import distributed as DI
from ofdm_sync_tpu_torch.parallel import shard as SH
from ofdm_sync_tpu_torch.testing import assert_tables_equal, minn_stimulus, table_arrays

C = 4  # 2 RX branches x (I, Q) planar rows
#: part (b): the JAX script's 8-device CPU mesh and its small-Q configuration
RANKS, RANK_Q, RANK_BATCH, RANK_L = 8, 32, 16, 4096
COLLECTIVES = ("batch_isend_irecv", "all_gather", "all_reduce")
#: public H100 interconnect figures (bytes/s per direction per card) and
#: the latency assumed for one collective on each
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, 18 links x 25 GB/s per direction
IB_BYTES_PER_S = 400e9 / 8   # one 400 Gb/s NDR InfiniBand port per card
NVLINK_LATENCY_S = 10e-6
IB_LATENCY_S = 25e-6


def _kw(quarter_len: int) -> dict:
    return dict(bench.DETECT, quarter_len=quarter_len)


# ---------------------------------------------------------------------------
# (a) the card
# ---------------------------------------------------------------------------

def part_card(dev, seed: int) -> dict:
    """The sharded detect at mesh (1, 1) against the one-shot A + B at the
    headline; both schedules; tables equal, each timed as the bench times."""
    B, L = bench.HEADLINE["batch"], bench.HEADLINE["L"]
    x, _ = minn_stimulus(B, L, bench.Q, dev, seed=seed)
    det = bench.DETECT
    one = F.minn_rtl_detect_fused(x, **det)
    res = {"batch": B, "L": L, "one_shot": bench.timed(lambda: F.minn_rtl_detect_fused(x, **det),
                                                       units=B * L)}
    with bench.mesh11(dev) as mesh:
        for name, overlap in (("sharded", False), ("sharded_overlap", True)):
            run = lambda: SH.sharded_minn_rtl_detect_fused(  # noqa: E731
                x, mesh, **det, overlap_halo=overlap)
            assert_tables_equal(one, run(), f"mesh (1, 1) {name}")
            res[name] = bench.timed(run, units=B * L)
    res["tables_equal"] = True
    res["one_shot_samples_per_sec"] = res["one_shot"]["per_s"]
    for name in ("sharded", "sharded_overlap"):
        res[f"{name}_overhead_ratio"] = res[name]["median_ms"] / res["one_shot"]["median_ms"]
    del x
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# (b) ranks on the CPU
# ---------------------------------------------------------------------------

def rank_stimulus(seed: int, batch: int = RANK_BATCH, L: int = RANK_L, q: int = RANK_Q):
    """(4, batch, L) integer-valued float32 noise round(8 N(0,1)) with 5q
    preambles [-A, A, A, -A, -A] (NumPy, seeded): one across the middle
    seam (L / 2, a seam of every mesh with an even seq count) in stream 0,
    one across L / 4 in stream 3, one before 3L / 4 in the last stream.
    Returns (x, events)."""
    rng = np.random.default_rng(seed)
    x = np.round(8.0 * rng.standard_normal((C, batch, L))).astype(np.float32)
    A = rng.standard_normal(q) + 1j * rng.standard_normal(q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    planes = (3.0 * np.round(24.0 * pre.real), 3.0 * np.round(24.0 * pre.imag))
    events = [(0, L // 2 - 2 * q), (3, L // 4 - 3 * q), (batch - 1, 3 * L // 4 - 6 * q)]
    for b, pos in events:
        for c in range(C):
            x[c, b, pos: pos + 5 * q] += planes[c % 2]
    return x, events


def block_of(a: np.ndarray, mesh) -> torch.Tensor:
    """The rank's (C, B_loc, block) share of a (C, batch, n) array."""
    bb, bl = a.shape[1] // mesh.n_data, a.shape[2] // mesh.n_seq
    return torch.from_numpy(np.ascontiguousarray(
        a[:, mesh.data * bb: (mesh.data + 1) * bb, mesh.seq * bl: (mesh.seq + 1) * bl]))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def record_collectives():
    """Wrap `torch.distributed.batch_isend_irecv`, `all_gather` and
    `all_reduce` for the enclosed code; yields the dict of counts it fills:
    per collective the calls and the bytes this rank sends (and, for the
    point-to-point batch, receives)."""
    counts = {name: {"calls": 0, "bytes": 0} for name in COLLECTIVES}
    counts["batch_isend_irecv"]["recv_bytes"] = 0
    real = {name: getattr(dist, name) for name in COLLECTIVES}

    def p2p(ops):
        c = counts["batch_isend_irecv"]
        c["calls"] += 1
        c["bytes"] += sum(_nbytes(op.tensor) for op in ops if op.op is dist.isend)
        c["recv_bytes"] += sum(_nbytes(op.tensor) for op in ops if op.op is dist.irecv)
        return real["batch_isend_irecv"](ops)

    def gather(out, src, *a, **k):
        counts["all_gather"]["calls"] += 1
        counts["all_gather"]["bytes"] += _nbytes(src)
        return real["all_gather"](out, src, *a, **k)

    def reduce(t, *a, **k):
        counts["all_reduce"]["calls"] += 1
        counts["all_reduce"]["bytes"] += _nbytes(t)
        return real["all_reduce"](t, *a, **k)

    with mock.patch.multiple(dist, batch_isend_irecv=p2p, all_gather=gather, all_reduce=reduce):
        yield counts


def expected_collectives(n_seq: int, seq: int, b_loc: int, halo: int, itemsize: int,
                         max_events: int) -> dict:
    """The collectives one call of `sharded_minn_rtl_detect_fused` (one
    primed call) makes on the rank at ``seq``, as its code reads: one
    batch of halo sends and receives where the seq row has more than one
    shard (the C x B_loc x halo trailing samples to the right neighbour,
    from the left one, in the input's dtype), one all-gather of the packed
    table (B_loc x ((4 + 1) E + 2) int32, over a group of one too), no
    all-reduce."""
    halo_bytes = C * b_loc * halo * itemsize
    return {
        "batch_isend_irecv": {"calls": int(n_seq > 1),
                              "bytes": halo_bytes if seq < n_seq - 1 else 0,
                              "recv_bytes": halo_bytes if seq > 0 else 0},
        "all_gather": {"calls": 1, "bytes": b_loc * (5 * max_events + 2) * 4},
        "all_reduce": {"calls": 0, "bytes": 0},
    }


def ranks_rank(rank: int, seed: int, kw: dict, meshes) -> dict:
    """Part (b) in one rank: on each mesh, float32 and int16, the sharded
    detect twice on `rank_stimulus(seed)`, each under `record_collectives`;
    returns the rank's coordinates, table and the two counts per case.
    (Each rank draws the stimulus itself: a spawned rank starts only once
    it has read its arguments, so a large argument starts the ranks one
    after another.)"""
    torch.set_num_threads(1)
    x = rank_stimulus(seed)[0]
    out = {}
    for nd, ns in meshes:
        mesh = SH.make_stream_mesh(nd, ns)
        for dtype, a in (("f32", x), ("int16", x.astype(np.int16))):
            blk = block_of(a, mesh)
            counts = []
            for _ in range(2):
                with record_collectives() as c:
                    t = SH.sharded_minn_rtl_detect_fused(blk, mesh, **kw)
                counts.append(c)
            out[nd, ns, dtype] = {"data": mesh.data, "seq": mesh.seq, "b_loc": blk.shape[1],
                                  "table": table_arrays(t), "counts": counts}
    return out


def _table_rows(table, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in table_arrays(table).items()}


def _rows_equal(a: dict, b: dict) -> bool:
    """Every field equal, bit for bit (empty slots hold equal infinities)."""
    return all(np.array_equal(a[k], b[k]) for k in a)


def part_ranks(n_ranks: int, seed: int) -> dict:
    """Part (b): ``n_ranks`` gloo ranks on the CPU, meshes (n, 1), (2, n / 2)
    and (1, n); per mesh: every rank's table equal to the one-shot table
    (float32, and int16 over the int16 wire), the collectives of one call
    repeated exactly and equal to `expected_collectives`, the counts of
    the rank with most traffic, the halo bytes per shard."""
    x, events = rank_stimulus(seed)
    q = RANK_Q
    kw = _kw(q)
    W = SH.minn_halo_width(q, kw["smooth_shift"], kw["hysteresis"])
    meshes = ((n_ranks, 1), (2, n_ranks // 2), (1, n_ranks))
    one = {"f32": F.minn_rtl_detect_fused(torch.from_numpy(x), **kw),
           "int16": F.minn_rtl_detect_fused(torch.from_numpy(x.astype(np.int16)), **kw)}
    out = {"ranks": n_ranks, "batch": RANK_BATCH, "L": RANK_L, "quarter_len": q,
           "halo_width_samples": W, "events_planted": len(events),
           "events_one_shot": int(one["f32"].count.sum()),
           "int16_equals_f32_one_shot": _rows_equal(_table_rows(one["f32"], 0, RANK_BATCH),
                                                   _table_rows(one["int16"], 0, RANK_BATCH)),
           "meshes": {}}
    ranks = DI.run_ranks(ranks_rank, n_ranks, (seed, kw, meshes), backend="gloo", timeout_s=600)
    for nd, ns in meshes:
        for dtype in ("f32", "int16"):
            equal, repeat, as_coded, busiest = True, True, True, None
            for r in ranks:
                got = r[nd, ns, dtype]
                lo = got["data"] * got["b_loc"]
                equal &= _rows_equal(got["table"], _table_rows(one[dtype], lo, lo + got["b_loc"]))
                c0, c1 = got["counts"]
                repeat &= c0 == c1
                want = expected_collectives(ns, got["seq"], got["b_loc"], W,
                                            2 if dtype == "int16" else 4, kw["max_events"])
                as_coded &= c0 == want
                if busiest is None or (c0["batch_isend_irecv"]["recv_bytes"]
                                       > busiest["batch_isend_irecv"]["recv_bytes"]):
                    busiest = c0
            out["meshes"][f"data{nd}xseq{ns}_{dtype}"] = {
                "tables_equal_one_shot": bool(equal), "counts_repeat": bool(repeat),
                "counts_as_coded": bool(as_coded), "collectives_per_call": busiest,
                "halo_bytes_per_shard": busiest["batch_isend_irecv"]["recv_bytes"]}
    out["int16_wire_bit_identical"] = all(
        v["tables_equal_one_shot"] for k, v in out["meshes"].items() if k.endswith("int16")
    ) and out["int16_equals_f32_one_shot"]
    out["holds"] = all(v["tables_equal_one_shot"] and v["counts_repeat"] and v["counts_as_coded"]
                       for v in out["meshes"].values()) and out["int16_wire_bit_identical"]
    return out


# ---------------------------------------------------------------------------
# (d) the overlap split's order
# ---------------------------------------------------------------------------

def structure_rank(rank: int, device: str, seed: int, kw: dict, rows: int) -> dict:
    """Part (d) in one rank of mesh (1, 2): the sharded detect with the
    overlap split, every detect call, `PendingHalos.wait()` and kernel A
    launch recorded in order, and whether each call's inputs share storage
    with a tensor received from the neighbour (the posted receive buffers
    and what `wait` returns)."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    mesh = SH.make_stream_mesh(1, 2)
    blk = block_of(rank_stimulus(seed)[0], mesh).to(dev)
    log, received = [], set()
    real_post, real_wait, real_detect = SH.post_halos, SH.PendingHalos.wait, SH.minn_rtl_detect_fused

    def storages(ts):
        return {t.untyped_storage().data_ptr() for t in ts if isinstance(t, torch.Tensor)}

    def post(blocks, *a, **k):
        pending = real_post(blocks, *a, **k)
        received.update(storages(t for pair in pending._recvs for t in pair))
        return pending

    def wait(self):
        log.append({"event": "wait", "kernel_a_launches": F.minn_rtl_metric.launches})
        got = real_wait(self)
        received.update(storages(t for pair in got for t in pair))
        return got

    def detect(xs, **k):
        entry = {"event": "detect", "base_index": k.get("base_index"), "samples": xs.shape[-1],
                 "reads_received": bool(storages((xs, *(k.get("shard_init") or ()))) & received)}
        log.append(entry)
        out = real_detect(xs, **k)
        entry["kernel_a_launches"] = F.minn_rtl_metric.launches
        return out

    with mock.patch.object(SH, "post_halos", post), \
            mock.patch.object(SH.PendingHalos, "wait", wait), \
            mock.patch.object(SH, "minn_rtl_detect_fused", detect):
        t = SH.sharded_minn_rtl_detect_fused(blk, mesh, **kw, overlap_halo=True, rows=rows)
    return {"seq": mesh.seq, "start": mesh.seq * blk.shape[-1], "log": log,
            "table": table_arrays(t)}


def part_structure(device: str, seed: int, rows: int = 1024) -> dict:
    """Part (d) on two gloo ranks (on ``device``): in the rank that
    receives a halo, the first call is the interior's (base = start + rows),
    issued before the wait and reading nothing received; the call after
    the wait reads the halo.  On a card, kernel A has launched before the
    wait."""
    kw = _kw(RANK_Q)
    ranks = DI.run_ranks(structure_rank, 2, (device, seed, kw, rows), backend="gloo",
                         timeout_s=600)
    r = ranks[1]
    log, start = r["log"], r["start"]
    kinds = [e["event"] for e in log]
    first = log[0]
    on_card = device.startswith("cuda")
    holds = (kinds == ["detect", "wait", "detect"]
             and first["base_index"] == start + rows and not first["reads_received"]
             and log[2]["base_index"] == start and log[2]["reads_received"]
             and (not on_card or log[1]["kernel_a_launches"] >= 1))
    return {"device": device, "rank": 1, "rows": rows, "order": log,
            "interior_issued_before_wait": kinds[:2] == ["detect", "wait"],
            "interior_reads_received": first["reads_received"],
            "kernel_a_launched_before_wait": (log[1]["kernel_a_launches"] >= 1 if on_card
                                              else "not measured: ranks on the CPU run the "
                                                   "plain version, which launches nothing"),
            "holds": bool(holds)}


# ---------------------------------------------------------------------------
# (c) projection
# ---------------------------------------------------------------------------

def projection(rate: float, ratio_serial: float, ratio_overlap: float, rounds: int, *,
               batch: int = bench.HEADLINE["batch"], L: int = bench.HEADLINE["L"],
               halo: int | None = None, rows: int = 2048, max_events: int = 8) -> dict:
    """Projected efficiency (one card's time / the time on n cards, each
    with its share) of the sharded detect, from a measured one-card rate
    (samples/s), the measured mesh (1, 1) overhead ratio of each schedule,
    the collective rounds of one call, and the interconnect assumptions.

    * weak data: more streams per added card; no collective crosses cards
      (the table all-gather runs over a group of one): 1.
    * weak seq: each card keeps the headline's L samples a stream; the halo
      and the table gather are fixed per call.
    * strong seq: one L-sample stream split over the cards.

    Per call, t_comp = batch * L / rate (strong: / n), halo = C x batch x W
    samples of the input's dtype, gather = batch x ((4 + 1) E + 2) x 4
    bytes.  Serialized (one primed call, the default): t = t_comp x ratio
    + (halo + gather) / bw + rounds x latency.  Overlap split: the interior
    (all but the first ``rows`` samples) runs while the halo travels:
    t = max(t_int, t_halo) + t_first + t_gather, t_int = t_comp x ratio x
    (L' - rows) / L', t_first = t_comp x ratio x rows / L' (L' the card's
    samples a stream), t_halo = halo / bw + latency, t_gather = gather / bw
    + latency; capped at 1."""
    W = SH.minn_halo_width(bench.Q, 3, bench.HYST) if halo is None else halo
    t_comp = batch * L / rate
    gather = batch * (5 * max_events + 2) * 4

    def eff(n, bw, lat, itemsize, overlap):
        tc = t_comp / n if n > 1 else t_comp
        halo_b = C * batch * W * itemsize
        if not overlap:
            return tc / (tc * ratio_serial + (halo_b + gather) / bw + rounds * lat)
        frac = rows / (L / n if n > 1 else L)
        t = (max(tc * ratio_overlap * (1 - frac), halo_b / bw + lat)
             + tc * ratio_overlap * frac + gather / bw + lat)
        return min(tc / t, 1.0)

    def block(itemsize, overlap):
        return {
            "weak_seq_8card_nvlink": eff(1, NVLINK_BYTES_PER_S, NVLINK_LATENCY_S, itemsize,
                                         overlap),
            "weak_seq_2host_ib": eff(1, IB_BYTES_PER_S, IB_LATENCY_S, itemsize, overlap),
            "strong_seq_8card_nvlink": eff(8, NVLINK_BYTES_PER_S, NVLINK_LATENCY_S, itemsize,
                                           overlap),
            "strong_seq_2host_ib": eff(2, IB_BYTES_PER_S, IB_LATENCY_S, itemsize, overlap),
        }

    return {
        "assumptions": {
            "single_card_samples_per_sec": rate,
            "overhead_ratio_serialized": ratio_serial,
            "overhead_ratio_overlap": ratio_overlap,
            "collective_rounds_per_call": rounds,
            "nvlink_bytes_per_s": NVLINK_BYTES_PER_S,
            "nvlink": "NVLink 4, 450 GB/s per direction per H100 (18 links x 25 GB/s)",
            "ib_bytes_per_s": IB_BYTES_PER_S,
            "ib": "one 400 Gb/s NDR InfiniBand port per H100 between hosts",
            "nvlink_collective_latency_s": NVLINK_LATENCY_S,
            "ib_collective_latency_s": IB_LATENCY_S,
            "latency_source": "assumed, not measured",
            "batch": batch, "L": L, "halo_width_samples": W, "rows": rows,
            "halo_bytes_f32": C * batch * W * 4, "halo_bytes_int16": C * batch * W * 2,
            "table_gather_bytes": gather,
        },
        "weak_data": {"efficiency_8card": 1.0, "efficiency_2host": 1.0},
        "halo_f32": block(4, False),
        "halo_int16": block(2, False),
        "halo_f32_overlap": block(4, True),
        "halo_int16_overlap": block(2, True),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ofdm_sync_tpu_torch.bench_scaling",
        description="scaling of the sharded detect (the JAX package's bench_scaling.py)")
    parser.add_argument("--seed", type=int, default=0, help="seed of every stimulus")
    parser.add_argument("--out", default=None, help="also write the result line to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        bench.log("bench_scaling: no CUDA device (torch.cuda.is_available() is False); part "
                  "(a) and the projection's rate need the card")
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.library()  # the ranks of part (d) load this build
    device = bench.device_info()
    seconds, t0 = {}, time.perf_counter()
    card = part_card(dev, args.seed)
    seconds["card"] = time.perf_counter() - t0
    bench.log(f"bench_scaling (a): one-shot {card['one_shot']['median_ms']:.4f} ms, sharded "
              f"{card['sharded']['median_ms']:.4f} ms ({card['sharded_overhead_ratio']:.3f}x), "
              f"overlap split {card['sharded_overlap']['median_ms']:.4f} ms "
              f"({card['sharded_overlap_overhead_ratio']:.3f}x); {device['nvidia_smi']}; "
              f"{seconds['card']:.1f} s")
    ranks = part_ranks(RANKS, args.seed)
    seconds["cpu_ranks"] = time.perf_counter() - t0 - seconds["card"]
    bench.log(f"bench_scaling (b): {RANKS} gloo ranks, holds {ranks['holds']}; "
              f"{seconds['cpu_ranks']:.1f} s")
    structure = part_structure("cuda", args.seed)
    seconds["structure"] = time.perf_counter() - t0 - seconds["card"] - seconds["cpu_ranks"]
    bench.log(f"bench_scaling (d): {structure['order']}, holds {structure['holds']}; "
              f"{seconds['structure']:.1f} s")
    per_call = ranks["meshes"][f"data1xseq{RANKS}_f32"]["collectives_per_call"]
    rounds = sum(per_call[name]["calls"] for name in COLLECTIVES)
    proj = projection(card["one_shot_samples_per_sec"], card["sharded_overhead_ratio"],
                      card["sharded_overlap_overhead_ratio"], rounds)
    line = {"metric": "scaling_efficiency", "device": device, "seed": args.seed, "card": card,
            "cpu_ranks": ranks, "projection": proj, "structure": structure,
            "cross_card": "not measured: the machine has one card, so no halo, all-gather or "
                          "all-reduce crossed NVLink or InfiniBand",
            "seconds": seconds,
            "ok": bool(card["tables_equal"] and ranks["holds"] and structure["holds"])}
    bench.emit(line, args.out)
    return 0 if line["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
