"""Readings that set the benchmark's limits and its live load; run on the
card, never by a benchmark run.

    python -m benchmark.calibrate seeds --workload W --seeds 1,2,3 --seconds 2 [--control 3]
    python -m benchmark.calibrate knee --streams 1,2,4,...,1024 --seconds 3

``seeds`` runs the cell as a benchmark run does, at its own size, once per
seed in one process, and prints each number compared (the lower
readings); for the first ``--control`` seeds it also puts the reference in
bfloat16 in the program's place and prints the same numbers (the upper
readings).  For a Minn-RTL cell it also counts, on the first input, where
kernel A's above bit differs from the reference's, and how many of those
lie outside the ``KNIFE`` margin.  ``knee`` runs the live cell's open loop at each
stream count and prints whether its backlog grows.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import harness as H
from benchmark import run as R


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def knife(cell: H.Cell, record: dict) -> dict | None:
    """Kernel A's above bits beside the reference's on 64 streams of the
    first input: how many differ, and how many of those lie outside the
    reference's ambiguous samples (``KNIFE``)."""
    if cell.config["preamble"]["kind"] != "minn_rtl" or "inputs" not in record:
        return None
    from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F

    from benchmark.reference import minn_rtl_fpga as M

    det = cell.config["detector"]
    x = record["inputs"][0][:, :64]
    _, above = F.minn_rtl_metric(x, **{k: det[k] for k in (
        "quarter_len", "smooth_shift", "threshold_value", "threshold_frac_bits")})
    _, ref, amb, _ = M.metric(x, det)
    diff = above != ref
    return {"differ": int(diff.sum()), "off_knife": int((diff & ~amb).sum())}


def seeds(args) -> None:
    cell = H.Cell(H.load_spec(), args.workload)
    dev = torch.device("cuda", 0)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = R.run_cell(cell, seed, args.seconds, False, dev, t0)
        out = {"workload": cell.name, "seed": seed, "program": {k: v[0] for k, v in
                                                                 res["checks"].items()},
               "info": res["info"], "metrics": res["line"]["metrics"],
               "knife": knife(cell, res["record"])}
        if n < args.control:
            v = cell.module("reference").judge(cell.config, res["record"], control=True)
            out["control"] = {k: val[0] for k, val in v["checks"].items()}
        out["seconds"] = time.perf_counter() - t0
        _emit(out)
        del res
        gc.collect()
        torch.cuda.empty_cache()


def knee(args) -> None:
    cell = H.Cell(H.load_spec(), "minn_rtl_fpga.live")
    dev = torch.device("cuda", 0)
    rate = cell.config["system"]["sample_rate_hz"]
    block = cell.traffic["block"]
    period_us = block / rate * 1e6
    entry = cell.module("entry").Entry(cell.config, cell.traffic, dev)
    for S in (int(s) for s in args.streams.split(",")):
        cell.traffic["streams"] = S
        data = H.make_inputs(cell, 1000 + S, dev)
        H.warm_up(cell, entry, data, H.Spans(False))
        win = H.open_loop(entry, data["ring"], block, rate, args.seconds, H.Spans(False), None)
        lat = win["latency_us"]
        q = max(1, len(lat) // 4)
        first, last = H.quantile(lat[:q], 0.5), H.quantile(lat[-q:], 0.5)
        _emit({"streams": S, "blocks": len(lat), "unserved": win["unserved"],
               "p50_us": H.quantile(lat, 0.5), "p95_us": H.quantile(lat, 0.95),
               "first_quarter_p50_us": first, "last_quarter_p50_us": last,
               "late_p95_us": H.quantile(win["late_us"], 0.95),
               "enqueue_p50_us": H.quantile(win["enqueue_us"], 0.5),
               "growing": bool(win["unserved"] or last > first + period_us)})
        del data
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("seeds")
    a.add_argument("--workload", required=True)
    a.add_argument("--seeds", required=True)
    a.add_argument("--seconds", type=float, default=2.0)
    a.add_argument("--control", type=int, default=3)
    b = sub.add_parser("knee")
    b.add_argument("--streams", default="1,2,4,8,16,32,64,128,256,512,1024")
    b.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs the card", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    (seeds if args.cmd == "seeds" else knee)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
