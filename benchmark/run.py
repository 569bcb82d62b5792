"""Run one cell of BENCHMARK.json once on the card and print its result.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The run makes its inputs on the card from the seed, warms up every shape
the window uses (set-up, reported as ``setup_s`` from process start),
measures one window of ``--seconds``, reads the card's peak memory,
judges what the window produced against the plain reference under
``benchmark/reference/``, and prints the numbers compared beside their
limits on standard error and, last, one JSON line on standard output.
``--trace 1`` profiles the first 10 s of the window with torch.profiler
and reports the per-layer metrics, the device's busy time and a breakdown
instead of the end-to-end metrics.

It exits non-zero and prints no result without a card, with fewer cards
than the cell asks for, or where JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from benchmark import harness as H  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def run_cell(cell: H.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, parts: dict | None = None) -> dict:
    """One run of ``cell``: set-up, window, judgement, metrics.  Returns
    {line, checks, info, window, setup_s}.  ``parts`` collects the set-up's
    parts (s) as they end: imports and CUDA context before the call, then
    the entry (the program's modules and library), the inputs and the
    warm-up."""
    parts = {} if parts is None else parts
    span = H.Spans(trace)
    t = time.perf_counter()
    entry = cell.module("entry").Entry(cell.config, cell.traffic, device)
    parts["entry"], t = time.perf_counter() - t, time.perf_counter()
    data = H.make_inputs(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["inputs"], t = time.perf_counter() - t, time.perf_counter()
    H.warm_up(cell, entry, data, span, parts)
    parts["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log(f"run {cell.name}: seed {seed}, set-up {setup_s:.3f} s, parts "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    span.start(seconds, device)
    win = H.window(cell, entry, data, seconds, seed, span)
    span.stop(win["calls"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    parsed = None
    if span.done is not None:
        from benchmark import trace as T

        parsed = T.parse(span.done, entry.stages, span_names=H.SPAN_NAMES)
        span.done = None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    record = H.record_for_judge(cell, entry, data, win)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = cell.module("reference")
    t_judge = time.perf_counter()
    verdict = ref.judge(cell.config, record, want_work=trace)
    verdict.setdefault("info", {})["judge_s"] = time.perf_counter() - t_judge
    verdict["info"]["setup_parts_s"] = parts
    checks = verdict["checks"]
    if cell.loop == "open":
        checks["unserved_blocks"] = (win["unserved"], 0)
    run = H.Run(window=win, setup_s=setup_s, trace=parsed, loop=cell.loop, stage_bound_s={})
    if trace:
        run.stage_bound_s = H.stage_bounds(cell, entry, data, span.calls, verdict["gated"])
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if parsed is not None:
        dev.update(busy_s=parsed["busy_s"], window_s=parsed["window_s"])
        breakdown = {"device_ops": parsed["device_ops"], "idle_gaps": parsed["idle_gaps"]}
    line = H.result_line(correct=H.passed(checks), attempted=win["attempted"],
                         failed=verdict["failed"] + win.get("unserved", 0), metrics=metrics,
                         device=dev, checks=checks, breakdown=breakdown)
    return {"line": line, "checks": checks, "info": verdict.get("info", {}), "window": win,
            "setup_s": setup_s, "trace": parsed, "run": run, "record": record}


def describe(res: dict) -> None:
    """What a reader of standard error needs beyond the result line."""
    win = res["window"]
    log(f"window {win['window_s']:.3f} s, {win['completed']} of {win['attempted']} done")
    if "late_us" in win:
        late = win["late_us"]
        log(f"generator lateness: p50 {H.quantile(late, 0.5):.1f} us, p95 "
            f"{H.quantile(late, 0.95):.1f} us, max {max(late):.1f} us over {len(late)} blocks")
    if res["trace"] is not None:
        t = res["trace"]
        log(f"trace: {t['device_events']} device events, {t['matched']} matched to a stage "
            f"launch, {t['launches']} launches; stage device s {t['stage_device_s']}, "
            f"events {t['stage_events']}; bounds {res['run'].stage_bound_s}")
    log(f"info: {json.dumps(res['info'])}")
    for line in H.check_lines(res["checks"]):
        log(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = H.Cell(H.load_spec(), args.workload)
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"run: needs {need} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}; "
            "no result without the card")
        return 3
    parts = {"imports": time.perf_counter() - T_START}
    t = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    parts["cuda_context"] = time.perf_counter() - t
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, parts=parts)
    bad = H.forbidden_modules(sys.modules)
    if bad:
        log(f"run: JAX or the JAX package was loaded in this process: {bad}; no result")
        return 4
    card = card_line()
    log(f"run: {card}, torch {torch.__version__}, cuda {torch.version.cuda}")
    describe(res)
    line = res["line"]
    line["device"]["nvidia_smi"] = card
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
