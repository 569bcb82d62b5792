"""The harness: find a cell's files by the names in BENCHMARK.json, make
its inputs, warm up, measure one window, judge what the window produced
against the plain reference, and build the result line.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own:

* ``configs/<config>.json``: the configuration as it is run; its
  ``entries`` name, for each loop kind, the file in ``entries/`` that drives
  the program;
* ``traffic/<mix>.json``: the mix's parameters; ``loop`` is ``closed``
  (a sweep: batch k + 1 enqueued before the host waits for batch k's
  table) or ``open`` (live blocks due on a fixed schedule);
* ``reference/<config>.py``: the plain reference and the comparison
  (``judge``, ``LIMITS``);
* ``metrics/<metric>.py``: a reader ``read(run)`` that returns the
  metric's value, or None where the run has nothing to read.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import stimulus

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ofdm_sync_tpu")
#: the harness's own spans (the entries add their stages')
SPAN_NAMES = ("window", "table_copy", "table_wait", "drain", "wait_due")
#: how much of a traced run's window the profiler records (s)
TRACE_S = 10.0
#: how long past the window's close an open loop still serves due blocks
GRACE_S = 60.0
TABLE_FIELDS = ("valid", "closed", "gate_start", "gate_close", "peak_idx", "peak_value",
                "count", "overflow")


def spec_path(root: Path | None = None) -> Path:
    return (root or HERE.parent) / "BENCHMARK.json"


def load_spec(root: Path | None = None) -> dict:
    return json.loads(spec_path(root).read_text())


def load_file(path: Path, name: str):
    """A module from a file path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with everything it names resolved."""

    def __init__(self, spec: dict, workload: str, root: Path | None = None):
        root = root or HERE.parent
        bench = root / "benchmark"
        ws = {w["name"]: w for w in spec["workloads"]}
        if workload not in ws:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(ws)})")
        self.workload = ws[workload]
        self.name = workload
        cfgs = {c["name"]: c for c in spec["configs"]}
        self.config = json.loads((root / cfgs[self.workload["config"]]["file"]).read_text())
        self.traffic = json.loads((bench / "traffic" / f"{self.workload['traffic']}.json")
                                  .read_text())
        self.loop = self.traffic["loop"]
        self.entry_path = bench / "entries" / f"{self.config['entries'][self.loop]}.py"
        self.reference_path = bench / "reference" / f"{self.workload['config']}.py"
        applies = lambda m: "workloads" not in m or workload in m["workloads"]  # noqa: E731
        self.end_to_end = [m for m in spec["end_to_end"] if applies(m)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m)]
        self.metric_paths = {m["name"]: bench / "metrics" / f"{m['name']}.py"
                             for m in self.end_to_end + self.per_layer}
        missing = [p for p in (self.entry_path, self.reference_path, *self.metric_paths.values())
                   if not p.exists()]
        if missing:
            raise FileNotFoundError(f"cell {workload}: missing {[str(p) for p in missing]}")

    def module(self, kind: str):
        """The entry (``entry``) or the reference (``reference``) module."""
        path = self.entry_path if kind == "entry" else self.reference_path
        return importlib.import_module(f"benchmark.{path.parent.name}.{path.stem}")

    def reader(self, metric: str):
        return load_file(self.metric_paths[metric], f"benchmark_metric_{metric.replace('.', '_')}")


class Spans:
    """The harness's spans.  In a traced run torch.profiler records the
    first `TRACE_S` seconds of the window (or all of it, if shorter) under
    the annotation ``window``, with a span around each stage's call; the
    rest of the window runs unprofiled, so the profiler's cost cannot pile
    a long backlog on the live loop and the trace stays a fixed size.  The
    loops call `tick` between calls; ``calls`` then holds how many calls of
    each input the traced part made."""

    def __init__(self, on: bool):
        self.on, self.prof, self.calls, self.done = on, None, None, None

    def __call__(self, name: str):
        return torch.profiler.record_function(name) if self.prof is not None \
            else contextlib.nullcontext()

    def start(self, seconds: float, device) -> None:
        if not self.on:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._window = torch.profiler.record_function("window")
        self._window.__enter__()
        self._stop_at = time.perf_counter() + min(seconds, TRACE_S)

    def tick(self, calls: dict) -> None:
        if self.prof is not None and time.perf_counter() >= self._stop_at:
            self.stop(calls)

    def stop(self, calls: dict) -> None:
        """End the traced part: every call it launched finishes inside it."""
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.calls, self.done, self.prof = dict(calls), self.prof, None


class TableCopy:
    """Pinned host buffers for the event tables in flight: each field is
    copied without blocking and one event marks the copy's end."""

    def __init__(self, slots: int = 2):
        self.slots = [None] * slots

    def start(self, table, slot: int):
        bufs = self.slots[slot]
        if bufs is None or any(bufs[f].shape != getattr(table, f).shape for f in TABLE_FIELDS):
            pin = torch.cuda.is_available()
            bufs = {f: torch.empty(getattr(table, f).shape, dtype=getattr(table, f).dtype,
                                   pin_memory=pin) for f in TABLE_FIELDS}
            self.slots[slot] = bufs
        for f in TABLE_FIELDS:
            bufs[f].copy_(getattr(table, f), non_blocking=True)
        ev = None
        if getattr(table, "valid").is_cuda:
            ev = torch.cuda.Event()
            ev.record()
        return bufs, ev

    @staticmethod
    def wait(handle):
        bufs, ev = handle
        if ev is not None:
            ev.synchronize()
        return bufs


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[f], b[f]) for f in TABLE_FIELDS)


class Variants:
    """Each input's distinct tables and how many calls gave each: every
    table of the window is judged, through the first copy of its kind."""

    def __init__(self):
        self.by_input = {}

    def add(self, i: int, bufs: dict) -> None:
        host = {f: bufs[f].numpy() for f in TABLE_FIELDS}
        known = self.by_input.setdefault(i, [])
        for entry in known:
            if _same(entry[0], host):
                entry[1] += 1
                return
        known.append([{f: v.copy() for f, v in host.items()}, 1])

    def as_record(self) -> dict:
        return {i: [(t, n) for t, n in v] for i, v in self.by_input.items()}


def closed_loop(entry, inputs, seconds: float, span, variants: Variants | None,
                samples_per_call: int) -> dict:
    """Batch k + 1 is enqueued before the host waits for batch k's table,
    so one batch is in flight ahead.  The window runs until the first
    table that reaches the host after ``seconds``; the rate counts the
    samples of every batch whose table reached the host in it."""
    n = len(inputs)
    copy = TableCopy()
    calls, enqueue, done = {}, [], 0
    pending = None
    t0 = time.perf_counter()
    deadline, t_end, k = t0 + seconds, t0, 0
    while True:
        i = k % n
        ts = time.perf_counter()
        table = entry.call(i, inputs[i], span)
        enqueue.append((time.perf_counter() - ts) * 1e6)
        calls[i] = calls.get(i, 0) + 1
        with span("table_copy"):
            handle = (copy.start(table, k % 2), i)
        del table
        if pending is not None:
            with span("table_wait"):
                bufs = copy.wait(pending[0])
            t_end = time.perf_counter()
            done += 1
            if variants is not None:
                variants.add(pending[1], bufs)
            if t_end >= deadline:
                with span("drain"):
                    bufs = copy.wait(handle[0])
                if variants is not None:
                    variants.add(handle[1], bufs)
                break
        pending = handle
        k += 1
        span.tick(calls)
    return {"window_s": t_end - t0, "completed": done, "attempted": k + 1,
            "samples": done * samples_per_call, "calls": calls, "enqueue_us": enqueue}


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 0.0005:
            time.sleep(left - 0.0004)


def open_loop(entry, ring, block: int, rate: float, seconds: float, span,
              sampled: set | None) -> dict:
    """Block k of every stream is due at t0 + (k + 1) * block / rate and is
    never sent earlier; each block goes through one step with its chunk a
    view of the device-resident ring (replayed with continuing global
    indices), then its table is copied to the host.  A latency runs from
    the block's due time to the table's arrival."""
    C, streams, n = ring.shape
    nring = n // block
    period = block / rate
    blocks = max(1, int(seconds / period))
    copy = TableCopy(1)
    state = entry.init(streams)
    lat, late, enq, tables = [], [], [], {}
    t0 = time.perf_counter()
    give_up = t0 + seconds + GRACE_S
    served = 0
    for k in range(blocks):
        due = t0 + (k + 1) * period
        if time.perf_counter() > give_up:
            break
        with span("wait_due"):
            _sleep_until(due)
        sent = time.perf_counter()
        late.append((sent - due) * 1e6)
        j = k % nring
        state, table = entry.step(state, ring[..., j * block: (j + 1) * block], span)
        enq.append((time.perf_counter() - sent) * 1e6)
        with span("table_copy"):
            bufs = copy.wait(copy.start(table, 0))
        lat.append((time.perf_counter() - due) * 1e6)
        if sampled is not None and k in sampled:
            tables[k] = {f: bufs[f].numpy().copy() for f in TABLE_FIELDS}
        served += 1
        span.tick({0: served})
    t_end = time.perf_counter()
    # a block never served counts with the wait it had when the run gave up
    lat += [(t_end - (t0 + (k + 1) * period)) * 1e6 for k in range(served, blocks)]
    return {"window_s": t_end - t0, "completed": served, "attempted": blocks,
            "unserved": blocks - served,
            "latency_us": lat, "late_us": late, "enqueue_us": enq, "sampled": tables,
            "final": entry.state_host(state) if sampled is not None else None,
            "blocks": blocks, "calls": {0: blocks}}


def sample_blocks(seed: int, blocks: int, count: int) -> set:
    """A seeded sample of block indices, with the first and the last."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pick = rng.choice(blocks, size=min(count, blocks), replace=False)
    return set(int(k) for k in pick) | {0, blocks - 1}


class Run:
    """What a metric reader reads: the window, the trace, the work."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def roofline(self, stage: str):
        """Share (%) of the stage's device time that its bound would take:
        None where the trace did not see the stage."""
        t = self.trace
        if t is None or stage not in t["stage_device_s"] or not t["stage_device_s"][stage]:
            return None
        bound = self.stage_bound_s.get(stage)
        return None if not bound else 100.0 * bound / t["stage_device_s"][stage]

    def idle(self):
        t = self.trace
        if t is None or not t["window_s"]:
            return None
        return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def quantile(values, q: float) -> float:
    """The q-th quantile (0 < q < 1) by `statistics.quantiles` (n = 100)."""
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="inclusive")[round(q * 100) - 1])


def make_inputs(cell: Cell, seed: int, device) -> dict:
    g = stimulus.seeded(seed, device)
    t = cell.traffic
    if cell.loop == "closed":
        return {"inputs": [stimulus.streams(cell.config, t, g, t["batch"], t["samples"], device)
                           for _ in range(stimulus.distinct(cell.config, t))]}
    return {"ring": stimulus.streams(cell.config, t, g, t["streams"], t["ring_samples"], device)}


def warm_up(cell: Cell, entry, data: dict, span, parts: dict | None = None) -> None:
    """Every shape the window uses, and the allocator's steady state;
    ``parts`` gets the first call's time (s), which loads the kernels."""
    t = cell.traffic
    t0 = time.perf_counter()
    if cell.loop == "closed":
        closed_loop(entry, data["inputs"], 0.0, span, None, 0)
        if parts is not None:  # both of its tables have reached the host
            parts["first_call"] = time.perf_counter() - t0
        for _ in range(t.get("warmup_rounds", 2)):
            for i, x in enumerate(data["inputs"]):
                entry.call(i, x, span)
    else:
        ring, block = data["ring"], t["block"]
        state = entry.init(ring.shape[1])
        copy = TableCopy(1)
        for j in range(t.get("warmup_blocks", 16)):
            k = j % (ring.shape[-1] // block)
            state, table = entry.step(state, ring[..., k * block: (k + 1) * block], span)
            TableCopy.wait(copy.start(table, 0))
            if j == 0 and parts is not None:
                parts["first_call"] = time.perf_counter() - t0
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def window(cell: Cell, entry, data: dict, seconds: float, seed: int, span) -> dict:
    """The measured window, keeping what the reference will judge."""
    t = cell.traffic
    if cell.loop == "closed":
        variants = Variants()
        x0 = data["inputs"][0]
        out = closed_loop(entry, data["inputs"], seconds, span, variants,
                          x0.shape[1] * x0.shape[2])
        out["variants"] = variants.as_record()
        return out
    rate = cell.config["system"]["sample_rate_hz"]
    block = t["block"]
    blocks = max(1, int(seconds * rate / block))
    return open_loop(entry, data["ring"], block, rate, seconds, span,
                     sample_blocks(seed, blocks, t["check_blocks"]))


def record_for_judge(cell: Cell, entry, data: dict, win: dict) -> dict:
    rec = {"loop": cell.loop, "traffic": cell.traffic, "calls": win["calls"]}
    if cell.loop == "closed":
        rec.update(inputs=data["inputs"], variants=win["variants"],
                   kept=dict(getattr(entry, "kept", {})),
                   taps=getattr(entry, "taps", None))
    else:
        rec.update(ring=data["ring"], sampled=win["sampled"], final=win["final"],
                   blocks=win["blocks"])
    return rec


def stage_bounds(cell: Cell, entry, data: dict, calls: dict, gated) -> dict:
    """The bound (s) of every stage over the traced calls (``calls``: per
    input, or the blocks of an open loop under key 0)."""
    from benchmark.work.counts import bound_s

    out = {}
    for stage in entry.stages:
        total = 0.0
        if cell.loop == "closed":
            for i, n in calls.items():
                total += n * bound_s(*entry.work(stage, data["inputs"][i], gated[i]))
        else:
            ring, block = data["ring"], cell.traffic["block"]
            total = calls[0] * bound_s(*entry.work(stage, ring[..., :block], gated))
        out[stage] = total
    return out


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``ofdm_sync_tpu_torch`` passes)."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def check_lines(checks: dict) -> list[str]:
    return [f"check {name}: {value!r} (limit {limit!r})" for name, (value, limit) in
            checks.items()]


def passed(checks: dict) -> bool:
    return all(value <= limit for value, limit in checks.values())


def result_line(*, correct, attempted, failed, metrics, device, checks, breakdown=None) -> dict:
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return line
