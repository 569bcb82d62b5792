"""Profiling and timing (port of `ofdm_sync_tpu.utils.profiling`).

* `trace(log_dir)`: a context manager around `torch.profiler.profile` (CPU
  activity, plus CUDA where a card is present) that exports a Chrome trace
  of everything run inside it (`trace.json`, which Perfetto and
  chrome://tracing read);
* `Throughput`: a steady-state samples/s meter (host enqueue time per call,
  and the wall time of ``iters`` calls ended by a synchronize of the
  output's device);
* `kernel_stats`: the one-line throughput / latency summary;
* `cuda_ms`, `device_ms`, `kernel_ms`: the three device timings
  `chip_smoke.py` reports (one call between CUDA events, back-to-back calls
  between two events, torch.profiler's device time);
* `call_times`, `summary`: one CUDA-event pair around each of many calls,
  and their median and p90 (the bench's timing);
* `device_window`: torch.profiler over a window of calls, the device time
  by kernel name and the device's idle share;
* `marginal_us`: the per-step cost of a streaming step from the difference
  of two run lengths.
All but `trace`, `Throughput` and `kernel_stats` need a card.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str = "ofdm_sync_trace"):
    """Profile the enclosed work: ``with profiling.trace(dir): fn(x)``;
    writes ``<log_dir>/trace.json`` and yields its path."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _first_tensor(out):
    """The first tensor of a (nested) tuple / list / dict / NamedTuple, or None."""
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else ())
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _sync(out) -> None:
    """Wait for the device work behind ``out``: synchronize its first
    tensor's CUDA device; nothing for CPU outputs."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclass
class Throughput:
    """Steady-state throughput meter.

    >>> meter = Throughput(samples_per_call=batch * stream_len)
    >>> stats = meter.measure(fn, x, iters=10)
    """

    samples_per_call: int
    warmup: int = 2
    latencies_s: list = field(default_factory=list)

    def measure(self, fn, *args, iters: int = 10) -> dict:
        for _ in range(self.warmup):
            _sync(fn(*args))
        lats = []
        t_all0 = time.perf_counter()
        out = None
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args)
            lats.append(time.perf_counter() - t0)  # enqueue time
        _sync(out)
        wall = time.perf_counter() - t_all0
        self.latencies_s = lats
        return {
            "samples_per_sec": self.samples_per_call * iters / wall,
            "wall_s": wall,
            "iters": iters,
            "samples_per_call": self.samples_per_call,
        }


def kernel_stats(fn, *args, samples_per_call: int, iters: int = 10,
                 label: str = "kernel") -> dict:
    """Measure and print one function's steady-state throughput."""
    stats = Throughput(samples_per_call=samples_per_call).measure(fn, *args, iters=iters)
    sps = stats["samples_per_sec"]
    print(f"{label}: {sps / 1e6:.1f} M IQ samples/s "
          f"({stats['wall_s'] * 1e3 / iters:.2f} ms/call)")
    return stats


def cuda_ms(fn, warmup: int = 1, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, warmup: int = 2, reps: int = 20) -> float:
    """Device time of one fn(): the mean over `reps` back-to-back calls
    between two CUDA events, after `warmup` calls (no host sync between
    the calls, so the host's per-call work overlaps the device's)."""
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_ms(fn, reps: int = 5) -> float | None:
    """Device time of the work one fn() puts on the card: torch.profiler's
    device events summed, mean over `reps` calls after one warm-up.  Unlike
    cuda_ms and device_ms it leaves out the host's share (a wrapper whose
    host work outlasts its kernels shows that work in device_ms).  None
    where the profiler records no device activity."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3 if us else None


def call_times(fn, n: int, warmup: int = 3) -> list[float]:
    """ms of each of ``n`` calls of fn(), one CUDA-event pair around each
    call (the host's work for the call inside it), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    pairs[-1][1].synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def summary(times) -> dict:
    """Median, p90 and count of a list of times (the units kept)."""
    return {"median": float(np.median(times)), "p90": float(np.percentile(times, 90)),
            "n": len(times)}


def device_window(fn, n: int, launches_per_call: int) -> dict:
    """torch.profiler over ``n`` back-to-back calls of fn() (after one
    warm-up call), ended by a synchronize: the window's wall time, the
    device time of each kernel by name with its count, the share of the
    window in which no device work ran, and the host wall of the same
    ``n`` calls without the profiler (its cost).  Where the profiler
    records fewer kernel events than ``n * launches_per_call``, the device
    fields read "not measured" with the reason instead of a number."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("device_window"):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    win = [e for e in events if e.name == "device_window"
           and e.device_type == torch.autograd.DeviceType.CPU]
    lo, hi = win[0].time_range.start, win[0].time_range.end
    spans, by_kernel = [], {}
    for e in events:  # the device's work, not the window's own annotation
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name == "device_window":
            continue
        spans.append((e.time_range.start, e.time_range.end))
        k = by_kernel.setdefault(e.name, {"ms": 0.0, "count": 0})
        k["ms"] += e.time_range.elapsed_us() / 1e3
        k["count"] += 1
    out = {"calls": n, "window_ms": (hi - lo) / 1e3, "bare_ms": bare_ms,
           "device_events": len(spans)}
    if len(spans) < n * launches_per_call:
        reason = (f"not measured: the profiler recorded {len(spans)} device events for "
                  f"{n} calls of {launches_per_call} kernels")
        return {**out, "busy_ms": reason, "idle_share": reason, "by_kernel": reason}
    busy, end = 0.0, lo
    for s, e in sorted(spans):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return {**out, "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / (hi - lo),
            "by_kernel": by_kernel}


def marginal_us(step, make_state, chunks, k0: int = 128, k1: int = 1152) -> float:
    """Per-chunk cost of a streaming step from the difference of two run
    lengths, (wall(k1 steps) - wall(k0 steps)) / (k1 - k0), one synchronize
    at each end of a run (never wall / K, which folds the fixed cost of a
    run into each step)."""
    def run(k):
        s = make_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(k):
            s = step(s, chunks[i])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(k0)  # warm
    return (run(k1) - run(k0)) / (k1 - k0) * 1e6
