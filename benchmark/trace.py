"""What a traced run reads from torch.profiler's record of its window.

Every device event of the window counts (kernels, copies, memsets): there
is no filter by the host annotation's time range.  A stage's device time is
that of the device events launched from inside the harness's span of the
stage, matched to the host's launch call by the CUDA correlation id, not by
kernel name, so a later program that fuses or renames kernels still reads
a valid share.  Idle time is the part of the window in which no device
event ran, split by the harness span the host was in meanwhile (the
innermost where spans nest).
"""

from __future__ import annotations

import bisect

from torch.autograd import DeviceType

def _kind(e, span_names) -> str | None:
    """The event's kind: ``span`` (a harness annotation on the host),
    ``launch`` (a CUDA runtime or driver call on the host), ``device`` (a
    kernel, copy or memset), or None.  Told apart by device and name, which
    every torch build gives (not all give an activity type); the device's
    echo of a harness annotation is no device work."""
    name = e.name()
    if e.device_type() != DeviceType.CPU:
        return None if name in span_names else "device"
    if name in span_names:
        return "span"
    return "launch" if name.startswith("cu") else None


def parse(prof, stages, window: str = "window", span_names=()) -> dict:
    """{busy_s, window_s, stage_device_s {stage: s}, stage_events {stage: n},
    device_events, matched, device_ops [[name, s]], idle_gaps [[span, s]]}."""
    names = {window, *stages, *span_names}
    spans, launches, device = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, names)
        if kind == "span":
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                          e.start_thread_id()))
        elif kind == "launch":
            launches.append((e.start_ns(), e.correlation_id(), e.start_thread_id()))
        elif kind == "device":
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                           e.correlation_id(), e.linked_correlation_id()))
    win = [s for s in spans if s[2] == window]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    lo, hi = win[0][0], win[0][1]
    # the stage of each launch: the stage span around it on its thread
    stage_of = {}
    launches.sort()
    for s0, s1, name, tid in spans:
        if name not in stages:
            continue
        at = bisect.bisect_left(launches, (s0, -1, -1))
        while at < len(launches) and launches[at][0] <= s1:
            if launches[at][2] == tid:
                stage_of[launches[at][1]] = name
            at += 1
    stage_s = {s: 0.0 for s in stages}
    stage_n = {s: 0 for s in stages}
    by_name, matched = {}, 0
    ids = {c for _, c, _ in launches}
    # the field of a device event that holds its launch's correlation id
    pick = 3 if sum(d[3] in ids for d in device) >= sum(d[4] in ids for d in device) else 4
    for d in device:
        d0, d1, name = d[:3]
        by_name[name] = by_name.get(name, 0.0) + (d1 - d0) * 1e-9
        st = stage_of.get(d[pick])
        if st is not None:
            stage_s[st] += (d1 - d0) * 1e-9
            stage_n[st] += 1
            matched += 1
    # device busy time and idle gaps inside the window
    busy, end, gaps = 0, lo, []
    for d0, d1, *_ in sorted(device):
        d0, d1 = max(d0, lo), min(d1, hi)
        if d1 <= d0:
            continue
        if d0 > end:
            gaps.append((end, d0))
        if d1 > end:
            busy += d1 - max(d0, end)
            end = d1
    if hi > end:
        gaps.append((end, hi))
    # each gap's time goes to the harness spans the host was in during it
    # (the innermost where they nest), the rest to "none"
    marks = []
    for s0, s1, name, _ in spans:
        if name != window:
            marks += [(s0, 1, s1 - s0, name), (s1, -1, s1 - s0, name)]
    marks.sort()
    idle_by, open_, at = {}, [], 0
    for g0, g1 in gaps:
        t = g0
        while True:
            while at < len(marks) and marks[at][0] <= t:
                _, kind, width, name = marks[at]
                (open_.append if kind > 0 else open_.remove)((width, name))
                at += 1
            nxt = min(g1, marks[at][0]) if at < len(marks) else g1
            name = min(open_)[1] if open_ else "none"
            idle_by[name] = idle_by.get(name, 0.0) + (nxt - t) * 1e-9
            if nxt >= g1:
                break
            t = nxt
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9, "stage_device_s": stage_s,
            "stage_events": stage_n, "device_events": len(device), "matched": matched,
            "launches": len(launches), "device_ops": top(by_name), "idle_gaps": top(idle_by)}
