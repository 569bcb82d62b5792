"""step_enqueue_us.live: host time around the stream step, before the
table copy's wait; median over the window's blocks (us)."""

import statistics


def read(run):
    e = run.window.get("enqueue_us")
    return statistics.median(e) if e else None
