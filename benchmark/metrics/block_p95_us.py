"""block_p95_us: the 95th percentile of the latency from a block's due
time to its event table on the host, over every block of the window (us)."""

from benchmark.harness import quantile


def read(run):
    lat = run.window.get("latency_us")
    return quantile(lat, 0.95) if lat else None
