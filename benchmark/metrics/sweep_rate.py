"""sweep_rate: stream-samples of every batch whose event table reached the
host in the window, over the window (samples/s)."""


def read(run):
    w = run.window
    return w["samples"] / w["window_s"] if w.get("samples") and w["window_s"] > 0 else None
