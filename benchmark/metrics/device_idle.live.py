"""device_idle.live: the share of the traced window in which no device event
ran (%)."""


def read(run):
    return run.idle()
