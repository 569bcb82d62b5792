"""minn_step.roofline: the bound of kernel F's work (frozen counts)
over the device time of what the stream step launched, over the traced
window (%)."""


def read(run):
    return run.roofline("step_call")
