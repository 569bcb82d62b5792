"""minn_detect.roofline.sweep: the bound of kernels A + B's work (frozen counts) over
the device time of what the detect call launched, over the traced window (%)."""


def read(run):
    return run.roofline("detect_call")
