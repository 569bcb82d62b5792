"""zc_detect.roofline: the bound of kernels D (IQ mode) + B's work
(frozen counts) over the device time of what the detect call launched (%)."""


def read(run):
    return run.roofline("detect_call")
