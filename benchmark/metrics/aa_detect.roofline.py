"""aa_detect.roofline: the bound of the [A][A] detection's work (codes in,
table and captures out; `work/aa_counts.py`) over the device time of what
the detect call launched (kernels C and B), over the traced window (%)."""


def read(run):
    return run.roofline("detect_call")
