"""zc_mf.roofline: the bound of the matched filter's work (frozen
counts) over the device time of what the filter call launched (%)."""


def read(run):
    return run.roofline("mf_call")
