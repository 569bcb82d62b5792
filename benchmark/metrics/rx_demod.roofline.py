"""rx_demod.roofline: the bound of the batched receive's work (codes of
each slot in, slot outputs and equalized bins out; `work/rx_counts.py`)
over the device time of what the demod call launched (frame re-emission,
CP CFO, FFT, LS, equalize, EVM), over the traced window (%)."""


def read(run):
    return run.roofline("demod_call")
