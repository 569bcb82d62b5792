"""The work of the [A][A] batch detection's function, counted as
`counts.py` counts the other stages' (each input read once, each output
written once, whatever kernels carry it), for `counts.bound_s`."""

from __future__ import annotations

from benchmark.work.counts import table_bytes

#: channels captured at each event's peak: P_re, P_im, M
CAPTURED = 3


def aa_detect_work(batch, L, C, itemsize, gated, E=8):
    """[A][A] batch detection, the function: the codes read once, the event
    table and the three captured channels (float32 a slot) written once (P,
    R, M and the gate input stay inside it).  Flops a sample: the lag and
    power products, 3C multiplies and as many adds over the C planes; three
    window sums updated, an add and a subtract each; |P|^2 (3), R^2 and
    the division and clip (3), the comparison (1); then kernel B's 2 a
    sample and 10 a gated sample."""
    nbytes = batch * L * C * itemsize + table_bytes(batch, E) + batch * CAPTURED * E * 4
    return nbytes, batch * L * (6 * C + 13) + 2 * batch * L + 10 * int(gated)
