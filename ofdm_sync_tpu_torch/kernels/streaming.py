"""Plain PyTorch planar Minn-RTL datapath (port of
`ofdm_sync_tpu.kernels.streaming`).

This is the plain version of the CUDA kernels in `kernels/csrc/`: the
metric (kernel A, `minn_rtl_metric.cu`) and the gate/event extraction
(kernel B, `gate_events.cu`, plain form `ops.detect.extract_gate_events`).

The quarter products and powers are combined over branches and I/Q planes
first (the window sums are linear, so this equals summing per-branch
windows), then the 2Q correlation window and 3Q energy window are taken
from one float64 cumulative sum each -- the same order the CUDA kernel
uses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ofdm_sync_tpu_torch.ops.detect import GateEvents, extract_gate_events
from ofdm_sync_tpu_torch.ops.windows import (
    exp_smooth_shift,
    running_sum_stream,
    shift_right,
)


class MinnRTLFastState(NamedTuple):
    corr_positive: torch.Tensor    # (..., L) float32
    smooth_metric: torch.Tensor
    energy_total: torch.Tensor
    above_threshold: torch.Tensor  # bool
    valid_from: int


def minn_rtl_metric_planar(
    iq: torch.Tensor,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
) -> MinnRTLFastState:
    """Planar Minn-RTL metric; iq: (..., branches, 2, L) float32 or int16
    (int16 ADC codes are exact in float32 and converted first)."""
    Q = quarter_len
    x = iq.to(torch.float32)
    u = (x * shift_right(x, Q)).sum(dim=(-3, -2))  # quarter product
    p = (x * x).sum(dim=(-3, -2))                   # instantaneous power
    corr_positive = running_sum_stream(u, 2 * Q).clamp_min(0.0)
    energy_total = running_sum_stream(p, 3 * Q)

    valid_from = max(0, 3 * Q - 1)
    n = corr_positive.shape[-1]
    metric_valid = torch.arange(n, device=x.device) >= valid_from
    smooth = exp_smooth_shift(corr_positive, smooth_shift, update_mask=metric_valid)
    above = metric_valid & (
        smooth * float(1 << threshold_frac_bits) >= energy_total * float(threshold_value)
    )
    return MinnRTLFastState(
        corr_positive=corr_positive,
        smooth_metric=smooth,
        energy_total=energy_total,
        above_threshold=above,
        valid_from=valid_from,
    )


def minn_rtl_detect_planar(
    iq: torch.Tensor,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    max_events: int = 8,
    tie: str = "last",
    emit_unclosed: bool = False,
) -> tuple[MinnRTLFastState, GateEvents]:
    """Metric + gate/peak event extraction; tables are (..., max_events)."""
    state = minn_rtl_metric_planar(
        iq,
        quarter_len=quarter_len,
        smooth_shift=smooth_shift,
        threshold_value=threshold_value,
        threshold_frac_bits=threshold_frac_bits,
    )
    table = extract_gate_events(
        state.above_threshold,
        state.corr_positive,
        hysteresis=hysteresis,
        max_events=max_events,
        valid_from=state.valid_from,
        tie=tie,
        emit_unclosed=emit_unclosed,
    )
    return state, table
