"""Plain PyTorch planar datapaths (port of `ofdm_sync_tpu.kernels.streaming`).

These are the plain versions of the CUDA kernels in `kernels/csrc/`:

* Minn-RTL: the metric (kernel A, `minn_rtl_metric.cu`) and the gate/event
  extraction (kernel B, `gate_events.cu`, plain form
  `ops.detect.extract_gate_events`).  The quarter products and powers are
  combined over branches and I/Q planes first (the window sums are linear,
  so this equals summing per-branch windows), then the 2Q correlation
  window and 3Q energy window are taken from one float64 cumulative sum
  each -- the same order the CUDA kernel uses.
* [A][A]: the metric (kernel C, `aa_metric.cu`): lag-L products combined
  over branches in float64, L-window sums from float64 cumulative sums,
  then the gate input (`aa_detect_step`).  Integer-valued input makes
  every step exact, so kernel C and this version agree bit for bit.
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


class AAFastState(NamedTuple):
    P_re: torch.Tensor   # (..., L) float32
    P_im: torch.Tensor
    R: torch.Tensor
    M: torch.Tensor      # min(|P|^2 / R^2, 1), 0 where invalid
    valid: torch.Tensor  # bool, True from n >= L


def aa_metric_planar(iq: torch.Tensor, L: int) -> AAFastState:
    """Planar [A][A] metric; iq: (..., branches, 2, n) float32 or int16.

    ``P = sum_window x[n] conj(x[n-L])`` with re = i*i_d + q*q_d and
    im = q*i_d - i*q_d, and ``R`` the window power, each combined over
    branches.  Products are exact in float64 for float32 input."""
    x = iq.to(torch.float64)
    i, q = x[..., 0, :], x[..., 1, :]
    i_d, q_d = shift_right(i, L), shift_right(q, L)
    pre = (i * i_d + q * q_d).sum(dim=-2)
    pim = (q * i_d - i * q_d).sum(dim=-2)
    pw = (i * i + q * q).sum(dim=-2)
    P_re, P_im, R = (running_sum_stream(u, L).to(torch.float32) for u in (pre, pim, pw))
    M, valid = _aa_normalized(P_re * P_re + P_im * P_im, R, L)
    return AAFastState(P_re=P_re, P_im=P_im, R=R, M=M, valid=valid)


def aa_detect_step(P_re: torch.Tensor, P_im: torch.Tensor, R: torch.Tensor, L: int,
                   threshold: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused detector's gate input (`pallas_aa.py:_aa_kernel`): returns
    ``track = P_re^2 + P_im^2`` (the peak is tracked on |P|^2, not on M),
    ``M`` and ``above = n >= L & M >= threshold``.  Each operation rounds
    once in float32, as in kernel C."""
    track = P_re * P_re + P_im * P_im
    M, valid = _aa_normalized(track, R, L)
    return track, M, valid & (M >= threshold)


def _aa_normalized(track: torch.Tensor, R: torch.Tensor, L: int):
    """``M = min(track / max(R, 1e-12)^2, 1)`` where ``n >= L`` and
    ``R > 1e-6 L``, else 0; returns (M, valid)."""
    valid = torch.arange(R.shape[-1], device=R.device) >= L
    Rc = R.clamp_min(1e-12)
    M = torch.where(valid & (R > 1e-6 * L), (track / (Rc * Rc)).clamp_max(1.0),
                    torch.zeros_like(R))
    return M, valid
