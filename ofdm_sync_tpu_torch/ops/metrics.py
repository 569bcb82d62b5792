"""Detector metrics (port of the Minn-RTL and [A][A] parts of
`ofdm_sync_tpu.ops.metrics`): the Minn-RTL adjacent-quarter metric
(reference minn_rtl.py:583-733, ref/minn_antenna_path.sv:33-194) and the
[A][A] streaming metric (reference sync_aa.py:421-493)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ofdm_sync_tpu_torch.ops.windows import (
    delayed_product,
    exp_smooth_shift,
    running_sum_stream,
    shift_right,
)


class MinnRTLMetricState(NamedTuple):
    corr_total: torch.Tensor      # sum over branches of corr_recent + corr_previous
    corr_positive: torch.Tensor   # clip(corr_total, 0)
    smooth_metric: torch.Tensor   # exponential smoothing of corr_positive
    energy_total: torch.Tensor    # 3 stacked Q-window energies per branch
    corr_scaled: torch.Tensor     # smooth * 2^frac_bits
    energy_scaled: torch.Tensor   # energy_total * threshold_value
    metric_valid: torch.Tensor    # bool; True from 3Q-1 on
    above_threshold: torch.Tensor # metric_valid & (corr_scaled >= energy_scaled)


def _as2d(x: torch.Tensor) -> torch.Tensor:
    return x.unsqueeze(0) if x.ndim == 1 else x


def antenna_path(x: torch.Tensor, quarter_len: int) -> dict[str, torch.Tensor]:
    """Per-branch RTL datapath as shifts + running sums (zero priming):
    quarter product Re(x[n] conj(x[n-Q])), two Q-window running sums, the
    Q-delayed corr tap and the Q-/2Q-delayed energy taps."""
    Q = quarter_len
    xd = shift_right(x, Q)
    quarter_product = (x * xd.conj()).real
    power = x.abs() ** 2
    corr_recent = running_sum_stream(quarter_product, Q)
    energy_recent = running_sum_stream(power, Q)
    return {
        "corr_recent": corr_recent,
        "corr_previous": shift_right(corr_recent, Q),
        "energy_recent": energy_recent,
        "energy_previous": shift_right(energy_recent, Q),
        "energy_previous2": shift_right(energy_recent, 2 * Q),
    }


def minn_rtl_valid_from(quarter_len: int) -> int:
    """First sample index with all taps valid: 3Q-1."""
    return max(0, 3 * quarter_len - 1)


def minn_rtl_metric(
    rx: torch.Tensor,
    *,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    quarter_len: int,
) -> MinnRTLMetricState:
    """Branch-combined fixed-point metric with division-free threshold.
    rx: complex (L,) or (branches, L)."""
    x = _as2d(rx)
    n = x.shape[-1]
    Q = quarter_len
    taps = antenna_path(x, Q)
    corr_total = (taps["corr_recent"] + taps["corr_previous"]).sum(dim=0)
    energy_total = (taps["energy_recent"] + taps["energy_previous"]
                    + taps["energy_previous2"]).sum(dim=0)
    corr_positive = corr_total.clamp_min(0.0)
    metric_valid = torch.arange(n, device=x.device) >= minn_rtl_valid_from(Q)
    smooth = exp_smooth_shift(corr_positive, smooth_shift, update_mask=metric_valid)
    corr_scaled = smooth * float(1 << threshold_frac_bits)
    energy_scaled = energy_total * float(threshold_value)
    return MinnRTLMetricState(
        corr_total=corr_total,
        corr_positive=corr_positive,
        smooth_metric=smooth,
        energy_total=energy_total,
        corr_scaled=corr_scaled,
        energy_scaled=energy_scaled,
        metric_valid=metric_valid,
        above_threshold=metric_valid & (corr_scaled >= energy_scaled),
    )


# ---------------------------------------------------------------------------
# [A][A] streaming detector metric (reference sync_aa.py:421-493)
# ---------------------------------------------------------------------------

_EPS = 1e-12


class AAMetricState(NamedTuple):
    P: torch.Tensor      # complex correlation, running L-window of the lag-L product
    R: torch.Tensor      # current-window energy
    M: torch.Tensor      # min(|P|^2 / R^2, 1), 0 where invalid
    valid: torch.Tensor  # bool, True from n >= L


def aa_metric(rx: torch.Tensor, L: int) -> AAMetricState:
    """Causal streaming [A][A] metric with RTL fill semantics.

    ``P[n] = sum_{k=n-L+1}^{n} x[k] conj(x[k-L])`` (zero products while the
    delay line primes), ``R[n]`` the energy of the current window, both
    summed over branches; valid from n >= L.  rx: complex (L,) or
    (branches, L)."""
    x = _as2d(rx)
    n = x.shape[-1]
    P = running_sum_stream(delayed_product(x, L), L).sum(dim=0)
    R = running_sum_stream(x.abs() ** 2, L).sum(dim=0)
    valid = torch.arange(n, device=x.device) >= L
    Rc = R.clamp_min(_EPS)
    M = torch.where(valid & (R > 1e-6 * L),
                    (P.abs() ** 2 / (Rc * Rc)).clamp_max(1.0), torch.zeros_like(R))
    return AAMetricState(P=P, R=R, M=M, valid=valid)
