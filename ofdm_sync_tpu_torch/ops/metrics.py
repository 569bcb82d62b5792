"""Detector metrics (port of the Minn-RTL, [A][A] and Zadoff-Chu parts of
`ofdm_sync_tpu.ops.metrics`): the Minn-RTL adjacent-quarter metric
(reference minn_rtl.py:583-733, ref/minn_antenna_path.sv:33-194), the
[A][A] streaming metric (reference sync_aa.py:421-493) and the ZC matched
filter with its normalizations (reference zc.py:106-130,
zc_v2.py:244-271, 486-498)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ofdm_sync_tpu_torch.ops.channel import fft_convolve_full, fft_convolve_full_ols
from ofdm_sync_tpu_torch.ops.windows import (
    delayed_product,
    exp_smooth_shift,
    running_sum_stream,
    shift_right,
    sliding_sum_valid,
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


# ---------------------------------------------------------------------------
# ZC matched filter (reference zc.py:106-130, zc_v2.py:244-271)
# ---------------------------------------------------------------------------

def _reference(reference, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(reference, device=like.device).to(like.dtype)


def matched_filter(rx: torch.Tensor, reference, block: int | None = None, mxu: bool = False,
                   mxu_precision: str = "bf16x3") -> torch.Tensor:
    """Per-branch full correlation with the conjugate-reversed reference:
    complex (branches, L + R - 1).

    block: the overlap-save block size of `ops.channel.fft_convolve_full_ols`
    (batched small FFTs); None keeps the monolithic FFT form the reference
    pipelines are held to.  mxu=True routes through
    `kernels.matched_filter.matched_filter_ols` (kernel E on a card, at
    ``mxu_precision``), the JAX package's route to its TPU kernel; the
    reference may then have at most `kernels.matched_filter.MAX_TAPS`
    samples."""
    x = _as2d(rx)
    taps = _reference(reference, x).flip(-1).conj()
    if mxu:
        from ofdm_sync_tpu_torch.kernels.matched_filter import matched_filter_ols

        xp = torch.stack([x.real, x.imag], dim=1).to(torch.float32)
        y = matched_filter_ols(xp.reshape(2 * x.shape[0], 1, x.shape[-1]), taps,
                               precision=mxu_precision)
        return torch.complex(y[0::2, 0], y[1::2, 0]).to(x.dtype)
    if block is not None:
        return fft_convolve_full_ols(x, taps, block)
    return fft_convolve_full(x, taps.unsqueeze(0))


def sliding_energy_full(rx: torch.Tensor, window: int) -> torch.Tensor:
    """``conv(|x|^2, ones(window), 'full')``, the normalization denominator
    (reference zc.py:117, zc_v2.py:266-268): ``E[m] = sum_{k=m-W+1}^{m}
    |x[k]|^2`` for m < L + W - 1, with x zero outside [0, L).  The window
    sums come from a float64 cumulative sum (the JAX version sums in
    float32, so the two differ by float32 rounding)."""
    p = _as2d(rx).abs() ** 2
    padded = torch.nn.functional.pad(p, (window - 1, window - 1))
    return sliding_sum_valid(padded, window)


def _ref_norm(ref: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((ref.abs() ** 2).sum())


def zc_normalized_correlation(rx: torch.Tensor, reference) -> tuple[torch.Tensor, torch.Tensor]:
    """Branch-summed normalized matched-filter output and its magnitude,
    zc.py flavour (reference zc.py:106-128): numerators and branch powers
    are summed across branches before the normalization."""
    x = _as2d(rx)
    ref = _reference(reference, x)
    num = matched_filter(x, ref).sum(dim=0)
    power = sliding_energy_full(x, ref.shape[-1]).sum(dim=0)
    denom = _ref_norm(ref) * torch.sqrt(power.clamp_min(0.0) + _EPS)
    corr = num / denom
    return corr, corr.abs()


def zc_normalized_correlation_per_branch(rx: torch.Tensor, reference) -> torch.Tensor:
    """zc_v2 flavour (reference zc_v2.py:486-498): normalize each branch,
    then sum the branches.  Returns the branch-summed complex corr."""
    x = _as2d(rx)
    ref = _reference(reference, x)
    num = matched_filter(x, ref)
    power = sliding_energy_full(x, ref.shape[-1])
    denom = _ref_norm(ref) * torch.sqrt(power.clamp_min(_EPS))
    return (num / denom).sum(dim=0)
