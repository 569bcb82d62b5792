"""Sliding-window primitives (port of `ofdm_sync_tpu.ops.windows`).

Every sliding correlation/energy decomposes into an elementwise lag product,
a windowed sum and static shifts.  Windowed sums are cumulative-sum
differences.  Here the cumulative sum runs in float64 and the difference is
cast back to the input dtype: a float32 cumsum over a long stream drifts
(3.1e-5 on window sums near 96 at 8192 samples, Q = 512), while float64
keeps every window sum within one rounding of its exact value.

All functions work on the LAST axis and broadcast over leading axes.
"""

from __future__ import annotations

import torch


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype.is_complex:
        return torch.complex128
    if dtype.is_floating_point:
        return torch.float64
    return torch.int64


def shift_right(x: torch.Tensor, delay: int, fill=0) -> torch.Tensor:
    """``y[n] = x[n - delay]`` with ``fill`` for ``n < delay`` (a delay line
    that reads ``fill`` while priming)."""
    if delay < 0:
        raise ValueError("delay must be non-negative")
    if delay == 0:
        return x
    n = x.shape[-1]
    if delay >= n:
        return torch.full_like(x, fill)
    head = torch.full(x.shape[:-1] + (delay,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[..., : n - delay]], dim=-1)


def delayed_product(x: torch.Tensor, delay: int) -> torch.Tensor:
    """``u[n] = x[n] * conj(x[n - delay])``, zero for ``n < delay`` (the lag
    product of every streaming autocorrelator)."""
    prod = x * shift_right(x, delay).conj()
    n = torch.arange(x.shape[-1], device=x.device)
    return torch.where(n >= delay, prod, torch.zeros((), dtype=prod.dtype, device=x.device))


def running_sum_stream(x: torch.Tensor, window: int) -> torch.Tensor:
    """Causal running sum with zero history:
    ``y[n] = sum_{k=max(0, n-window+1)}^{n} x[k]``, same length as x."""
    if window <= 0:
        raise ValueError("window must be positive")
    cs = torch.cumsum(x.to(_acc_dtype(x.dtype)), dim=-1)
    return (cs - shift_right(cs, window)).to(x.dtype)


def sliding_sum_valid(x: torch.Tensor, window: int) -> torch.Tensor:
    """``y[d] = sum_{k=d}^{d+window-1} x[k]``; length ``L - window + 1``."""
    if window <= 0:
        raise ValueError("window must be positive")
    cs = torch.cumsum(x.to(_acc_dtype(x.dtype)), dim=-1)
    lead = cs[..., window - 1: window]
    rest = cs[..., window:] - cs[..., :-window]
    return torch.cat([lead, rest], dim=-1).to(x.dtype)


def linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``s[n] = a[n] * s[n-1] + b[n]`` with ``s[-1] = 0``.

    Log-depth (Hillis-Steele) scan of affine maps: ceil(log2 L) passes of
    elementwise work, no Python loop over samples."""
    A, B = a, b
    n = a.shape[-1]
    d = 1
    while d < n:
        B = B + A * shift_right(B, d, 0)
        A = A * shift_right(A, d, 1)
        d *= 2
    return B


def exp_smooth_shift(
    x: torch.Tensor, smooth_shift: int, update_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Exponential smoothing ``s += (x - s) / 2**smooth_shift``; the state
    holds where ``update_mask`` is False (the RTL `metric_valid` gating)."""
    if smooth_shift < 0:
        raise ValueError("smooth_shift must be non-negative")
    if smooth_shift == 0:
        if update_mask is None:
            return x
        alpha = update_mask.to(x.dtype)
    else:
        alpha = torch.full_like(x, 1.0 / (1 << smooth_shift))
        if update_mask is not None:
            alpha = torch.where(update_mask, alpha, torch.zeros_like(alpha))
    return linear_recurrence(1.0 - alpha, alpha * x)
