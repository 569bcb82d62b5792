"""Sliding-window primitives (port of `ofdm_sync_tpu.ops.windows`).

Every sliding correlation/energy decomposes into an elementwise lag product,
a windowed sum and static shifts.  Windowed sums are cumulative-sum
differences.  Here the cumulative sum runs in float64 and the difference is
cast back to the input dtype: a float32 cumsum over a long stream drifts
(3.1e-5 on window sums near 96 at 8192 samples, Q = 512), while float64
keeps every window sum within one rounding of its exact value.  A row
longer than `SCAN_BLOCK` is scanned in two levels (`cumsum`).

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


#: rows longer than this take `cumsum`'s two-level scan
SCAN_BLOCK = 4096


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along the last axis in the accumulation dtype
    (float64, complex128 or int64).  A row longer than `SCAN_BLOCK` is
    scanned within blocks of `SCAN_BLOCK` samples, then across the block
    totals: `torch.cumsum` along a long last axis of few rows leaves a
    card nearly idle (`chip_smoke.py` phase 16 times both; PERF.md).  Exact
    on integer input, within float64 rounding otherwise."""
    x = x.to(_acc_dtype(x.dtype))
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return torch.cumsum(x, dim=-1)
    lead = x.shape[:-1]
    blocks = torch.nn.functional.pad(x, (0, -n % SCAN_BLOCK)).reshape(
        *lead, -1, SCAN_BLOCK).cumsum(dim=-1)
    blocks[..., 1:, :] += blocks[..., :-1, -1].cumsum(dim=-1).unsqueeze(-1)
    return blocks.reshape(*lead, -1)[..., :n]


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
    cs = cumsum(x)
    return (cs - shift_right(cs, window)).to(x.dtype)


def sliding_sum_valid(x: torch.Tensor, window: int) -> torch.Tensor:
    """``y[d] = sum_{k=d}^{d+window-1} x[k]``; length ``L - window + 1``."""
    if window <= 0:
        raise ValueError("window must be positive")
    cs = cumsum(x)
    lead = cs[..., window - 1: window]
    rest = cs[..., window:] - cs[..., :-window]
    return torch.cat([lead, rest], dim=-1).to(x.dtype)


def trailing_average(x: torch.Tensor, window: int) -> torch.Tensor:
    """Streaming trailing moving average with partial-window warm-up:
    ``y[n] = (sum of the last min(n+1, window) samples) / min(n+1, window)``
    (reference minn.py:115-128, combined_sc_min.py:167-180)."""
    if window <= 1:
        return x.to(torch.promote_types(x.dtype, torch.float32))
    rs = running_sum_stream(x, window)
    n = torch.arange(x.shape[-1], device=x.device)
    return rs / n.add(1).clamp_max(window).to(rs.dtype)


def frame_signal(x: torch.Tensor, num_frames: int, frame_len: int, hop: int = 1,
                 offset: int = 0) -> torch.Tensor:
    """Overlapping frames ``out[..., d, k] = x[..., offset + d*hop + k]``, a
    view of ``x`` (no copy); the frames must lie inside ``x``."""
    if num_frames <= 0:
        return x.new_zeros(x.shape[:-1] + (0, frame_len))
    frames = x[..., offset:].unfold(-1, frame_len, hop)[..., :num_frames, :]
    if frames.shape[-2] < num_frames:
        raise ValueError(f"{num_frames} frames of {frame_len} at hop {hop} from {offset} "
                         f"run past the end of {x.shape[-1]} samples")
    return frames


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
