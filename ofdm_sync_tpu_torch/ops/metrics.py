"""Detector timing metrics (port of `ofdm_sync_tpu.ops.metrics`), each a
reference detector's per-offset loop re-derived as windowed sums:

  sc_metric          <- reference sc.py:42-78
  minn_metric        <- reference minn.py:59-112
  sc_generic_metric  <- reference combined_sc_min.py:116-164
  minn_rtl_metric    <- reference minn_rtl.py:583-733, ref/minn_antenna_path.sv
  park_metric        <- reference park.py:64-114
  matched_filter     <- reference zc.py:106-130, zc_v2.py:244-271
  zc_freq_metric     <- reference zc_freq.py:62-99
  aa_metric          <- reference sync_aa.py:421-493

The windowed sums accumulate in float64 (`ops.windows`), where the JAX
package accumulates a float32 cumulative sum: the two differ by the JAX
version's drift (the tests hold them within 2e-5 of the peak).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ofdm_sync_tpu_torch.ops.channel import fft_convolve_full, fft_convolve_full_ols
from ofdm_sync_tpu_torch.ops.detect import earliest_long_run_end, largest_true_run
from ofdm_sync_tpu_torch.ops.windows import (
    delayed_product,
    exp_smooth_shift,
    frame_signal,
    running_sum_stream,
    shift_right,
    sliding_sum_valid,
    trailing_average,
)

_EPS = 1e-12


def _empty(x: torch.Tensor):
    z = torch.zeros(0, device=x.device)
    return z, z.to(torch.complex64), z


# ---------------------------------------------------------------------------
# Schmidl & Cox (reference sc.py:42-146)
# ---------------------------------------------------------------------------

def sc_metric(rx: torch.Tensor, n_fft: int):
    """S&C streaming metric ``M = |P|^2 / R^2`` at every window offset, with
    ``P(d) = sum_{k=d}^{d+half-1} x[k] conj(x[k+half])`` and ``R(d) =
    sum_{k=d+half}^{d+N-1} |x[k]|^2`` (the reference's recursive update,
    reference sc.py:65-72, unrolled).  Returns (M, P, R), each of length
    L - N + 1, summed over branches."""
    if n_fft % 2:
        raise ValueError(f"n_fft must be even, got {n_fft}")
    x = _as2d(rx)
    half = n_fft // 2
    out_len = x.shape[-1] - n_fft + 1
    if out_len <= 0:
        return _empty(x)
    P = sliding_sum_valid(x[:, :-half] * x[:, half:].conj(), half).sum(dim=0)[:out_len]
    S = sliding_sum_valid(x.abs() ** 2, half)
    R = S[:, half: half + out_len].sum(dim=0)
    return P.abs() ** 2 / R.clamp_min(_EPS) ** 2, P, R


def _smooth_same(M: torch.Tensor, w: int) -> torch.Tensor:
    """``numpy.convolve(M, ones(w) / w, mode="same")``: output i averages
    M[i - w//2 .. i + (w-1) - w//2], zero outside (for an even w the window
    reaches one sample further back than forward)."""
    padded = torch.nn.functional.pad(M, (w // 2, w - 1 - w // 2))
    return sliding_sum_valid(padded, w) / w


def find_plateau_end(
    M: torch.Tensor,
    cp_len: int,
    lookahead: int | None = None,
    smooth_win: int = 8,
    plateau_frac: float = 0.95,
    run_threshold: float = 0.6,
) -> int:
    """Plateau-end picker with the reference's three strategies (reference
    sc.py:81-146), on the smoothed metric:

      1. the first sample <= plateau_frac x the smoothed max within cp_len
         after the argmax;
      2. the right edge of the earliest >= max(8, cp_len/2)-long run above
         run_threshold x the peak;
      3. the largest drop of the smoothed metric over ``lookahead`` samples
         near the max.
    """
    n = M.shape[-1]
    if n == 0:
        return 0
    Lh = (cp_len // 4) if lookahead is None else max(1, int(lookahead))
    Ms = _smooth_same(M, max(1, smooth_win))
    idx = torch.arange(n, device=M.device)

    # 1. early drop below plateau_frac x the local max
    center = int(torch.argmax(Ms))
    post_hi = min(n, center + cp_len)
    below = (idx > center) & (idx < post_hi) & (Ms <= plateau_frac * Ms[center])
    if post_hi > center + 1 and bool(below.any()):
        return int(torch.argmax(below.to(torch.uint8)))

    # 2. the earliest long run above run_threshold x the global max
    peak = Ms.max()
    s2 = int(earliest_long_run_end((Ms >= run_threshold * peak) & (peak > 0),
                                   max(8, cp_len // 2)))
    if s2 >= 0:
        return s2

    # 3. the slope-drop fallback
    lo = max(0, center - cp_len)
    hi = max(lo, min(n - Lh - 1, center + cp_len))
    if hi <= lo:
        return center
    ahead = torch.cat([Ms[Lh:], Ms.new_zeros(Lh)])
    drop = torch.where((idx >= lo) & (idx < hi), Ms - ahead, -math.inf)
    return int(torch.argmax(drop)) + Lh // 2


# ---------------------------------------------------------------------------
# Standard Minn [A A -A -A] (reference minn.py:59-205)
# ---------------------------------------------------------------------------

def minn_metric(rx: torch.Tensor, n_fft: int):
    """Minn metric from identical-quarter correlations, sign-aligned:
    ``P(d) = <q0,q1> + <q2,q3>``, ``R(d) = |q1|^2 + |q2|^2 + |q3|^2``,
    ``M = max(Re P, 0)^2 / R^2``, with ``P(d) = Sv(d) + Sv(d+2Q)`` from one
    windowed lag-Q product ``Sv``.  Returns (M, P, R) of length L - N + 1."""
    x = _as2d(rx)
    Q = n_fft // 4
    out_len = x.shape[-1] - n_fft + 1
    if out_len <= 0:
        return _empty(x)
    Sv = sliding_sum_valid(x[:, :-Q] * x[:, Q:].conj(), Q)
    P = (Sv[:, :out_len] + Sv[:, 2 * Q: 2 * Q + out_len]).sum(dim=0)
    Sp = sliding_sum_valid(x.abs() ** 2, Q)
    R = (Sp[:, Q: Q + out_len] + Sp[:, 2 * Q: 2 * Q + out_len]
         + Sp[:, 3 * Q: 3 * Q + out_len]).sum(dim=0)
    return P.real.clamp_min(0.0) ** 2 / R.clamp_min(_EPS) ** 2, P, R


def find_minn_peak_standard(
    M: torch.Tensor,
    smooth_win: int = 8,
    gate_threshold: float = 0.5,
    search_bounds: tuple[int, int] | None = None,
):
    """Standard-Minn peak finder (reference minn.py:131-205): trailing-
    average smoothing, a gate at gate_threshold x the max, its largest
    contiguous segment, the argmax within; the global argmax where the gate
    is empty.  Returns (peak index (0-d int64), gate mask, smoothed)."""
    n = M.shape[-1]
    Ms = trailing_average(M.clamp_min(0.0), smooth_win)
    max_ms = Ms.max()
    gate = largest_true_run(Ms >= gate_threshold * max_ms)
    if search_bounds is not None:
        start, end = max(0, search_bounds[0]), min(n, search_bounds[1])
        if start >= end:
            start, end = 0, n
        idx = torch.arange(n, device=M.device)
        gate = gate & (idx >= start) & (idx < end)
    if not bool(gate.any() & (max_ms > 0)):  # reference minn.py:195-200
        gate = torch.zeros_like(gate)
        gate[torch.argmax(Ms)] = True
    return torch.argmax(torch.where(gate, Ms, -math.inf)), gate, Ms


# ---------------------------------------------------------------------------
# Generic-length S&C with both halves' energy (reference combined_sc_min.py:116-164)
# ---------------------------------------------------------------------------

def sc_generic_metric(rx: torch.Tensor, symbol_len: int):
    """S&C variant normalized by the energy of both halves (reference
    combined_sc_min.py:149-163).  Returns (M, P, R) of length L - N + 1."""
    x = _as2d(rx)
    half = symbol_len // 2
    out_len = x.shape[-1] - symbol_len + 1
    if half == 0 or out_len <= 0:
        return _empty(x)
    P = sliding_sum_valid(x[:, :-half] * x[:, half:].conj(), half)[:, :out_len].sum(dim=0)
    Sp = sliding_sum_valid(x.abs() ** 2, half)
    R = (Sp[:, :out_len] + Sp[:, half: half + out_len]).sum(dim=0)
    return P.abs() ** 2 / R.clamp_min(_EPS) ** 2, P, R


# ---------------------------------------------------------------------------
# Minn-RTL adjacent-quarter detector (reference minn_rtl.py:583-733)
# ---------------------------------------------------------------------------

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
    Q-delayed corr tap and the Q-/2Q-delayed energy taps.  The power is
    i^2 + q^2, as kernel A and the C++ integer model compute it (exact on
    integer codes; |x|^2 through the complex magnitude is not)."""
    Q = quarter_len
    xd = shift_right(x, Q)
    quarter_product = (x * xd.conj()).real
    power = x.real ** 2 + x.imag ** 2
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
# Park conjugate-symmetric correlation (reference park.py:64-114)
# ---------------------------------------------------------------------------

def _poly_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched full linear convolution along the last axis (complex).
    Operands of at most 8 samples unroll to shift-adds; longer ones take
    the FFT product of `ops.channel.fft_convolve_full`."""
    s, t = u.shape[-1], v.shape[-1]
    if min(s, t) <= 8:
        a, b = (u, v) if s <= t else (v, u)
        lead = torch.broadcast_shapes(u.shape[:-1], v.shape[:-1])
        out = torch.zeros(lead + (s + t - 1,), dtype=torch.promote_types(u.dtype, v.dtype),
                          device=u.device)
        for k in range(a.shape[-1]):
            out[..., k: k + b.shape[-1]] += a[..., k: k + 1] * b
        return out
    return fft_convolve_full(u, v)


def _place_strided(chunks: torch.Tensor, stride: int, base: int, out_len: int) -> torch.Tensor:
    """Chunk j (the last-but-one axis) placed at output offset ``base +
    j*stride``, zeros elsewhere.  A chunk may be at most ``stride`` long, so
    placements never overlap and the scatter is a pad and a reshape."""
    *lead, J, C = chunks.shape
    assert C <= stride
    flat = torch.nn.functional.pad(chunks, (0, stride - C)).reshape(*lead, J * stride)
    flat = torch.nn.functional.pad(flat, (base, max(0, out_len - base - J * stride)))
    return flat[..., :out_len]


def park_banded_selfconv(x: torch.Tensor, half: int) -> torch.Tensor:
    """``P(d) = sum_{k=0}^{half-1} x[d-k] x[d+k]`` for all d, in O(L log half).

    P is the even-index diagonal of the banded self-convolution ``S[m] =
    sum_{|u-v| <= 2half-2, u+v=m} x[u] x[v]``: ``P(d) = (S[2d] + x[d]^2) /
    2``.  With x cut into blocks of ``half``: on the even output grid every
    pair with u+v even has u-v even, so within-block and adjacent-block
    pairs are wholly in band (their out-of-band pairs land on odd outputs,
    which are dropped), and distance-2 block pairs contribute a triangle,
    evaluated by a binary recursion whose cross half-block products are
    exact on even outputs.  log2(half) levels of batched FFT products, all
    placements stride-uniform (pad and reshape, no scatter).

    x: (..., L) complex, ``half`` a power of two.  Returns (..., L), P[d]
    valid for d in [half, L - half); other positions hold edge partials."""
    h = int(half)
    if h & (h - 1):
        raise ValueError(f"park_banded_selfconv requires power-of-two half, got {h}")
    L = x.shape[-1]
    lead = x.shape[:-1]
    nblocks = -(-L // h) + 2  # two zero blocks keep the a+2 lookups in range
    Lp = nblocks * h
    xp = torch.nn.functional.pad(x, (0, Lp - L))
    out_len = 2 * Lp

    blocks = xp.reshape(*lead, nblocks, h)
    # within-block pairs (|u-v| <= h-1, always in band)
    S = _place_strided(_poly_mul(blocks, blocks), 2 * h, 0, out_len)
    # adjacent-block pairs, twice for both orders (the one out-of-band
    # corner pair has odd u-v: an odd output, dropped)
    S = S + 2.0 * _place_strided(
        _poly_mul(blocks[..., :-1, :], blocks[..., 1:, :]), 2 * h, h, out_len)
    # distance-2 block pairs: the triangle u_loc >= v_loc + 2, by recursion
    s = h // 2
    while s >= 2:
        rows = xp.reshape(*lead, Lp // (2 * s), 2 * s)
        shift = h // s  # rows spanning two blocks
        U = rows[..., : rows.shape[-2] - shift, s:]  # upper halves, block a
        V = rows[..., shift:, :s]                    # lower halves, block a+2
        S = S + 2.0 * _place_strided(_poly_mul(U, V), 4 * s, 2 * h + s, out_len)
        s //= 2
    return (S[..., ::2][..., :L] + x * x) * 0.5


def park_metric(rx: torch.Tensor, n_fft: int):
    """Centered correlation ``P(d) = sum_k x[d-k] x[d+k]`` over half = N/2
    and the energy ``E(d)`` of x[d : d+half], summed over branches.
    Returns (ds, M, P, E) with ds the centers [half, L - half) (reference
    park.py:87-113).  A power-of-two half takes `park_banded_selfconv`;
    another half gathers every frame (O(L * half))."""
    x = _as2d(rx)
    half = n_fft // 2
    L = x.shape[-1]
    if half == 0 or L < 2 * half + 1:
        M, P, E = _empty(x)
        return torch.zeros(0, dtype=torch.int64, device=x.device), M, P, E
    ds = torch.arange(half, L - half, device=x.device)
    if half & (half - 1):
        k = torch.arange(half, device=x.device)
        fwd = frame_signal(x, ds.shape[0], half, hop=1, offset=half)  # x[d+k]
        bwd = x[:, ds[:, None] - k[None, :]]                          # x[d-k]
        P = (bwd * fwd).sum(dim=(0, -1))
        E = (fwd.abs() ** 2).sum(dim=(0, -1))
    else:
        P = park_banded_selfconv(x, half).sum(dim=0)[half: L - half]
        E = sliding_sum_valid(x.abs() ** 2, half).sum(dim=0)[half: L - half]
    return ds, P.abs() ** 2 / E.clamp_min(_EPS) ** 2, P, E


# ---------------------------------------------------------------------------
# ZC frequency-domain metric (reference zc_freq.py:54-99)
# ---------------------------------------------------------------------------

def _zc_template(x: torch.Tensor, template_bins, n_offsets: int):
    """The template on x's device and its energy; raises for a stream
    shorter than one symbol."""
    if n_offsets <= 0:
        raise ValueError("Received stream is shorter than a single OFDM symbol.")
    template = torch.as_tensor(np.asarray(template_bins), device=x.device).to(torch.complex64)
    return template, (template.abs() ** 2).sum()


def zc_freq_metric(
    rx: torch.Tensor,
    template_bins,
    bin_indices,
    n_fft: int,
    cp_len: int,
    chunk: int = 512,
) -> torch.Tensor:
    """LTE-style frequency metric at every CP-start offset o: the FFT of
    the window x[o + cp : o + cp + N], its template bins at the fftshifted
    positions (N/2 + b) % N, then ``|sum_b conj(T) X|^2 / (|T|^2 sum_b
    |X|^2)`` over bins and branches (reference zc_freq.py:85-97: one FFT per
    offset).  ``chunk`` offsets are transformed per batched FFT, so peak
    memory is chunk x branches x N."""
    x = _as2d(rx).to(torch.complex64)
    num_offsets = x.shape[-1] - (n_fft + cp_len) + 1
    template, t_energy = _zc_template(x, template_bins, num_offsets)
    positions = torch.as_tensor((n_fft // 2 + np.asarray(bin_indices)) % n_fft, device=x.device)
    windows = frame_signal(x, num_offsets, n_fft, offset=cp_len)  # (B, offsets, N), a view
    out = []
    for c0 in range(0, num_offsets, chunk):
        spec = torch.fft.fftshift(torch.fft.fft(windows[:, c0: c0 + chunk], dim=-1), dim=-1)
        bins = spec[..., positions]                                 # (B, chunk, bins)
        corr = (template.conj() * bins).sum(dim=(0, -1))
        energy = (bins.real ** 2 + bins.imag ** 2).sum(dim=(0, -1))
        out.append((corr.real ** 2 + corr.imag ** 2) / (t_energy * energy).clamp_min(_EPS))
    return torch.cat(out)


def zc_freq_metric_sliding(
    rx: torch.Tensor,
    template_bins,
    bin_indices,
    n_fft: int,
    cp_len: int,
) -> torch.Tensor:
    """`zc_freq_metric` as sliding DFT bins: each template bin is a windowed
    sum of a modulated stream,

        X_o[k] = w_k^{-(o+cp)} S_k[o+cp],  S_k[t] = sum_{n=t}^{t+N-1} x[n] w_k^n,
        w_k = exp(-2j pi k / N),

    so the search is one modulate-and-window-sum pass per template bin, with
    no per-offset FFT.  The phasors take n mod N before the product with k
    (k (n mod N) < N^2 stays small and exact), and the energy needs no
    un-rotation (|X| = |S|).  Equal to `zc_freq_metric` up to float32
    rounding."""
    x = _as2d(rx).to(torch.complex64)
    L = x.shape[-1]
    num_offsets = L - (n_fft + cp_len) + 1
    template, t_energy = _zc_template(x, template_bins, num_offsets)
    kbins = np.mod(np.asarray(bin_indices), n_fft)  # FFT bin b % N
    dev = x.device
    two_pi_over_n = torch.tensor(2.0 * np.pi / n_fft, dtype=torch.float32, device=dev)
    m = torch.arange(n_fft, device=dev)
    w_fwd = torch.exp(-1j * (two_pi_over_n * m.to(torch.float32)))  # w^m, m < N
    w_inv = w_fwd.conj()
    n_mod = torch.arange(L, device=dev) % n_fft
    o_mod = (torch.arange(num_offsets, device=dev) + cp_len) % n_fft
    corr = torch.zeros(num_offsets, dtype=torch.complex64, device=dev)
    energy = torch.zeros(num_offsets, dtype=torch.float32, device=dev)
    for k, T in zip(kbins.tolist(), template):
        S = sliding_sum_valid(x * w_fwd[(k * n_mod) % n_fft], n_fft)
        Sb = S[:, cp_len: cp_len + num_offsets]
        corr = corr + T.conj() * w_inv[(k * o_mod) % n_fft] * Sb.sum(dim=0)
        energy = energy + (Sb.real ** 2 + Sb.imag ** 2).sum(dim=0)
    return (corr.real ** 2 + corr.imag ** 2) / (t_energy * energy).clamp_min(_EPS)


# ---------------------------------------------------------------------------
# [A][A] streaming detector metric (reference sync_aa.py:421-493)
# ---------------------------------------------------------------------------


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
