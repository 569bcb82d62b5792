"""Plain PyTorch planar datapaths (port of `ofdm_sync_tpu.kernels.streaming`).

These are the plain versions of the CUDA kernels in `kernels/csrc/`:

* Minn-RTL: the metric (kernel A, `minn_rtl_metric.cu`, and its
  corr/energy mode `minn_rtl_corr_energy_planar`) and the gate/event
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
* Zadoff-Chu CFAR: the gate input of kernel D (`zc_cfar.cu`), on a given
  correlation magnitude (`zc_cfar_planar`) or from the matched filter's
  output and the IQ (`zc_iq_planar`: per-branch window energy,
  normalization, branch sum, magnitude; `zc_iq_planar_primed`: the same
  over [halo; shard], with the gate carry from the halo).  Energies and
  local sums come from float64 cumulative sums cast once to float32; on
  integer-valued IQ the magnitude agrees with kernel D bit for bit.

Primed mode (the kernels' carried state, `pallas_minn.py:_detect_kernel`
and its AA / ZC twins with ``base_index`` / ``shard_init``): ``hist`` holds
the samples just before the call, right-aligned (its last column is the
sample before sample 0), ``base_index`` is the global index of sample 0
(validity compares global indices) and, for Minn-RTL, ``carry_init`` is the
smoothing register before sample 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ofdm_sync_tpu_torch.ops.detect import GateEvents, extract_gate_events
from ofdm_sync_tpu_torch.ops.windows import (
    exp_smooth_shift,
    linear_recurrence,
    running_sum_stream,
    shift_right,
)


def to_planar(x: torch.Tensor) -> torch.Tensor:
    """complex (..., n) -> planar float32 (..., 2, n)."""
    return torch.stack([x.real, x.imag], dim=-2).to(torch.float32)


def from_planar(p: torch.Tensor) -> torch.Tensor:
    """planar (..., 2, n) -> complex64 (..., n)."""
    return torch.complex(p[..., 0, :].float(), p[..., 1, :].float())


class MinnRTLFastState(NamedTuple):
    corr_positive: torch.Tensor    # (..., L) float32
    smooth_metric: torch.Tensor
    energy_total: torch.Tensor
    above_threshold: torch.Tensor  # bool
    valid_from: int


def _with_history(x: torch.Tensor, hist: torch.Tensor | None) -> tuple[torch.Tensor, int]:
    """``[hist | x]`` along the last axis (float32) and the history width."""
    x = x.to(torch.float32)
    if hist is None:
        return x, 0
    return torch.cat([hist.to(torch.float32), x], dim=-1), hist.shape[-1]


def minn_rtl_corr_energy_planar(
    iq: torch.Tensor, *, quarter_len: int, hist_init: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel A's corr/energy mode (`pallas_minn.py:_corr_energy_kernel`):
    iq (..., branches, 2, L) float32 or int16 (int16 ADC codes are exact in
    float32 and converted first), optional right-aligned history (...,
    branches, 2, Hh) -> (corr_positive, energy_total), each (..., L)."""
    Q = quarter_len
    x, H = _with_history(iq, hist_init)
    u = (x * shift_right(x, Q)).sum(dim=(-3, -2))  # quarter product
    p = (x * x).sum(dim=(-3, -2))                   # instantaneous power
    corr_positive = running_sum_stream(u, 2 * Q).clamp_min(0.0)
    return corr_positive[..., H:], running_sum_stream(p, 3 * Q)[..., H:]


def minn_rtl_metric_planar(
    iq: torch.Tensor,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    base_index: int = 0,
    hist_init: torch.Tensor | None = None,
    carry_init: torch.Tensor | None = None,
) -> MinnRTLFastState:
    """Planar Minn-RTL metric; iq: (..., branches, 2, L) float32 or int16.
    Primed mode: ``hist_init`` (..., branches, 2, Hh), ``carry_init`` (...)
    the smoothing register before sample 0; the register then decays by
    1 - alpha at every sample, as in the TPU kernel's `_metric_block`."""
    Q = quarter_len
    corr_positive, energy_total = minn_rtl_corr_energy_planar(
        iq, quarter_len=Q, hist_init=hist_init)

    valid_from = max(0, 3 * Q - 1)
    n = corr_positive.shape[-1]
    metric_valid = base_index + torch.arange(n, device=corr_positive.device) >= valid_from
    if carry_init is None:
        smooth = exp_smooth_shift(corr_positive, smooth_shift, update_mask=metric_valid)
    else:
        alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0
        b = torch.where(metric_valid, alpha * corr_positive, torch.zeros_like(corr_positive))
        carry = carry_init.to(torch.float32).unsqueeze(-1)
        a = torch.full_like(b, 1.0 - alpha)
        # s[-1] = carry: a leading constant map (a = 0, b = carry)
        smooth = linear_recurrence(torch.cat([torch.zeros_like(carry), a], dim=-1),
                                   torch.cat([carry, b], dim=-1))[..., 1:]
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


def aa_metric_planar(iq: torch.Tensor, L: int, *, base_index: int = 0,
                     hist: torch.Tensor | None = None) -> AAFastState:
    """Planar [A][A] metric; iq: (..., branches, 2, n) float32 or int16,
    optional right-aligned history ``hist`` (..., branches, 2, Hh).

    ``P = sum_window x[n] conj(x[n-L])`` with re = i*i_d + q*q_d and
    im = q*i_d - i*q_d, and ``R`` the window power, each combined over
    branches.  Products are exact in float64 for float32 input.  Valid
    from global index ``base_index + n >= L``."""
    x, H = _with_history(iq, hist)
    x = x.to(torch.float64)
    i, q = x[..., 0, :], x[..., 1, :]
    i_d, q_d = shift_right(i, L), shift_right(q, L)
    pre = (i * i_d + q * q_d).sum(dim=-2)
    pim = (q * i_d - i * q_d).sum(dim=-2)
    pw = (i * i + q * q).sum(dim=-2)
    P_re, P_im, R = (running_sum_stream(u, L)[..., H:].to(torch.float32)
                     for u in (pre, pim, pw))
    M, valid = _aa_normalized(P_re * P_re + P_im * P_im, R, L, base_index)
    return AAFastState(P_re=P_re, P_im=P_im, R=R, M=M, valid=valid)


def aa_detect_step(P_re: torch.Tensor, P_im: torch.Tensor, R: torch.Tensor, L: int,
                   threshold: float, base_index: int = 0,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused detector's gate input (`pallas_aa.py:_aa_kernel`): returns
    ``track = P_re^2 + P_im^2`` (the peak is tracked on |P|^2, not on M),
    ``M`` and ``above = n >= L & M >= threshold``.  Each operation rounds
    once in float32, as in kernel C."""
    track = P_re * P_re + P_im * P_im
    M, valid = _aa_normalized(track, R, L, base_index)
    return track, M, valid & (M >= threshold)


def _aa_normalized(track: torch.Tensor, R: torch.Tensor, L: int, base_index: int = 0):
    """``M = min(track / max(R, 1e-12)^2, 1)`` where ``base_index + n >= L``
    and ``R > 1e-6 L``, else 0; returns (M, valid)."""
    valid = base_index + torch.arange(R.shape[-1], device=R.device) >= L
    Rc = R.clamp_min(1e-12)
    M = torch.where(valid & (R > 1e-6 * L), (track / (Rc * Rc)).clamp_max(1.0),
                    torch.zeros_like(R))
    return M, valid


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def cfar_gate(mag: torch.Tensor, *, corr_window: int, threshold_value: int,
              threshold_frac_bits: int, min_corr_mag: float, base_index: int = 0,
              hist: torch.Tensor | None = None):
    """The ZC CFAR gate input (`pallas_zc.py:116-121`): ``base_index + n >=
    W`` and ``mag * 2^frac >= local_sum * T`` and ``mag >= min_corr_mag``,
    with the W-window local sum (over the right-aligned magnitude history
    ``hist`` (..., Hh) before sample 0, else zeros) from a float64
    cumulative sum cast once to float32 and every product rounded once in
    float32.  Returns (above, local_sum)."""
    ext, H = _with_history(mag, hist)
    local_sum = running_sum_stream(ext, corr_window)[..., H:]
    n = base_index + torch.arange(mag.shape[-1], device=mag.device)
    above = ((n >= corr_window)
             & (mag * _f32(float(1 << threshold_frac_bits), mag)
                >= local_sum * _f32(float(threshold_value), mag))
             & (mag >= _f32(min_corr_mag, mag)))
    return above, local_sum


def zc_cfar_planar(corr_mag: torch.Tensor, **cfar) -> torch.Tensor:
    """Kernel D in magnitude mode: corr_mag float32 (..., L) -> above bool
    (..., L) (`cfar_gate`'s keywords).  The gate/peak events then track
    corr_mag itself."""
    return cfar_gate(corr_mag, **cfar)[0]


def zc_iq_planar(mf: torch.Tensor, iq: torch.Tensor, *, ref_len: int, ref_norm: float,
                 **cfar) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D in IQ mode, op for op as `pallas_zc.py:203-237`.

    mf: (2*BR, batch, Lc) float32 planar matched-filter rows; iq: (2*BR,
    batch, L_iq) float32 or int16, rows [b0_i, b0_q, b1_i, ...].  Per
    branch the power ``i*i + q*q`` (float64, exact products) is summed over
    the ``ref_len`` window ending at each correlation index (float64
    cumulative sum, cast once to float32; samples at or past L_iq are zero,
    the 'full'-convolution alignment of `sliding_energy_full`); then
    ``inv = 1 / (ref_norm * sqrt(max(E, 1e-12)))``, the branch sums of
    ``mf * inv`` in branch order, ``mag = sqrt(re*re + im*im)`` and the
    CFAR gate input on mag (`cfar_gate`'s keywords).  Returns (mag float32,
    above bool), each (batch, Lc)."""
    Lc = mf.shape[-1]
    x = iq.to(torch.float64)
    p = x[0::2] * x[0::2] + x[1::2] * x[1::2]                 # (BR, batch, L_iq)
    p = torch.nn.functional.pad(p, (0, max(Lc - p.shape[-1], 0)))[..., :Lc]
    energy = running_sum_stream(p, ref_len).to(torch.float32)
    inv = torch.reciprocal(_f32(ref_norm, mf) * torch.sqrt(energy.clamp_min(1e-12)))
    re, im = mf[0] * inv[0], mf[1] * inv[0]
    for b in range(1, inv.shape[0]):
        re = re + mf[2 * b] * inv[b]
        im = im + mf[2 * b + 1] * inv[b]
    mag = torch.sqrt(re * re + im * im)
    return mag, cfar_gate(mag, **cfar)[0]


def zc_iq_planar_primed(mf: torch.Tensor, iq: torch.Tensor, mf_halo: torch.Tensor,
                        iq_halo: torch.Tensor, *, ref_len: int, ref_norm: float,
                        base_index: int, hysteresis: int, **cfar):
    """Kernel D's primed IQ mode (the shard mode of
    `pallas_zc_tm.py:134-200`): `zc_iq_planar` over [halo; shard], the
    halos (2*BR, batch, Hh) right-aligned before sample 0 of mf and IQ, with
    sample 0 at global index ``base_index`` (`cfar_gate`'s other keywords).
    Returns (mag, above) of the shard and gate_init (batch, 2) int32 [la, la
    >= 0]: la the largest global index among the halo's last max(h, 1)
    samples whose CFAR decision is true, -1 for none."""
    Hh = mf_halo.shape[-1]
    mag, above = zc_iq_planar(
        torch.cat([mf_halo.to(torch.float32), mf], dim=-1),
        torch.cat([iq_halo.to(torch.float32), iq.to(torch.float32)], dim=-1),
        ref_len=ref_len, ref_norm=ref_norm, base_index=base_index - Hh, **cfar)
    first = max(Hh - max(int(hysteresis), 1), 0)
    idx = base_index - Hh + torch.arange(first, Hh, device=mf.device)
    la = torch.where(above[..., first:Hh], idx, -1).amax(dim=-1) if Hh > first else \
        torch.full(mf.shape[1:2], -1, dtype=torch.int64, device=mf.device)
    gate_init = torch.stack([la, (la >= 0).long()], dim=-1).to(torch.int32)
    return mag[..., Hh:], above[..., Hh:], gate_init
