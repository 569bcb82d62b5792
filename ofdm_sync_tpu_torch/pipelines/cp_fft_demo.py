"""CP / FFT-window timing demo (port of `ofdm_sync_tpu.pipelines.cp_fft_demo`;
reference ofdm_cp_fft_demo.py:1-125).

Two back-to-back QPSK OFDM symbols (N = 512, CP = 128); symbol 0's FFT
window is taken aligned, 16 samples early (inside the CP: a pure phase ramp
across the subcarriers) and 16 samples late (into the next symbol: a ramp
plus ISI).  The timing offset comes from the slope of the unwrapped phase
of each window's spectrum over the aligned one: ``STO = -slope N / (2
pi)``.  All four windows go through one batched FFT on ``device``.  With
plots on, the four constellations and the two phase slopes are written to
``plots/cp_fft_demo/``; as in the JAX demo, a failure to plot is reported
and skipped.

Run: ``python -m ofdm_sync_tpu_torch cp_fft_demo [--device cpu] [--no-plots]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.ops.estimate import unwrap
from ofdm_sync_tpu_torch.pipelines.common import PLOTS_ROOT
from ofdm_sync_tpu_torch.utils import report

N_FFT = 512
CP = 128
NUM_SYMBOLS = 2
EARLY_SAMPLES = 16
LATE_SAMPLES = 16
SNR_DB = 30.0
SEED = 7


@dataclass
class DemoResult:
    sto_est_early: float
    sto_est_late: float
    spectra: dict  # label -> (N,) complex spectrum
    phase_early: np.ndarray
    phase_late: np.ndarray


def _phase_slope_sto(ratio: torch.Tensor, n_fft: int):
    """Closed-form least-squares line through the unwrapped phase; returns
    (STO estimate, slope, intercept, phase)."""
    phase = unwrap(torch.angle(ratio))
    k = torch.arange(n_fft, dtype=phase.dtype, device=phase.device)
    km, pm = k.mean(), phase.mean()
    slope = ((k - km) * (phase - pm)).sum() / ((k - km) ** 2).sum()
    intercept = pm - slope * km
    sto = -slope * n_fft / (2 * math.pi)
    return float(sto), float(slope), float(intercept), phase.cpu().numpy()


def run_demo(rng: np.random.Generator | None = None,
             device: torch.device | str | None = None) -> DemoResult:
    rng = rng or np.random.default_rng(SEED)
    dev = resolve_device(device)

    # QPSK on all N bins, unit power (reference ofdm_cp_fft_demo.py:14-18)
    bits_i = rng.integers(0, 2, (NUM_SYMBOLS, N_FFT))
    bits_q = rng.integers(0, 2, (NUM_SYMBOLS, N_FFT))
    qpsk = ((2 * bits_i - 1) + 1j * (2 * bits_q - 1)) / np.sqrt(2)

    td = torch.fft.ifft(torch.as_tensor(qpsk, device=dev).to(torch.complex64), dim=1)
    tx = torch.cat([td[:, -CP:], td], dim=1).reshape(-1)

    noise_var = float((tx.abs() ** 2).mean()) / (10 ** (SNR_DB / 10))
    noise = np.sqrt(noise_var / 2) * (
        rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape))
    rx = tx + torch.as_tensor(noise, device=dev).to(torch.complex64)

    # the four FFT windows in one batched transform
    fft0 = CP
    fft1 = (N_FFT + CP) + CP
    starts = [fft0, fft1, fft0 - EARLY_SAMPLES, fft0 + LATE_SAMPLES]
    spectra = torch.fft.fft(torch.stack([rx[s: s + N_FFT] for s in starts]), dim=1)
    S_sym0, S_sym1, S_early, S_late = spectra

    sto_early, _, _, ph_e = _phase_slope_sto(S_early / S_sym0, N_FFT)
    sto_late, _, _, ph_l = _phase_slope_sto(S_late / S_sym0, N_FFT)
    host = spectra.cpu().numpy()
    return DemoResult(
        sto_est_early=sto_early,
        sto_est_late=sto_late,
        spectra=dict(zip(("sym0", "sym1", "early", "late"), host)),
        phase_early=ph_e,
        phase_late=ph_l,
    )


def main(device: torch.device | str | None = None, plots: bool = True) -> None:
    report.banner("CP/FFT WINDOW TIMING DEMO (N=512, CP=128)")
    res = run_demo(device=device)
    print(f"FFT window {EARLY_SAMPLES} samples early: "
          f"STO estimate = {res.sto_est_early:+.2f} samples "
          f"(expected {+EARLY_SAMPLES:+d}: early window sees the symbol "
          f"delayed)")
    print(f"FFT window {LATE_SAMPLES} samples late:  "
          f"STO estimate = {res.sto_est_late:+.2f} samples "
          f"(expected {-LATE_SAMPLES:+d})")
    if plots:
        plot_demo(res)


def plot_demo(res: DemoResult) -> None:
    """constellations.png and phase_slope.png under plots/cp_fft_demo/
    (headless-safe, as the JAX demo: a failure is printed, not raised)."""
    try:
        plt = report.pyplot()
        plots = PLOTS_ROOT / "cp_fft_demo"
        plots.mkdir(parents=True, exist_ok=True)
        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        titles = {
            "sym0": "Symbol 0 - perfect alignment",
            "early": f"Symbol 0 - {EARLY_SAMPLES} samples early",
            "late": f"Symbol 0 - {LATE_SAMPLES} samples late",
            "sym1": "Symbol 1 - perfect alignment",
        }
        for ax, key in zip(axes.flatten(), ["sym0", "early", "late", "sym1"]):
            s = res.spectra[key]
            ax.scatter(s.real, s.imag, s=8)
            ax.set_title(titles[key])
            ax.set_aspect("equal", "box")
            ax.grid(True)
        fig.tight_layout()
        fig.savefig(plots / "constellations.png", dpi=110)
        plt.close(fig)

        fig2, axp = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
        k = np.arange(N_FFT)
        for ax, ph, sto, lbl in (
            (axp[0], res.phase_early, res.sto_est_early, "early"),
            (axp[1], res.phase_late, res.sto_est_late, "late"),
        ):
            ax.plot(k, ph, ".", markersize=3)
            ax.set_title(f"Phase slope - {lbl} window (STO ~ {sto:.2f})")
            ax.grid(True)
        fig2.tight_layout()
        fig2.savefig(plots / "phase_slope.png", dpi=110)
        plt.close(fig2)
        print(f"Artifacts written to {plots}/")
    except Exception as e:  # headless-safe, as the JAX demo
        print(f"(plot emission skipped: {e})")


if __name__ == "__main__":
    main()
