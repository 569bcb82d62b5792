"""Report prints and plot artifacts (port of `ofdm_sync_tpu.utils.report`).

The simulations print banner blocks and, when asked for plots, write the
reference's PNG artifact set (same file names, figure sizes, dpi and titles
as the JAX package).  matplotlib is imported inside each plotting function,
after selecting the headless Agg backend, so importing this module (as every
pipeline and `chip_smoke.py` does) never loads matplotlib: a run with plots
off needs no matplotlib at all.

Every plotting function takes tensors on any device, or NumPy arrays; they
are copied to the host first.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

BANNER = "=" * 70


def banner(title: str) -> None:
    print(f"\n{BANNER}")
    print(title)
    print(BANNER)


def pyplot():
    """matplotlib.pyplot on the Agg backend (imported on first use)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def host(x) -> np.ndarray:
    """A host NumPy copy of a tensor on any device, or np.asarray(x)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_time_series(samples, title: str, path: Path) -> None:
    """Re/Im/|x| views of a 1-D or (branches, L) waveform
    (artifact parity with reference core.py:60-110)."""
    plt = pyplot()
    samples = host(samples)
    if samples.ndim == 1:
        fig, axes = plt.subplots(3, 1, figsize=(10, 6), sharex=True)
        axes[0].plot(samples.real)
        axes[0].set_ylabel("Re")
        axes[1].plot(samples.imag)
        axes[1].set_ylabel("Im")
        axes[2].plot(np.abs(samples))
        axes[2].set_ylabel("|x|")
        axes[2].set_xlabel("Sample index")
    else:
        nch = samples.shape[0]
        fig, axes = plt.subplots(nch, 3, figsize=(10, 2.5 * nch), sharex=True)
        if nch == 1:
            axes = axes[np.newaxis, :]
        for i in range(nch):
            ch = samples[i]
            axes[i, 0].plot(ch.real)
            axes[i, 0].set_ylabel(f"Re ch{i}")
            axes[i, 1].plot(ch.imag)
            axes[i, 1].set_ylabel(f"Im ch{i}")
            axes[i, 2].plot(np.abs(ch))
            axes[i, 2].set_ylabel(f"|ch{i}|")
            axes[i, 2].set_xlabel("Sample index")
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def plot_constellation(x, ref, path: Path, title: str) -> None:
    plt = pyplot()
    x = host(x)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(x.real, x.imag, s=6, alpha=0.6, label="Equalized")
    if ref is not None:
        ref = host(ref)
        ax.scatter(ref.real, ref.imag, s=36, alpha=0.8, marker="x", label="Ideal")
    ax.set_xlabel("In-phase")
    ax.set_ylabel("Quadrature")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.set_aspect("equal", adjustable="box")
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def plot_phase_slope(h_used, path: Path, title: str, n_fft: int, num_active: int):
    """Unwrapped-phase diagnostic; returns (slope rad/bin, sto samples) from
    `ops.estimate.estimate_timing_offset_from_phase_slope` on a host copy of
    ``h_used``."""
    from ofdm_sync_tpu_torch.ops.estimate import estimate_timing_offset_from_phase_slope
    from ofdm_sync_tpu_torch.ops.waveforms import centered_subcarrier_indices

    plt = pyplot()
    h = host(h_used)
    slope, sto = estimate_timing_offset_from_phase_slope(torch.from_numpy(h), n_fft,
                                                         num_active)
    slope, sto = float(slope), float(sto)
    k = centered_subcarrier_indices(num_active).astype(float)
    phase = np.unwrap(np.angle(h))
    intercept = phase.mean() - slope * k.mean()
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(k, phase, ".", markersize=4, alpha=0.7, label="Measured phase")
    ax.plot(k, slope * k + intercept, color="tab:red", linewidth=1.5, label="Linear fit")
    ax.set_xlabel("Subcarrier index (k)")
    ax.set_ylabel("Phase [rad]")
    ax.set_title(f"{title}\nSTO ~ {sto:.2f} samples ({slope:.4f} rad/bin)")
    ax.grid(True, alpha=0.3)
    ax.legend(loc="upper left")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return slope, sto


def plot_metric(
    M,
    path: Path,
    title: str,
    vlines: list[tuple[int, str, str, str]] = (),
    extra_traces: list[tuple[np.ndarray, str, str]] = (),
    spans: list[tuple[int, int, str]] = (),
    xlabel: str = "Sample index d",
    ylabel: str = "M(d)",
) -> None:
    """Generic metric plot with marker vlines (x, color, style, label)."""
    plt = pyplot()
    fig = plt.figure(figsize=(10, 4))
    plt.plot(host(M), label=ylabel)
    for trace, label, style in extra_traces:
        plt.plot(host(trace), label=label, linestyle=style)
    for i, (s, e, label) in enumerate(spans):
        plt.axvspan(s, e, color="tab:orange", alpha=0.15, label=label if i == 0 else None)
    for x, color, style, label in vlines:
        plt.axvline(x, color=color, linestyle=style, label=label)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.title(title)
    plt.legend(loc="upper right", fontsize=8)
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close(fig)


def plot_rx_and_metric(
    rx,
    M,
    path: Path,
    title_top: str,
    title_bottom: str,
    vlines_top: list[tuple[int, str, str, str]] = (),
    vlines_bottom: list[tuple[int, str, str, str]] = (),
    spans: list[tuple[int, int, str]] = (),
) -> None:
    """Two-panel |rx| + metric detection overview (the `start_detection.png`
    artifact shape shared by every reference sim)."""
    plt = pyplot()
    rx = host(rx)
    if rx.ndim == 1:
        rx = rx[None, :]
    fig, axes = plt.subplots(2, 1, figsize=(12, 6), sharex=False)
    combined = np.sqrt(np.sum(np.abs(rx) ** 2, axis=0))
    axes[0].plot(combined, label="Combined |rx|")
    if rx.shape[0] > 1:
        for branch in rx:
            axes[0].plot(np.abs(branch), alpha=0.3, linewidth=0.8)
    for i, (s, e, label) in enumerate(spans):
        axes[0].axvspan(s, e, color="tab:orange", alpha=0.18, label=label if i == 0 else None)
    for x, color, style, label in vlines_top:
        axes[0].axvline(x, color=color, linestyle=style, label=label)
    axes[0].set_ylabel("Magnitude")
    axes[0].set_title(title_top)
    axes[0].legend(loc="upper right", fontsize=8)

    axes[1].plot(host(M))
    for s, e, label in spans:
        axes[1].axvspan(s, e, color="tab:orange", alpha=0.12)
    for x, color, style, label in vlines_bottom:
        axes[1].axvline(x, color=color, linestyle=style, label=label)
    axes[1].set_xlabel("Sample index d")
    axes[1].set_ylabel("M(d)")
    axes[1].set_title(title_bottom)
    axes[1].legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def plot_ls_cir(
    ls_cir,
    cir,
    channel_peak_offset: int,
    timing_error: int,
    path: Path,
    title: str,
) -> None:
    """LS-derived CIR vs measured CIR (reference minn.py:222-285)."""
    plt = pyplot()
    ls_cir = host(ls_cir)
    mag = np.abs(ls_cir)
    ls_peak = int(np.argmax(mag))
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(mag, label="LS CIR |h|", color="tab:blue")
    ax.axvline(ls_peak, color="tab:red", linestyle=":", label=f"LS peak @ {ls_peak}")
    notes = [f"Timing error: {timing_error} samples"]
    if cir is not None:
        cir = host(cir)
        if cir.ndim == 1:
            cir = cir[None, :]
        agg = np.sqrt(np.sum(np.abs(cir) ** 2, axis=0))
        ax.plot(agg, label="Measured CIR |h|", color="tab:green", alpha=0.7)
        ax.axvline(
            channel_peak_offset,
            color="tab:olive",
            linestyle="--",
            label=f"Measured peak @ {channel_peak_offset}",
        )
        n = ls_cir.size
        diff = ls_peak - channel_peak_offset
        if diff > n // 2:
            diff -= n
        elif diff < -n // 2:
            diff += n
        notes.append(f"Peak shift vs measured: {diff} taps")
    else:
        notes.append(f"LS peak index: {ls_peak}")
    ax.text(
        0.02, 0.95, "\n".join(notes), transform=ax.transAxes, ha="left", va="top",
        fontsize=9, bbox=dict(boxstyle="round,pad=0.3", fc="white", alpha=0.6),
    )
    ax.set_xlabel("Tap index")
    ax.set_ylabel("Magnitude")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
