"""[A][A] detector single tests and grid sweeps (port of
`ofdm_sync_tpu.pipelines.aa`; reference sync_aa.py:648-1123).

Three execution paths:

* `run_single_test` / `run_grid_test`: the serial harness (same seeds, same
  prints as the reference), detecting with `AADetector.detect`;
* `run_grid_test_batched`: the whole SNR x full-scale grid of one channel
  and preamble length as one quantized batch, each config detected in
  plain PyTorch (`ops.metrics.aa_metric`, `ops.detect.extract_gate_events`;
  JAX's vmapped XLA sweep);
* `run_grid_test_fused`: the same batch, detected by ONE `aa_detect_fused`
  call (kernels C + B on a card).

The sweeps' noise comes from a CPU `torch.Generator` seeded with ``seed``
and is moved to the device, so one seed gives the same grid on a card and
on the CPU, and the batched and fused sweeps see the same batch.  The JAX
package draws it from `jax.random` keys, which the port cannot reproduce:
the two grids agree in distribution, and the tests hold the port's
detection to JAX's on the same quantized batch.

`main()` prints the preambles' PAPR, writes the preamble-design and metric
plots, runs the serial grid, prints its summary and writes the heatmap;
``main(plots=False)`` skips every plot and needs no matplotlib.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.kernels.aa_fused import aa_detect_fused
from ofdm_sync_tpu_torch.models.detectors import AADetector
from ofdm_sync_tpu_torch.ops.channel import (
    apply_cfo,
    apply_channel_multi_antenna,
    apply_cir,
    awgn_noise_device,
    compute_channel_peak_offset,
    compute_clipping_stats,
    load_measured_cir,
    quantize_adc,
)
from ofdm_sync_tpu_torch.ops.detect import extract_gate_events
from ofdm_sync_tpu_torch.ops.metrics import aa_metric
from ofdm_sync_tpu_torch.ops.waveforms import (
    AA_PREAMBLE_LENGTHS,
    assemble_frame,
    build_aa_preamble,
    build_aa_qpsk_symbol,
)
from ofdm_sync_tpu_torch.params import AADetectorParams, SYS_AA_10M
from ofdm_sync_tpu_torch.pipelines.common import PLOTS_ROOT
from ofdm_sync_tpu_torch.utils import report

SYS = SYS_AA_10M
PLOTS_DIR = PLOTS_ROOT / "sync_aa"
#: threshold / hysteresis shared by all paths
_GRID_PARAMS = AADetectorParams()


@dataclass
class TestResult:
    """Per-config result (reference sync_aa.py:651-666)."""

    snr_db: float
    channel: str
    full_scale_ratio: float
    preamble_length: int
    timing_error: int
    cfo_applied_hz: float
    cfo_estimated_hz: float
    cfo_error_hz: float
    detected: bool
    num_events: int
    clipping_pct: float
    effective_bits: float
    metric_peak: float


def run_single_test(
    snr_db: float,
    channel_name: str | None,
    full_scale_ratio: float,
    preamble_length: int = 1024,
    cfo_hz: float = 500.0,
    seed: int = 42,
    plot: bool = False,
    plot_dir: Path | None = None,
    device: torch.device | str | None = None,
) -> TestResult:
    """One sync test: frame -> channel -> CFO -> 12-bit ADC -> detect
    (reference sync_aa.py:669-823).  With ``plot`` and ``plot_dir``, writes
    the config's |rx| / M / |P|^2 view there."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    channel_str = channel_name if channel_name else "awgn"

    preamble, _, _ = build_aa_preamble(preamble_length, SYS)
    pilot_symbol, _ = build_aa_qpsk_symbol(rng, SYS)
    data_symbol, _ = build_aa_qpsk_symbol(rng, SYS)
    tx = assemble_frame(preamble, pilot_symbol, data_symbol, pre_pad=SYS.tx_pre_pad,
                        post_pad=500)
    rx, _cir, channel_peak_offset = apply_channel_multi_antenna(
        tx, snr_db, rng, channel_name, num_rx_antennas=2, device=dev)
    true_preamble_start = SYS.tx_pre_pad + channel_peak_offset
    rx = apply_cfo(torch.as_tensor(rx, device=dev).to(torch.complex64), cfo_hz,
                   SYS.sample_rate_hz)

    # full scale and clipping from the complex64 samples on the host, as
    # the JAX harness takes them
    rx_host = rx.cpu().numpy()
    full_scale = np.sqrt(np.mean(np.abs(rx_host) ** 2)) * full_scale_ratio
    clip_stats = compute_clipping_stats(rx_host.flatten(), full_scale)
    rx_q = quantize_adc(rx, float(full_scale))

    det = AADetector(SYS, AADetectorParams(preamble_len=preamble_length))
    state, result = det.detect(rx_q)
    best = AADetector.best(result)
    if best is not None:
        detected = True
        timing_error = best.detected_start - true_preamble_start
        cfo_estimated = best.cfo_hz
        metric_peak = best.metric_at_peak
        num_events = len(result.events)
    else:
        detected = False
        timing_error = 0
        cfo_estimated = 0.0
        metric_peak = float(state.M.max()) if bool(state.valid.any()) else 0.0
        num_events = 0

    if plot and plot_dir is not None:
        _plot_single(rx_q, state, result, best, det.params.threshold, true_preamble_start,
                     channel_str, snr_db, full_scale_ratio, preamble_length, plot_dir)

    return TestResult(
        snr_db=snr_db,
        channel=channel_str,
        full_scale_ratio=full_scale_ratio,
        preamble_length=preamble_length,
        timing_error=timing_error,
        cfo_applied_hz=cfo_hz,
        cfo_estimated_hz=cfo_estimated,
        cfo_error_hz=cfo_estimated - cfo_hz if detected else cfo_hz,
        detected=detected,
        num_events=num_events,
        clipping_pct=clip_stats["total_clip_pct"],
        effective_bits=clip_stats["effective_bits"],
        metric_peak=metric_peak,
    )


def _plot_single(rx_q, state, result, best, threshold: float, true_preamble_start: int,
                 channel_str: str, snr_db: float, full_scale_ratio: float,
                 preamble_length: int, plot_dir: Path) -> None:
    """One config's |rx|, M with the gates and |P|^2, each beside the true
    and detected positions (the reference's plots/sync_aa/<channel>/)."""
    plt = report.pyplot()
    plot_dir.mkdir(parents=True, exist_ok=True)
    L = preamble_length // 2
    detected = best is not None
    fig, axes = plt.subplots(3, 1, figsize=(12, 9), sharex=True)
    rx_mag = np.sqrt(np.sum(np.abs(report.host(rx_q)) ** 2, axis=0))
    axes[0].plot(rx_mag, alpha=0.7)
    axes[0].axvline(true_preamble_start, color="g", linestyle="--", label="True start")
    if detected:
        axes[0].axvline(best.detected_start, color="r", linestyle=":", label="Detected")
    axes[0].set_ylabel("|rx|")
    axes[0].set_title(f"{channel_str.upper()}, SNR={snr_db}dB, FS={full_scale_ratio}x, L={L}")
    axes[0].legend()
    axes[0].grid(True, alpha=0.3)
    axes[1].plot(report.host(state.M), label="M[n]")
    axes[1].axhline(threshold, color="orange", linestyle="--", label="Threshold")
    expected_peak = true_preamble_start + 2 * L - 1
    axes[1].axvline(expected_peak, color="g", linestyle="--", label="Expected peak")
    if detected:
        axes[1].axvline(best.peak_index, color="r", linestyle=":")
        for evt in result.events:
            axes[1].axvspan(evt.gate_start, evt.gate_end, alpha=0.2, color="orange")
    axes[1].set_ylabel("Metric")
    axes[1].set_ylim(-0.1, 1.1)
    axes[1].legend()
    axes[1].grid(True, alpha=0.3)
    axes[2].plot(np.abs(report.host(state.P)) ** 2, label="|P|^2")
    axes[2].axvline(expected_peak, color="g", linestyle="--", label="Expected peak")
    if detected:
        axes[2].axvline(best.peak_index, color="r", linestyle=":", label="Detected peak")
    axes[2].set_ylabel("|P|^2")
    axes[2].set_xlabel("Sample")
    axes[2].legend()
    axes[2].grid(True, alpha=0.3)
    plt.tight_layout()
    stem = f"{channel_str}_snr{snr_db:+.0f}dB_fs{full_scale_ratio:.2f}"
    plt.savefig(plot_dir / f"{stem}_L{L}.png", dpi=120)
    if preamble_length == 1024:
        # the reference tree carries the default-length condition under both
        # namings (e.g. cir1_snr+10dB_fs1.00.png and ..._L512.png)
        plt.savefig(plot_dir / f"{stem}.png", dpi=120)
    plt.close()


def run_grid_test(
    snr_values=(-5, 0, 5, 10, 15),
    channels=(None, "cir1", "cir2"),
    full_scale_ratios=(0.25, 0.5, 1.0, 1.5, 2.0),
    preamble_lengths=AA_PREAMBLE_LENGTHS,
    cfo_hz: float = 500.0,
    plot_samples: bool = False,
    device: torch.device | str | None = None,
) -> list[TestResult]:
    """Serial parity grid (reference sync_aa.py:829-899); with
    ``plot_samples`` the full-scale 1.0, L = 512 configs are plotted under
    ``plots/sync_aa/<channel>/``."""
    results: list[TestResult] = []
    total = len(snr_values) * len(channels) * len(full_scale_ratios) * len(preamble_lengths)
    report.banner("[A][A] PREAMBLE SYNCHRONIZATION - GRID TEST")
    print(f"Total tests: {total}")
    test_num = 0
    for preamble_len in preamble_lengths:
        L = preamble_len // 2
        print(f"\n--- Preamble Length: {preamble_len} samples (L={L}) ---")
        for channel in channels:
            channel_str = channel if channel else "awgn"
            for snr_db in snr_values:
                for fs_ratio in full_scale_ratios:
                    test_num += 1
                    do_plot = plot_samples and fs_ratio == 1.0 and preamble_len == 1024
                    r = run_single_test(
                        snr_db=snr_db, channel_name=channel, full_scale_ratio=fs_ratio,
                        preamble_length=preamble_len, cfo_hz=cfo_hz, seed=42,
                        plot=do_plot, plot_dir=PLOTS_DIR / channel_str, device=device)
                    results.append(r)
                    status = "OK " if r.detected else "MISS"
                    print(
                        f"[{test_num:3d}/{total}] L={L:3d} {channel_str:6s} "
                        f"SNR={snr_db:+3.0f}dB FS={fs_ratio:.2f}x -> {status} "
                        f"timing_err={r.timing_error:+4d} "
                        f"cfo_err={r.cfo_error_hz:+7.1f}Hz "
                        f"clip={r.clipping_pct:5.1f}%"
                    )
    return results


# ---------------------------------------------------------------------------
# The grid sweeps: one quantized batch, detected config by config in plain
# PyTorch (batched) or in one detection call (fused)
# ---------------------------------------------------------------------------

def _grid_clean_stream(preamble_length: int, channel_name: str | None, seed: int, device):
    """Shared TX/channel synthesis of the grid sweep: returns (clean rx
    complex64 (2 antennas, n) on ``device``, true start, L)."""
    rng = np.random.default_rng(seed)
    L = preamble_length // 2
    preamble, _, _ = build_aa_preamble(preamble_length, SYS)
    pilot, _ = build_aa_qpsk_symbol(rng, SYS)
    data, _ = build_aa_qpsk_symbol(rng, SYS)
    tx = assemble_frame(preamble, pilot, data, pre_pad=SYS.tx_pre_pad, post_pad=500)
    if channel_name is None:
        rx_clean = torch.as_tensor(np.stack([tx, tx]), device=device).to(torch.complex64)
        peak_off = 0
    else:
        cir = load_measured_cir(channel_name)[:2]
        rx_clean = apply_cir(tx, cir, device)
        peak_off = compute_channel_peak_offset(cir)
    return rx_clean, SYS.tx_pre_pad + peak_off, L


def _grid_batch(x: torch.Tensor, snr_values, full_scale_ratios, cfo_hz: float,
                seed: int) -> torch.Tensor:
    """Every (snr, full-scale) config's quantized stream as one planar batch
    on x's device: on-device AWGN (from a CPU generator seeded with
    ``seed``), CFO, 12-bit ADC at ``rms * ratio`` (reference
    sync_aa.py:712-735).  Returns channel-leading float32
    (2 * antennas, n_snr * n_fs, n), configs in row-major (snr, fs) order."""
    dev = x.device
    snr = torch.as_tensor(snr_values, dtype=torch.float32, device=dev)
    fs = torch.as_tensor(full_scale_ratios, dtype=torch.float32, device=dev)
    snr_grid, fs_grid = torch.meshgrid(snr, fs, indexing="ij")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    noise = awgn_noise_device(x, snr_grid.reshape(-1), gen)   # (ncfg, BR, n)
    rx = apply_cfo(x + noise, cfo_hz, SYS.sample_rate_hz)
    rms = torch.sqrt((rx.abs() ** 2).mean(dim=(-2, -1), keepdim=True))
    rx_q = quantize_adc(rx, rms * fs_grid.reshape(-1, 1, 1))
    ncfg, br, n = rx_q.shape
    planar = torch.view_as_real(rx_q)                            # (ncfg, BR, n, 2)
    return planar.permute(1, 3, 0, 2).reshape(2 * br, ncfg, n).contiguous()


def _fused_detect(iq: torch.Tensor, L: int) -> dict[str, np.ndarray]:
    """ONE fused detection over the grid batch; per config the strongest
    event by M at its peak.  Returns host arrays of shape (ncfg,)."""
    fs_hz = SYS.sample_rate_hz
    table, P_pk, M_pk = aa_detect_fused(
        iq, half_len=L, threshold=_GRID_PARAMS.threshold,
        hysteresis=_GRID_PARAMS.hysteresis, max_events=8)
    score = torch.where(table.valid, M_pk, float("-inf"))
    best = torch.argmax(score, dim=-1, keepdim=True)
    take = lambda a: a.gather(-1, best)[:, 0].cpu().numpy()  # noqa: E731
    peak_idx = take(table.peak_idx)
    p_re = take(P_pk[:, 0]).astype(np.float64)
    p_im = take(P_pk[:, 1]).astype(np.float64)
    return {
        "detected": table.count.cpu().numpy() > 0,
        "frame_start": peak_idx - 2 * L + 1,
        "cfo_est": np.arctan2(p_im, p_re) * fs_hz / (2 * math.pi * L),
        "metric_peak": take(M_pk),
        "num_events": table.count.cpu().numpy(),
    }


def _batched_single(rx_q: torch.Tensor, L: int, threshold: float, hysteresis: int
                    ) -> tuple[torch.Tensor, ...]:
    """One config's quantized stream (branches, n) complex64 through the
    plain detector (JAX `_batched_single`): M >= threshold gates, the peak
    tracked on |P|^2, the strongest event by M at its peak.  Returns 0-d
    tensors (detected, peak index, P at the peak, M at the peak, events)."""
    state = aa_metric(rx_q, L)
    above = state.valid & (state.M >= threshold)
    table = extract_gate_events(above, state.P.abs() ** 2, hysteresis=hysteresis,
                                max_events=8, tie="first", emit_unclosed=True)
    M_at_peak = state.M[table.peak_idx.long()] * table.valid
    best = torch.argmax(M_at_peak)
    peak_idx = table.peak_idx[best]
    return table.count > 0, peak_idx, state.P[peak_idx.long()], M_at_peak[best], table.count


def _batched_detect(iq: torch.Tensor, L: int) -> dict[str, np.ndarray]:
    """Each config of the planar grid batch (2 * branches, ncfg, n) as
    complex64 (exact: the quantized samples are float32), detected by
    `_batched_single`.  Returns host arrays of shape (ncfg,)."""
    c2, ncfg, n = iq.shape
    planes = iq.reshape(c2 // 2, 2, ncfg, n)
    rx_q = torch.complex(planes[:, 0], planes[:, 1]).permute(1, 0, 2)  # (ncfg, BR, n)
    cols = [torch.stack(v) for v in zip(*(
        _batched_single(rx_q[c], L, _GRID_PARAMS.threshold, _GRID_PARAMS.hysteresis)
        for c in range(ncfg)))]
    detected, peak_idx, P_peak, metric_peak, count = (v.cpu().numpy() for v in cols)
    P_peak = P_peak.astype(np.complex128)
    return {
        "detected": detected,
        "frame_start": peak_idx - 2 * L + 1,
        "cfo_est": np.arctan2(P_peak.imag, P_peak.real) * SYS.sample_rate_hz / (2 * math.pi * L),
        "metric_peak": metric_peak,
        "num_events": count,
    }


def _grid_outputs(out, shape, true_start, cfo_hz, snr_values, full_scale_ratios):
    out = {k: np.asarray(v).reshape(shape) for k, v in out.items()}
    out["timing_error"] = out["frame_start"] - true_start
    out["cfo_error"] = out["cfo_est"] - cfo_hz
    out["snr_values"] = np.asarray(snr_values)
    out["full_scale_ratios"] = np.asarray(full_scale_ratios)
    return out


def run_grid_test_batched(
    preamble_length: int = 1024,
    channel_name: str | None = None,
    snr_values=(-5.0, 0.0, 5.0, 10.0, 15.0),
    full_scale_ratios=(0.25, 0.5, 1.0, 1.5, 2.0),
    cfo_hz: float = 500.0,
    seed: int = 42,
    device: torch.device | str | None = None,
) -> dict[str, np.ndarray]:
    """The plain sweep: the (snr x full_scale) grid's quantized batch (the
    same as `run_grid_test_fused`'s for the same arguments), each config
    detected by the plain [A][A] metric and gate/peak extraction on
    ``device``.  Returns the same dict of (n_snr, n_fs) arrays as
    `run_grid_test_fused`."""
    dev = resolve_device(device)
    x, true_start, L = _grid_clean_stream(preamble_length, channel_name, seed, dev)
    iq = _grid_batch(x, snr_values, full_scale_ratios, cfo_hz, seed)
    out = _batched_detect(iq, L)
    return _grid_outputs(out, (len(snr_values), len(full_scale_ratios)), true_start,
                         cfo_hz, snr_values, full_scale_ratios)


def run_grid_test_fused(
    preamble_length: int = 1024,
    channel_name: str | None = None,
    snr_values=(-5.0, 0.0, 5.0, 10.0, 15.0),
    full_scale_ratios=(0.25, 0.5, 1.0, 1.5, 2.0),
    cfo_hz: float = 500.0,
    seed: int = 42,
    device: torch.device | str | None = None,
) -> dict[str, np.ndarray]:
    """The production sweep: the entire (snr x full_scale) grid detected by
    ONE fused detection call.  Returns a dict of (n_snr, n_fs) arrays:
    detected, frame_start, cfo_est, metric_peak, num_events, timing_error,
    cfo_error (plus the swept values)."""
    dev = resolve_device(device)
    x, true_start, L = _grid_clean_stream(preamble_length, channel_name, seed, dev)
    iq = _grid_batch(x, snr_values, full_scale_ratios, cfo_hz, seed)
    out = _fused_detect(iq, L)
    return _grid_outputs(out, (len(snr_values), len(full_scale_ratios)), true_start,
                         cfo_hz, snr_values, full_scale_ratios)


# ---------------------------------------------------------------------------
# Reporting (reference sync_aa.py:902-1069)
# ---------------------------------------------------------------------------

def print_summary_table(results: list[TestResult]) -> None:
    report.banner("SUMMARY TABLE")
    preamble_lengths = sorted({r.preamble_length for r in results}, reverse=True)
    channels = sorted({r.channel for r in results})
    snr_values = sorted({r.snr_db for r in results})
    fs_ratios = sorted({r.full_scale_ratio for r in results})

    for plen in preamble_lengths:
        L = plen // 2
        report.banner(f"PREAMBLE LENGTH: {plen} samples (L={L})")
        for channel in channels:
            print(f"\n--- {channel.upper()} ---")
            print(f"{'SNR':>6s}", end="")
            for f in fs_ratios:
                print(f" | FS={f:.2f}", end="")
            print()
            print("-" * (8 + 10 * len(fs_ratios)))
            for snr in snr_values:
                print(f"{snr:+5.0f}dB", end="")
                for f in fs_ratios:
                    match = [
                        r for r in results
                        if r.channel == channel and r.snr_db == snr
                        and r.full_scale_ratio == f and r.preamble_length == plen
                    ]
                    if match:
                        r = match[0]
                        print(f" | {r.timing_error:+5d}" if r.detected else " |  MISS", end="")
                    else:
                        print(" |   N/A", end="")
                print()

    report.banner("DETECTION RATE BY PREAMBLE LENGTH AND CHANNEL")
    for plen in preamble_lengths:
        print(f"\nPreamble L={plen // 2}:")
        for channel in channels:
            rs = [r for r in results if r.channel == channel and r.preamble_length == plen]
            det = sum(1 for r in rs if r.detected)
            pct = 100 * det / len(rs) if rs else 0
            print(f"  {channel:6s}: {det}/{len(rs)} ({pct:.0f}%)")

    report.banner("TIMING ERROR STATISTICS BY PREAMBLE LENGTH (detected only)")
    for plen in preamble_lengths:
        rs = [r for r in results if r.detected and r.preamble_length == plen]
        if rs:
            errs = [r.timing_error for r in rs]
            print(f"\nPreamble L={plen // 2}:")
            print(f"  Mean:   {np.mean(errs):+.1f} samples")
            print(f"  Std:    {np.std(errs):.1f} samples")
            print(f"  Range:  [{np.min(errs):+d}, {np.max(errs):+d}]")
            within = sum(1 for e in errs if abs(e) <= SYS.cp_len)
            print(f"  Within CP ({SYS.cp_len}): {within}/{len(errs)}")

    report.banner("CFO ERROR STATISTICS BY PREAMBLE LENGTH (detected only)")
    for plen in preamble_lengths:
        rs = [r for r in results if r.detected and r.preamble_length == plen]
        if rs:
            errs = [r.cfo_error_hz for r in rs]
            print(f"\nPreamble L={plen // 2}:")
            print(f"  Mean:   {np.mean(errs):+.1f} Hz")
            print(f"  Std:    {np.std(errs):.1f} Hz")
            print(f"  Range:  [{np.min(errs):+.1f}, {np.max(errs):+.1f}] Hz")


# ---------------------------------------------------------------------------
# Plots (reference sync_aa.py:994-1069 and its preamble artifacts)
# ---------------------------------------------------------------------------

def plot_heatmaps(results: list[TestResult]) -> None:
    """Success/fail + timing-error heatmaps per (preamble length, channel)
    (reference sync_aa.py:994-1069)."""
    plt = report.pyplot()
    preamble_lengths = sorted({r.preamble_length for r in results}, reverse=True)
    channels = sorted({r.channel for r in results})
    snr_values = sorted({r.snr_db for r in results})
    fs_ratios = sorted({r.full_scale_ratio for r in results})
    n_rows, n_cols = len(preamble_lengths), len(channels)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(6 * n_cols, 4 * n_rows))
    axes = np.atleast_2d(axes)
    for i, plen in enumerate(preamble_lengths):
        for j, channel in enumerate(channels):
            grid = np.full((len(snr_values), len(fs_ratios)), np.nan)
            for r in results:
                if r.preamble_length == plen and r.channel == channel:
                    si = snr_values.index(r.snr_db)
                    fi = fs_ratios.index(r.full_scale_ratio)
                    grid[si, fi] = abs(r.timing_error) if r.detected else np.nan
            ax = axes[i, j]
            im = ax.imshow(grid, aspect="auto", origin="lower", cmap="viridis")
            ax.set_xticks(range(len(fs_ratios)))
            ax.set_xticklabels([f"{f:.2f}" for f in fs_ratios])
            ax.set_yticks(range(len(snr_values)))
            ax.set_yticklabels([f"{s:+.0f}" for s in snr_values])
            ax.set_xlabel("Full-scale ratio")
            ax.set_ylabel("SNR (dB)")
            ax.set_title(f"L={plen // 2}, {channel} (|timing err|, blank=miss)")
            fig.colorbar(im, ax=ax)
    PLOTS_DIR.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(PLOTS_DIR / "detection_heatmap.png", dpi=120)
    plt.close(fig)


def plot_preamble_design() -> None:
    """Time/spectrum/autocorrelation views of the three [A][A] preamble
    lengths (reference sync_aa.py's preamble_design.png artifact)."""
    plt = report.pyplot()
    fig, axes = plt.subplots(3, len(AA_PREAMBLE_LENGTHS), figsize=(5 * len(AA_PREAMBLE_LENGTHS), 9))
    for j, total in enumerate(AA_PREAMBLE_LENGTHS):
        pre, _, papr = build_aa_preamble(total, SYS)
        L = total // 2
        axes[0, j].plot(np.abs(pre), linewidth=0.7)
        axes[0, j].set_title(f"L={L}: |x(t)|, PAPR {papr:.2f} dB")
        spec = np.fft.fftshift(np.abs(np.fft.fft(pre, SYS.n_fft)))
        axes[1, j].plot(spec, linewidth=0.7)
        axes[1, j].set_title("Spectrum magnitude")
        lag = np.correlate(pre, pre, mode="full")
        axes[2, j].plot(np.arange(-total + 1, total), np.abs(lag) / np.abs(lag).max(),
                        linewidth=0.7)
        axes[2, j].set_title("Autocorrelation (note the lag-L [A][A] peak)")
        for ax in axes[:, j]:
            ax.grid(True, alpha=0.4)
    PLOTS_DIR.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(PLOTS_DIR / "preamble_design.png", dpi=110)
    plt.close(fig)


def _host_metric(sig: np.ndarray, L: int) -> tuple[np.ndarray, np.ndarray]:
    """M and |P|^2 of a noise-free stream, from the plain metric on the CPU."""
    st = aa_metric(torch.as_tensor(sig).to(torch.complex64), L)
    return st.M.numpy(), np.abs(st.P.numpy()) ** 2


def plot_metric_zoom_no_noise(total_length: int = 1024) -> None:
    """Noise-free metric around the plateau: M, |P|^2 and the peak position
    (reference sync_aa.py's metric_zoom_no_noise.png artifact, illustrating
    why the peak tracks |P|^2 rather than the flat-topped M)."""
    plt = report.pyplot()
    L = total_length // 2
    pre, _, _ = build_aa_preamble(total_length, SYS)
    sig = np.concatenate([np.zeros(SYS.tx_pre_pad), pre, np.zeros(2 * L)]).astype(complex)
    M, p_sq = _host_metric(sig, L)
    peak = int(np.argmax(p_sq))
    lo, hi = max(0, peak - 3 * L), min(M.size, peak + 2 * L)
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(11, 7), sharex=True)
    a1.plot(range(lo, hi), M[lo:hi], linewidth=0.9)
    a1.axvline(peak, linestyle="--", linewidth=0.8, color="tab:red")
    a1.set_ylabel("M = |P|^2 / R^2")
    a1.set_title(f"Noise-free metric zoom, L={L} (plateau top is flat)")
    a1.grid(True, alpha=0.4)
    a2.plot(range(lo, hi), p_sq[lo:hi] / p_sq[peak], linewidth=0.9, color="tab:orange")
    a2.axvline(peak, linestyle="--", linewidth=0.8, color="tab:red",
               label=f"peak @ {peak} -> frame start {peak - 2 * L + 1}")
    a2.set_ylabel("|P|^2 (normalized)")
    a2.set_xlabel("Sample offset")
    a2.grid(True, alpha=0.4)
    a2.legend()
    PLOTS_DIR.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(PLOTS_DIR / "metric_zoom_no_noise.png", dpi=110)
    plt.close(fig)


def plot_plateau_vs_peak(total_length: int = 1024) -> None:
    """Why the detector peaks on |P|^2 instead of ending the M plateau:
    with a pilot symbol following the preamble, the M plateau's trailing
    edge is dragged out by pilot correlation, while the |P|^2 peak stays put
    (reference sync_aa.py's plateau_vs_peak/plateau_vs_pilot artifacts)."""
    plt = report.pyplot()
    L = total_length // 2
    rng = np.random.default_rng(0)
    pre, _, _ = build_aa_preamble(total_length, SYS)
    pilot, _ = build_aa_qpsk_symbol(rng, SYS)
    fig, axes = plt.subplots(2, 1, figsize=(11, 7), sharex=True)
    for ax, (label, tail) in zip(
            axes, [("preamble then silence", np.zeros(2 * L, complex)),
                   ("preamble then pilot symbol", pilot[: 2 * L])]):
        sig = np.concatenate([np.zeros(SYS.tx_pre_pad), pre, tail]).astype(complex)
        M, p_sq = _host_metric(sig, L)
        peak = int(np.argmax(p_sq))
        ax.plot(M, linewidth=0.8, label="M")
        ax.plot(p_sq / max(p_sq.max(), 1e-12), linewidth=0.8, label="|P|^2 (norm)")
        ax.axvline(peak, linestyle="--", linewidth=0.8, color="tab:red",
                   label=f"|P|^2 peak @ {peak}")
        ax.set_title(label)
        ax.grid(True, alpha=0.4)
        ax.legend()
    axes[1].set_xlabel("Sample offset")
    PLOTS_DIR.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(PLOTS_DIR / "plateau_vs_peak_comparison.png", dpi=110)
    plt.close(fig)


def main(device: torch.device | str | None = None, plots: bool = True) -> None:
    """The PAPR report, the preamble and metric plots, the serial 135-config
    grid on ``device``, its summary and the heatmap (reference
    sync_aa.py:1075-1123).  ``plots=False`` writes no plot."""
    report.banner("[A][A] PREAMBLE SYNC - PAPR REPORT")
    for total in AA_PREAMBLE_LENGTHS:
        pre, _, papr = build_aa_preamble(total, SYS)
        half = total // 2
        corr = np.vdot(pre[:half], pre[half:]).real / half
        print(f"L={half}: PAPR={papr:.2f} dB, [A][A] corr={corr:.3f}")
    if plots:
        plot_preamble_design()
        plot_metric_zoom_no_noise()
        plot_plateau_vs_peak()
    results = run_grid_test(device=device)
    print_summary_table(results)
    if plots:
        plot_heatmaps(results)


if __name__ == "__main__":
    main()
