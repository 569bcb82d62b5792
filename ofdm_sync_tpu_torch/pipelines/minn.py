"""Standard Minn simulation and block-length sweep (port of
`ofdm_sync_tpu.pipelines.minn`; reference minn.py:300-1026), with the
block-length comparison plots (`plot_block_length_comparison`).

Run: ``python -m ofdm_sync_tpu_torch minn [--device cpu] [--no-plots]``.  The detector
D2 has no kernel: the run is plain PyTorch on ``device`` (the card unless
the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.models.detectors import MinnDetector
from ofdm_sync_tpu_torch.ops.detect import mask_segments
from ofdm_sync_tpu_torch.ops.waveforms import build_minn_preamble
from ofdm_sync_tpu_torch.params import SYS_30M72, MinnDetectorParams
from ofdm_sync_tpu_torch.pipelines import common
from ofdm_sync_tpu_torch.utils import report

SNR_DB = 0.0
CFO_HZ = 1000.0
THRESH_FRAC = 0.10  # the RTL-style energy threshold (reference minn.py:396-415)
DETECTOR = "minn"


def run_simulation(channel_name: str | None, plots_subdir: str | None = None,
                   device: torch.device | str | None = None) -> dict:
    """One seeded run (seed 0): Minn preamble -> channel (the first two RX
    branches of a measured CIR) -> CFO -> Minn peak -> CFO / LS EQ / EVM,
    with the RTL-style energy-threshold analysis; prints the reference's
    report and returns its numbers.  With ``plots_subdir`` the reference's
    plots go to ``plots/minn/<plots_subdir>/``."""
    sys = SYS_30M72
    rng = np.random.default_rng(0)
    params = MinnDetectorParams()
    plots_dir = common.make_plots_dir(DETECTOR, plots_subdir) if plots_subdir else None

    preamble = build_minn_preamble(rng, sys, include_cp=True)
    setup = common.build_setup(
        preamble, rng, sys=sys, channel_name=channel_name, cir_mode="two",
        snr_db=SNR_DB, cfo_hz=CFO_HZ, device=resolve_device(device))

    out = MinnDetector(sys, params).detect(setup.rx)
    peak_position = out["peak"]
    detected_start = peak_position
    gate_segments = mask_segments(out["gate_mask"])
    expected_n_start = setup.true_cp_start + sys.cp_len
    timing_error = detected_start - expected_n_start

    # RTL-style energy-threshold analysis (reference minn.py:393-415)
    P, R = report.host(out["P"]), report.host(out["R"])
    corr_raw = np.clip(P.real, 0, None) ** 2
    energy_thresh = THRESH_FRAC * (R ** 2)
    peak_corr = corr_raw[peak_position] if peak_position < len(corr_raw) else 0
    peak_thresh = energy_thresh[peak_position] if peak_position < len(energy_thresh) else 1
    peak_ratio = peak_corr / peak_thresh if peak_thresh > 0 else 0
    mask = np.ones(len(corr_raw), dtype=bool)
    mask[max(0, peak_position - 300): min(len(corr_raw), peak_position + 300)] = False
    mask[: sys.tx_pre_pad] = False
    sidelobe_max = float(corr_raw[mask].max()) if mask.any() else 0.0
    sidelobe_ratio = sidelobe_max / peak_thresh if peak_thresh > 0 else 0

    if plots_dir is not None:
        report.plot_metric(
            out["M"], plots_dir / "minn_metric.png",
            f"Minn Metric & Gate - {setup.channel_desc}",
            vlines=[
                (peak_position, "tab:red", ":", f"Minn peak @ {peak_position}"),
                (expected_n_start, "tab:green", "--", "Expected N start"),
            ],
            extra_traces=[(out["M_smooth"], "Minn M_s(d) (smoothed)", "--")],
            spans=[(s, e, "Minn gate") for s, e in gate_segments],
        )
        max_corr = corr_raw.max() if corr_raw.max() > 0 else 1
        report.plot_metric(
            corr_raw / max_corr, plots_dir / "minn_energy_thresh.png",
            f"Minn Raw Correlation with Energy Threshold - {setup.channel_desc}\n"
            f"Peak/Thresh={peak_ratio:.1f}x, Sidelobe/Thresh={sidelobe_ratio:.1f}x",
            vlines=[
                (peak_position, "tab:red", ":", f"Peak @ {peak_position}"),
                (expected_n_start, "tab:green", "--", "Expected N start"),
            ],
            extra_traces=[(energy_thresh / max_corr, f"Threshold ({THRESH_FRAC:.0%} x R^2)",
                           "--")],
            ylabel="Normalized value",
        )
        report.plot_rx_and_metric(
            setup.rx, out["M"], plots_dir / "start_detection.png",
            f"Received Magnitude and Detected Start (Minn, {setup.channel_desc})",
            "Timing Metrics (Minn)",
            vlines_top=[
                (setup.true_cp_start, "tab:purple", "--", "Preamble CP start"),
                (expected_n_start, "tab:green", "--", "Preamble N start"),
                (detected_start, "tab:red", ":", "Detected start"),
            ],
            vlines_bottom=[
                (peak_position, "tab:red", ":", f"Peak @ {peak_position}"),
                (expected_n_start, "tab:green", "--", "Expected N start"),
            ],
            spans=[(s, e, "Minn gate") for s, e in gate_segments],
        )
        common.emit_standard_artifacts(setup, plots_dir, "Minn")

    post = common.post_detection_chain(setup, detected_start, plots_dir, "Minn")
    if plots_dir is not None:
        common.emit_ls_cir_artifact(setup, post, timing_error, plots_dir, "Minn")

    common.print_common_header(setup, "MINN SYNCHRONIZATION RESULTS")
    print("\nTiming Detection:")
    print(f"  Detected Minn peak at d={peak_position}")
    print(f"  Expected N start at d={expected_n_start}")
    print(f"  Timing error: {timing_error} samples "
          f"({abs(timing_error) / sys.n_fft * 100:.1f}% of symbol)")
    if gate_segments:
        print(f"  Minn gate window: [{gate_segments[0][0]}, {gate_segments[-1][1]}) "
              f"(threshold >={params.gate_threshold:.0%} of Minn peak, "
              f"span {gate_segments[-1][1] - gate_segments[0][0]} samples)")
    else:
        print("  Minn gate not triggered (metric never exceeded threshold)")
    common.print_cfo_block(CFO_HZ, post.cfo_est_hz)
    common.print_eq_block(post)
    if plots_dir is not None:
        print(f"\nPlots saved to {plots_dir.resolve()}/")
    print(report.BANNER + "\n")
    return {
        "peak": peak_position,
        "timing_error": timing_error,
        "cfo_est_hz": post.cfo_est_hz,
        "evm_rms": post.evm_rms,
        "evm_db": post.evm_db,
        "peak_ratio": peak_ratio,
        "sidelobe_ratio": sidelobe_ratio,
    }


def compare_block_lengths(
    block_lengths: list[int],
    channel_name: str | None = None,
    snr_db: float = SNR_DB,
    cfo_hz: float = CFO_HZ,
    device: torch.device | str | None = None,
) -> dict[int, dict]:
    """Sweep the Minn symbol length N (the active band and CP scaled with
    it, reference minn.py:656-700); per length the peak, the timing error,
    the metric's noise floor and maximum away from the peak, and the
    preamble's length (reference minn.py:754-871)."""
    sys = SYS_30M72
    dev = resolve_device(device)
    results: dict[int, dict] = {}
    for n in block_lengths:
        rng = np.random.default_rng(0)
        active = max(4, (n * sys.num_active // sys.n_fft) & ~1)
        sub = sys.replace(n_fft=n, cp_len=max(n // 4, 1), num_active=active)
        preamble = build_minn_preamble(rng, sub, include_cp=True)
        setup = common.build_setup(
            preamble, rng, sys=sub, channel_name=channel_name, cir_mode="two",
            snr_db=snr_db, cfo_hz=cfo_hz, device=dev)
        out = MinnDetector(sub).detect(setup.rx)
        expected = setup.true_cp_start + sub.cp_len
        M = report.host(out["M"])
        peak = out["peak"]
        mask = np.ones(M.size, bool)
        mask[max(0, peak - 300): min(M.size, peak + 300)] = False
        mask[: sub.tx_pre_pad] = False
        noise = M[mask]
        results[n] = {
            "peak_val": float(M[peak]),
            "timing_error": peak - expected,
            "noise_floor": float(noise.mean()) if noise.size else 0.0,
            "noise_max": float(noise.max()) if noise.size else 0.0,
            "overhead": preamble.size,
        }
    return results


def plot_block_length_comparison(
    channel_name: str | None,
    block_lengths: tuple[int, ...] = (512, 1024, 2048),
    snr_values: tuple[float, ...] = (-5.0, 0.0, 5.0, 10.0),
    cfo_hz: float = CFO_HZ,
    device: torch.device | str | None = None,
) -> None:
    """Per-SNR overlay of normalized Minn metrics for each symbol length
    (reference minn.py:899-1008; artifact set
    plots/minn/block_length_comparison/); detection on ``device``."""
    plt = report.pyplot()
    sys0 = SYS_30M72
    dev = resolve_device(device)
    cond = "measured_channel" if channel_name else "flat_awgn"
    out_dir = common.PLOTS_ROOT / "minn" / "block_length_comparison"
    out_dir.mkdir(parents=True, exist_ok=True)
    for snr_db in snr_values:
        fig, ax = plt.subplots(figsize=(11, 5))
        for n in block_lengths:
            rng = np.random.default_rng(0)
            active = max(4, (n * sys0.num_active // sys0.n_fft) & ~1)
            sub = sys0.replace(n_fft=n, cp_len=max(n // 4, 1), num_active=active)
            preamble = build_minn_preamble(rng, sub, include_cp=True)
            setup = common.build_setup(
                preamble, rng, sys=sub, channel_name=channel_name, cir_mode="two",
                snr_db=snr_db, cfo_hz=cfo_hz, device=dev)
            out = MinnDetector(sub).detect(setup.rx)
            M = report.host(out["M"])
            peak = int(out["peak"])
            ax.plot(M / max(M.max(), 1e-12), label=f"N={n} (peak @ {peak})", linewidth=0.9)
        ax.set_title(f"Minn metric vs symbol length - {cond}, SNR {snr_db:+.0f} dB")
        ax.set_xlabel("Sample offset")
        ax.set_ylabel("Normalized metric")
        ax.grid(True, alpha=0.4)
        ax.legend()
        fig.tight_layout()
        fig.savefig(out_dir / f"{cond}_block_comparison_snr{snr_db:+.0f}dB.png", dpi=110)
        plt.close(fig)
    print(f"Block-length comparison artifacts written to {out_dir}/")


def main(device: torch.device | str | None = None, plots: bool = True) -> None:
    report.banner("MINN SYNCHRONIZATION - DUAL CONDITION ANALYSIS")
    run_simulation(channel_name="cir1", plots_subdir="measured_channel" if plots else None,
                   device=device)
    run_simulation(channel_name=None, plots_subdir="flat_awgn" if plots else None,
                   device=device)
    results = compare_block_lengths([512, 1024, 2048], device=device)
    report.banner("BLOCK LENGTH COMPARISON - FLAT AWGN")
    print(f"{'N':>6} {'Peak':>8} {'NoiseAvg':>10} {'NoiseMax':>10} "
          f"{'TimingErr':>10} {'Overhead':>9}")
    for n, r in results.items():
        print(f"{n:>6d} {r['peak_val']:>8.3f} {r['noise_floor']:>10.4f} "
              f"{r['noise_max']:>10.4f} {r['timing_error']:>+10d} "
              f"{r['overhead']:>9d}")
    if plots:
        plot_block_length_comparison(None, device=device)
        plot_block_length_comparison("cir1", device=device)
    report.banner("ALL SIMULATIONS COMPLETE")


if __name__ == "__main__":
    main()
