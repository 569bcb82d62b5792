"""Combined S&C-gated Minn simulation (port of
`ofdm_sync_tpu.pipelines.combined_sc_minn`; reference
combined_sc_min.py:272-580).

Run: ``python -m ofdm_sync_tpu_torch combined_sc_minn [--device cpu] [--no-plots]``.
The detector D8 has no kernel: the run is plain PyTorch on ``device`` (the
card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.models.detectors import CombinedSCMinnDetector
from ofdm_sync_tpu_torch.ops.detect import mask_segments
from ofdm_sync_tpu_torch.ops.waveforms import build_minn_preamble
from ofdm_sync_tpu_torch.params import SYS_30M72
from ofdm_sync_tpu_torch.pipelines import common
from ofdm_sync_tpu_torch.utils import report

SNR_DB = 10.0
CFO_HZ = 1000.0
DETECTOR = "combined_sc_minn"


def run_simulation(channel_name: str | None, plots_subdir: str | None = None,
                   device: torch.device | str | None = None) -> dict:
    """One seeded run (seed 0): Minn preamble -> channel (the first two RX
    branches of a measured CIR) -> CFO -> Minn peak in the S&C gate -> CFO /
    LS EQ / EVM; prints the reference's report and returns its numbers.
    With ``plots_subdir`` the reference's plots go to
    ``plots/combined_sc_minn/<plots_subdir>/``."""
    sys = SYS_30M72
    rng = np.random.default_rng(0)
    plots_dir = common.make_plots_dir(DETECTOR, plots_subdir) if plots_subdir else None
    det = CombinedSCMinnDetector(sys)

    preamble = build_minn_preamble(rng, sys, include_cp=True)
    setup = common.build_setup(
        preamble, rng, sys=sys, channel_name=channel_name, cir_mode="two",
        snr_db=SNR_DB, cfo_hz=CFO_HZ, device=resolve_device(device))

    out = det.detect(setup.rx)
    peak_position = out["peak"]
    gate_segments = mask_segments(out["sc_gate_mask"])
    expected_n_start = setup.true_cp_start + sys.cp_len
    timing_error = peak_position - expected_n_start

    if plots_dir is not None:
        report.plot_metric(
            out["M_minn"], plots_dir / "minn_metric.png",
            f"Minn Metric with S&C Gate - {setup.channel_desc}",
            vlines=[
                (peak_position, "tab:red", ":", f"Minn peak @ {peak_position}"),
                (expected_n_start, "tab:green", "--", "Expected N start"),
            ],
            extra_traces=[
                (out["sc_norm"], "S&C (normalized)", "--"),
                (out["M_smooth"], "Minn smoothed", ":"),
            ],
            spans=[(s, e, "S&C gate") for s, e in gate_segments],
        )
        report.plot_rx_and_metric(
            setup.rx, out["M_minn"], plots_dir / "start_detection.png",
            f"Received Magnitude and Detected Start (Combined, {setup.channel_desc})",
            "Timing Metrics (Minn within S&C gate)",
            vlines_top=[
                (setup.true_cp_start, "tab:purple", "--", "Preamble CP start"),
                (expected_n_start, "tab:green", "--", "Preamble N start"),
                (peak_position, "tab:red", ":", "Detected start"),
            ],
            vlines_bottom=[
                (peak_position, "tab:red", ":", f"Peak @ {peak_position}"),
                (expected_n_start, "tab:green", "--", "Expected N start"),
            ],
            spans=[(s, e, "S&C gate") for s, e in gate_segments],
        )
        common.emit_standard_artifacts(setup, plots_dir, "Combined")

    post = common.post_detection_chain(setup, peak_position, plots_dir, "Combined")

    common.print_common_header(setup, "COMBINED S&C + MINN SYNCHRONIZATION RESULTS")
    print("\nTiming Detection:")
    print(f"  Detected Minn peak at d={peak_position}")
    print(f"  Expected N start at d={expected_n_start}")
    print(f"  Timing error: {timing_error} samples "
          f"({abs(timing_error) / sys.n_fft * 100:.1f}% of symbol)")
    if gate_segments:
        print(f"  S&C gate window: [{gate_segments[0][0]}, {gate_segments[-1][1]}) "
              f"(threshold >={det.sc_gate_threshold:.0%} of S&C peak)")
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
    }


def main(device: torch.device | str | None = None, plots: bool = True) -> None:
    report.banner("COMBINED S&C + MINN SYNCHRONIZATION - DUAL CONDITION ANALYSIS")
    run_simulation(channel_name="cir1", plots_subdir="measured_channel" if plots else None,
                   device=device)
    run_simulation(channel_name=None, plots_subdir="flat_awgn" if plots else None,
                   device=device)
    report.banner("ALL SIMULATIONS COMPLETE")


if __name__ == "__main__":
    main()
