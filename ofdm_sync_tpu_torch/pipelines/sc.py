"""Schmidl & Cox simulation (port of `ofdm_sync_tpu.pipelines.sc`;
reference sc.py:159-373).

Run: ``python -m ofdm_sync_tpu_torch sc [--device cpu] [--no-plots]``.  The detector D1
has no kernel: the run is plain PyTorch on ``device`` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.models.detectors import SCDetector
from ofdm_sync_tpu_torch.ops.waveforms import build_sc_preamble
from ofdm_sync_tpu_torch.params import SYS_30M72, SCDetectorParams
from ofdm_sync_tpu_torch.pipelines import common
from ofdm_sync_tpu_torch.utils import report

SNR_DB = 10.0
CFO_HZ = 1000.0
DETECTOR = "sc"


def run_simulation(channel_name: str | None, plots_subdir: str | None = None,
                   device: torch.device | str | None = None) -> dict:
    """One seeded run (seed 0): S&C preamble -> channel (RX branch 1 of a
    measured CIR) -> CFO -> plateau detection -> CFO / LS EQ / EVM; prints
    the reference's report and returns its numbers.  With ``plots_subdir``
    the reference's plots go to ``plots/sc/<plots_subdir>/``."""
    sys = SYS_30M72
    rng = np.random.default_rng(0)
    params = SCDetectorParams()
    plots_dir = common.make_plots_dir(DETECTOR, plots_subdir) if plots_subdir else None

    preamble = build_sc_preamble(rng, sys, include_cp=True)
    setup = common.build_setup(
        preamble, rng, sys=sys, channel_name=channel_name, cir_mode="ch1",
        snr_db=SNR_DB, cfo_hz=CFO_HZ, device=resolve_device(device))

    out = SCDetector(sys, params).detect(setup.rx)
    plateau_end = out["plateau_end"]
    coarse_start = out["coarse_start"]
    expected_left_edge = setup.true_cp_start + sys.cp_len
    timing_error = coarse_start - setup.true_cp_start

    if plots_dir is not None:
        report.plot_metric(
            out["M"], plots_dir / "sc_metric.png",
            f"Schmidl & Cox Streaming Metric ({setup.channel_desc})",
            vlines=[
                (plateau_end, "tab:red", ":", "Plateau end"),
                (expected_left_edge, "tab:green", "--", "Plateau start (exp)"),
            ],
        )
        report.plot_rx_and_metric(
            setup.rx, out["M"], plots_dir / "start_detection.png",
            f"Received Magnitude and Detected Start (S&C, {setup.channel_desc})",
            "Plateau-Based Timing (End minus delta)",
            vlines_top=[
                (setup.true_cp_start, "tab:purple", "--", "CP start (true)"),
                (expected_left_edge, "tab:green", "--", "Plateau start (exp)"),
                (plateau_end, "tab:red", ":", "Plateau end (det)"),
                (coarse_start, "tab:orange", ":", f"Coarse start = end-{params.sc_delta}"),
            ],
            vlines_bottom=[
                (plateau_end, "tab:red", ":", "Plateau end (det)"),
                (expected_left_edge, "tab:green", "--", "Plateau start (exp)"),
            ],
        )
        common.emit_standard_artifacts(setup, plots_dir, "S&C")

    post = common.post_detection_chain(setup, plateau_end, plots_dir, "S&C")

    common.print_common_header(setup, "SCHMIDL & COX SYNCHRONIZATION RESULTS")
    print("\nTiming Detection:")
    print(f"  Detected plateau end at d={plateau_end}")
    print(f"  Coarse start (end - {params.sc_delta}) at d={coarse_start}")
    print(f"  Expected plateau start at d={expected_left_edge}")
    print(f"  Timing error: {timing_error} samples "
          f"({abs(timing_error) / sys.n_fft * 100:.1f}% of symbol)")
    common.print_cfo_block(CFO_HZ, post.cfo_est_hz)
    common.print_eq_block(post)
    if plots_dir is not None:
        print(f"\nPlots saved to {plots_dir.resolve()}/")
    print(report.BANNER + "\n")
    return {
        "plateau_end": plateau_end,
        "coarse_start": coarse_start,
        "timing_error": timing_error,
        "cfo_est_hz": post.cfo_est_hz,
        "evm_rms": post.evm_rms,
        "evm_db": post.evm_db,
    }


def main(device: torch.device | str | None = None, plots: bool = True) -> None:
    report.banner("SCHMIDL & COX SYNCHRONIZATION - DUAL CONDITION ANALYSIS")
    run_simulation(channel_name="cir1", plots_subdir="measured_channel" if plots else None,
                   device=device)
    run_simulation(channel_name=None, plots_subdir="flat_awgn" if plots else None,
                   device=device)
    report.banner("ALL SIMULATIONS COMPLETE")


if __name__ == "__main__":
    main()
