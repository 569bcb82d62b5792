"""Frequency-domain Zadoff-Chu simulation (port of
`ofdm_sync_tpu.pipelines.zc_freq`; reference zc_freq.py:102-290).

Run: ``python -m ofdm_sync_tpu_torch zc_freq [--device cpu] [--no-plots]``.  The
detector D6 has no kernel: the run is plain PyTorch on ``device`` (the card
unless the caller asks for the CPU), in the FFT form the reference's
numbers come from.
"""

from __future__ import annotations

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.models.detectors import ZCFreqDetector
from ofdm_sync_tpu_torch.ops.waveforms import build_pss_symbol
from ofdm_sync_tpu_torch.params import SYS_30M72
from ofdm_sync_tpu_torch.pipelines import common
from ofdm_sync_tpu_torch.utils import report

SNR_DB = 10.0
CFO_HZ = 0.0  # an upstream NCO has corrected the CFO (reference zc_freq.py:34)
DETECTOR = "zc_freq"


def run_simulation(channel_name: str | None, plots_subdir: str | None = None,
                   device: torch.device | str | None = None) -> dict:
    """One seeded run (seed 0): PSS symbol with CP -> channel (every RX
    branch of a measured CIR) -> frequency-domain CP-start search -> CFO /
    LS EQ / EVM; prints the reference's report and returns its numbers.
    With ``plots_subdir`` the reference's plots go to
    ``plots/zc_freq/<plots_subdir>/``."""
    sys = SYS_30M72
    rng = np.random.default_rng(0)
    plots_dir = common.make_plots_dir(DETECTOR, plots_subdir) if plots_subdir else None

    setup = common.build_setup(
        build_pss_symbol(sys, include_cp=True), rng, sys=sys, channel_name=channel_name,
        cir_mode="all", snr_db=SNR_DB, cfo_hz=CFO_HZ, device=resolve_device(device))

    out = ZCFreqDetector(sys).detect(setup.rx)
    detected_cp_start = out["detected_cp_start"]
    timing_error = detected_cp_start - setup.true_cp_start

    if plots_dir is not None:
        report.plot_metric(
            out["metric"], plots_dir / "correlation.png",
            f"Frequency-domain PSS Metric ({setup.channel_desc})",
            vlines=[(detected_cp_start, "tab:red", "--", f"Peak @ {detected_cp_start}")],
            xlabel="Candidate CP start index", ylabel="Normalized metric",
        )
        report.plot_rx_and_metric(
            setup.rx, out["metric"], plots_dir / "start_detection.png",
            f"Received Magnitude with Start Detection (ZC FD, {setup.channel_desc})",
            "Frequency-domain Detector Output",
            vlines_top=[
                (setup.true_cp_start, "tab:green", "--", "Expected CP start"),
                (detected_cp_start, "tab:red", ":", "Detected CP start"),
            ],
            vlines_bottom=[
                (detected_cp_start, "tab:red", ":", "Peak index"),
                (setup.true_cp_start, "tab:green", "--", "Expected CP start"),
            ],
        )
        common.emit_standard_artifacts(setup, plots_dir, "ZC FD")

    post = common.post_detection_chain(setup, detected_cp_start + sys.cp_len, plots_dir,
                                       "ZC FD")

    common.print_common_header(setup, "FREQUENCY-DOMAIN ZC SYNCHRONIZATION RESULTS")
    print("\nTiming Detection:")
    print(f"  Detected CP start sample: {detected_cp_start}")
    print(f"  Expected CP start sample: {setup.true_cp_start}")
    print(f"  Timing error: {timing_error} samples "
          f"({abs(timing_error) / sys.n_fft * 100:.2f}% of symbol)")
    print("\nCarrier Frequency Offset:")
    print(f"  Estimated CFO from CP: {post.cfo_est_hz:.2f} Hz")
    common.print_eq_block(post)
    if plots_dir is not None:
        print(f"\nPlots saved to {plots_dir.resolve()}/")
    print(report.BANNER + "\n")
    return {
        "detected_cp_start": detected_cp_start,
        "timing_error": timing_error,
        "cfo_est_hz": post.cfo_est_hz,
        "evm_rms": post.evm_rms,
        "evm_db": post.evm_db,
    }


def main(device: torch.device | str | None = None, plots: bool = True) -> None:
    report.banner("FREQUENCY-DOMAIN ZC SYNCHRONIZATION - DUAL CONDITION ANALYSIS")
    run_simulation(channel_name="cir1", plots_subdir="measured_channel" if plots else None,
                   device=device)
    run_simulation(channel_name=None, plots_subdir="flat_awgn" if plots else None,
                   device=device)
    report.banner("ALL SIMULATIONS COMPLETE")


if __name__ == "__main__":
    main()
