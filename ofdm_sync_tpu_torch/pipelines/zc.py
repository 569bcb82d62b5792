"""Zadoff-Chu time-domain matched-filter simulation (port of
`ofdm_sync_tpu.pipelines.zc`; reference zc.py:57-283).

Run: ``python -m ofdm_sync_tpu_torch zc [--device cpu] [--no-plots]``.  The detector D5
has no kernel: the run is plain PyTorch on ``device`` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.models.detectors import ZCTimeDetector
from ofdm_sync_tpu_torch.ops.waveforms import build_pss_symbol
from ofdm_sync_tpu_torch.params import SYS_30M72
from ofdm_sync_tpu_torch.pipelines import common
from ofdm_sync_tpu_torch.utils import report

SNR_DB = 10.0
CFO_HZ = 1000.0
DETECTOR = "zc"


def run_simulation(channel_name: str | None, plots_subdir: str | None = None,
                   device: torch.device | str | None = None) -> dict:
    """One seeded run (seed 0): PSS without CP -> channel -> CFO -> ZC
    matched filter -> CFO / LS EQ / EVM; prints the reference's report and
    returns its numbers.  With ``plots_subdir`` the reference's
    plots go to ``plots/zc/<plots_subdir>/``."""
    sys = SYS_30M72
    rng = np.random.default_rng(0)
    plots_dir = common.make_plots_dir(DETECTOR, plots_subdir) if plots_subdir else None
    det = ZCTimeDetector(sys)

    # preamble = PSS symbol WITHOUT CP (reference zc.py:78)
    setup = common.build_setup(
        build_pss_symbol(sys, include_cp=False), rng, sys=sys, channel_name=channel_name,
        cir_mode="two", snr_db=SNR_DB, cfo_hz=CFO_HZ,
        device=resolve_device(device))

    out = det.detect(setup.rx)
    peak_index = out["peak_index"]
    detected_start = out["detected_start"]
    true_start = setup.true_cp_start  # no CP: the preamble starts at pad + offset
    expected_peak = true_start + sys.n_fft - 1
    timing_error = detected_start - true_start
    peak_error = peak_index - expected_peak

    if plots_dir is not None:
        report.plot_metric(
            out["corr_mag"], plots_dir / "correlation.png",
            f"Cross-correlation with ZC PSS Reference ({setup.channel_desc})",
            vlines=[(peak_index, "tab:red", "--", f"Peak @ {peak_index}")],
            xlabel="Sample index", ylabel="|normalized corr|",
        )
        report.plot_rx_and_metric(
            setup.rx, out["corr_mag"], plots_dir / "start_detection.png",
            f"Received Magnitude with Start Detection (ZC, {setup.channel_desc})",
            "PSS Correlation Alignment",
            vlines_top=[
                (true_start, "tab:green", "--", "Expected ZC start"),
                (detected_start, "tab:red", ":", "Detected ZC start"),
            ],
            vlines_bottom=[
                (peak_index, "tab:red", ":", "Peak index"),
                (expected_peak, "tab:green", "--", "Expected peak"),
            ],
        )
        common.emit_standard_artifacts(setup, plots_dir, "ZC")

    post = common.post_detection_chain(setup, detected_start, plots_dir, "ZC")

    common.print_common_header(setup, "ZADOFF-CHU SYNCHRONIZATION RESULTS")
    print("\nTiming Detection:")
    print(f"  Matched filter peak index: {peak_index}")
    print(f"  Expected peak index: {expected_peak}")
    print(f"  Detected ZC start sample: {detected_start}")
    print(f"  Timing error: {timing_error} samples "
          f"({abs(timing_error) / sys.n_fft * 100:.1f}% of symbol)")
    print(f"  Peak index error: {peak_error} samples")
    common.print_cfo_block(CFO_HZ, post.cfo_est_hz)
    common.print_eq_block(post)
    if plots_dir is not None:
        print(f"\nPlots saved to {plots_dir.resolve()}/")
    print(report.BANNER + "\n")
    return {
        "peak_index": peak_index,
        "detected_start": detected_start,
        "timing_error": timing_error,
        "peak_error": peak_error,
        "cfo_est_hz": post.cfo_est_hz,
        "evm_rms": post.evm_rms,
        "evm_db": post.evm_db,
    }


def main(device: torch.device | str | None = None, plots: bool = True) -> None:
    report.banner("ZADOFF-CHU SYNCHRONIZATION - DUAL CONDITION ANALYSIS")
    run_simulation(channel_name="cir1", plots_subdir="measured_channel" if plots else None,
                   device=device)
    run_simulation(channel_name=None, plots_subdir="flat_awgn" if plots else None,
                   device=device)
    report.banner("ALL SIMULATIONS COMPLETE")


if __name__ == "__main__":
    main()
