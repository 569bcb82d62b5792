"""Park preamble simulation (port of `ofdm_sync_tpu.pipelines.park`;
reference park.py:123-349).

Run: ``python -m ofdm_sync_tpu_torch park [--device cpu] [--no-plots]``.  The detector
D4 has no kernel: the run is plain PyTorch on ``device`` (the card unless
the caller asks for the CPU).  On cir1 the reference itself locks onto a
wrong center (8619), and so does this run.
"""

from __future__ import annotations

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.models.detectors import ParkDetector
from ofdm_sync_tpu_torch.ops.waveforms import build_park_preamble
from ofdm_sync_tpu_torch.params import SYS_30M72
from ofdm_sync_tpu_torch.pipelines import common
from ofdm_sync_tpu_torch.utils import report

SNR_DB = 10.0
CFO_HZ = 1000.0
DETECTOR = "park"


def run_simulation(channel_name: str | None, plots_subdir: str | None = None,
                   device: torch.device | str | None = None) -> dict:
    """One seeded run (seed 0): Park preamble -> channel (every RX branch of
    a measured CIR) -> CFO -> Park center -> CFO / LS EQ / EVM; prints the
    reference's report and returns its numbers.  With ``plots_subdir`` the
    reference's plots go to ``plots/park/<plots_subdir>/``."""
    sys = SYS_30M72
    rng = np.random.default_rng(0)
    plots_dir = common.make_plots_dir(DETECTOR, plots_subdir) if plots_subdir else None
    det = ParkDetector(sys)

    preamble = build_park_preamble(rng, sys, include_cp=True)
    setup = common.build_setup(
        preamble, rng, sys=sys, channel_name=channel_name, cir_mode="all",
        snr_db=SNR_DB, cfo_hz=CFO_HZ, device=resolve_device(device))

    out = det.detect(setup.rx)
    det_center = out["det_center"]
    det_symbol_start = out["det_symbol_start"]
    true_symbol_start = setup.true_cp_start + det.cp_len
    true_center = true_symbol_start + sys.n_fft // 2
    timing_error = det_symbol_start - true_symbol_start

    if plots_dir is not None:
        plot_park_components(out, setup, true_symbol_start, true_center, plots_dir)

    # the pilot CP starts one symbol after the detected symbol start,
    # clipped into the stream (reference park.py:243-247)
    max_start = setup.rx.shape[-1] - (sys.n_fft + sys.cp_len)
    pilot_cp_start_est = int(np.clip(det_symbol_start + sys.n_fft, 0, max_start))
    post = common.post_detection_chain(setup, pilot_cp_start_est - sys.n_fft, plots_dir, "Park")

    common.print_common_header(setup, "PARK SYNCHRONIZATION RESULTS")
    print("\nTiming Detection:")
    print(f"  Detected center index: {det_center}")
    print(f"  Detected symbol start: {det_symbol_start}")
    print(f"  True symbol start:     {true_symbol_start}")
    print(f"  Timing error: {timing_error} samples "
          f"({abs(timing_error) / sys.n_fft * 100:.2f}% of symbol)")
    common.print_cfo_block(CFO_HZ, post.cfo_est_hz)
    common.print_eq_block(post)
    if plots_dir is not None:
        print(f"\nPlots saved to {plots_dir.resolve()}/")
    print(report.BANNER + "\n")
    return {
        "det_center": det_center,
        "det_symbol_start": det_symbol_start,
        "timing_error": timing_error,
        "cfo_est_hz": post.cfo_est_hz,
        "evm_rms": post.evm_rms,
        "evm_db": post.evm_db,
    }


def plot_park_components(out: dict, setup: common.SimSetup, true_symbol_start: int,
                         true_center: int, plots_dir) -> None:
    """park_metric.png (|P|, E and M around the search range), the
    start-detection overview and the standard artifacts."""
    plt = report.pyplot()
    ds = report.host(out["ds"])
    det_center = out["det_center"]
    fig = plt.figure(figsize=(10, 6))
    for i, (trace, ylab) in enumerate(
            [(np.abs(report.host(out["P"])), "|P(d)|"),
             (report.host(out["E"]), "E(d)"),
             (report.host(out["M"]), "M(d)")]):
        ax = plt.subplot(3, 1, i + 1)
        ax.plot(ds, trace)
        ax.axvline(true_center, color="tab:green", linestyle="--", label="True center")
        ax.axvline(det_center, color="tab:red", linestyle=":", label="Detected center")
        ax.set_ylabel(ylab)
        ax.grid(alpha=0.3)
        if i == 0:
            ax.legend(loc="upper right")
    plt.suptitle(f"Park Correlation Components - {setup.channel_desc}")
    plt.tight_layout()
    plt.savefig(plots_dir / "park_metric.png", dpi=150)
    plt.close(fig)

    # start_detection uses the ds-indexed metric, padded to the absolute axis
    M_abs = np.zeros(setup.rx.shape[-1])
    M_abs[ds] = report.host(out["M"])
    report.plot_rx_and_metric(
        setup.rx, M_abs, plots_dir / "start_detection.png",
        f"Received Frame & Detection (Park, {setup.channel_desc})",
        "Timing Metric Around Detection",
        vlines_top=[
            (setup.true_cp_start, "tab:purple", "--", "CP start (true)"),
            (true_symbol_start, "tab:green", "--", "Symbol start (true)"),
            (out["det_symbol_start"], "tab:red", ":", "Symbol start (det)"),
        ],
        vlines_bottom=[
            (true_center, "tab:green", "--", "True center"),
            (det_center, "tab:red", ":", "Detected center"),
        ],
    )
    common.emit_standard_artifacts(setup, plots_dir, "Park")


def main(device: torch.device | str | None = None, plots: bool = True) -> None:
    report.banner("PARK PREAMBLE SYNCHRONIZATION - DUAL CONDITION ANALYSIS")
    run_simulation(channel_name="cir1", plots_subdir="measured_channel" if plots else None,
                   device=device)
    run_simulation(channel_name=None, plots_subdir="flat_awgn" if plots else None,
                   device=device)
    report.banner("ALL PARK SIMULATIONS COMPLETE")


if __name__ == "__main__":
    main()
