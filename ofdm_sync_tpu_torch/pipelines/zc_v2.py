"""ZC streaming CFAR simulation (port of `ofdm_sync_tpu.pipelines.zc_v2`;
reference zc_v2.py:519-787).

The run detects with `ZCStreamingDetector.detect`, the reference path in
plain PyTorch, on ``device`` (the card unless the caller asks for the
CPU), as the JAX pipeline does; the fused paths (`detect_fused`,
`detect_fused_iq`, kernels D, E and B on a card) give the same events.

Run: ``python -m ofdm_sync_tpu_torch zc_v2 [--device cpu] [--no-plots]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.models.detectors import ZCStreamingDetector
from ofdm_sync_tpu_torch.ops.waveforms import build_pss_symbol
from ofdm_sync_tpu_torch.params import SYS_30M72, ZCStreamingParams
from ofdm_sync_tpu_torch.pipelines import common
from ofdm_sync_tpu_torch.utils import report

SNR_DB = 10.0
CFO_HZ = 1000.0
DETECTOR = "zc_v2"


def run_simulation(channel_name: str | None, plots_subdir: str | None = None,
                   device: torch.device | str | None = None) -> dict:
    """One seeded run (seed 0): PSS without CP -> channel -> CFO -> CFAR
    detection, strongest event -> CFO / LS EQ / EVM; prints the reference's
    report and returns its numbers.  With ``plots_subdir`` the reference's
    plots go to ``plots/zc_v2/<plots_subdir>/``."""
    sys = SYS_30M72
    rng = np.random.default_rng(0)
    plots_dir = common.make_plots_dir(DETECTOR, plots_subdir) if plots_subdir else None
    params = ZCStreamingParams()
    det = ZCStreamingDetector(sys, params=params)

    setup = common.build_setup(
        build_pss_symbol(sys, include_cp=False), rng, sys=sys, channel_name=channel_name,
        cir_mode="two", snr_db=SNR_DB, cfo_hz=CFO_HZ,
        device=resolve_device(device))

    result = det.detect(setup.rx)
    true_start = setup.true_cp_start
    expected_peak = true_start + sys.n_fft - 1
    primary = ZCStreamingDetector.strongest(result)
    if primary is not None:
        detected_start = primary.detected_start
        peak_index = primary.peak_index
    else:
        peak_index = int(torch.argmax(result.state["corr_mag"]))  # type: ignore[attr-defined]
        detected_start = max(0, peak_index - sys.n_fft + 1)
    timing_error = detected_start - true_start

    if plots_dir is not None:
        plot_detection(result, setup, params, peak_index, expected_peak, plots_dir)

    post = common.post_detection_chain(setup, detected_start, plots_dir, "ZC v2")

    common.print_common_header(setup, "ZC V2 DETECTION RESULTS")
    print("Detection Parameters:")
    print(f"  Window size (W): {params.corr_window}")
    print(f"  Threshold value: {params.threshold_value} (frac_bits={params.threshold_frac_bits})")
    print(f"  Effective threshold: ~"
          f"{params.threshold_value * params.corr_window / (1 << params.threshold_frac_bits):.1f}"
          f"x local average")
    print(f"  Min correlation: {params.min_corr_mag}")
    print(f"  Hysteresis: {params.hysteresis} samples")
    print(f"\nDetection Events: {len(result.events)}")
    for i, evt in enumerate(result.events):
        is_primary = " <- PRIMARY" if primary and evt.peak_index == primary.peak_index else ""
        print(f"  Event {i}: peak={evt.peak_index} (val={evt.peak_value:.4f}), "
              f"gate=[{evt.gate_start}, {evt.gate_end}), "
              f"frame_start={evt.detected_start}{is_primary}")
    print("\nTiming:")
    print(f"  True ZC start: {true_start}")
    print(f"  Detected start: {detected_start}")
    print(f"  Timing error: {timing_error} samples "
          f"({abs(timing_error) / sys.n_fft * 100:.1f}% of symbol)")
    print(f"  Expected peak: {expected_peak}")
    print(f"  Detected peak: {peak_index}")
    print(f"  Peak error: {peak_index - expected_peak} samples")
    if len(result.events) > 1:
        print(f"  Note: {len(result.events) - 1} spurious event(s) from sidelobes - "
              "strongest selected")
    common.print_cfo_block(CFO_HZ, post.cfo_est_hz)
    common.print_eq_block(post)
    if plots_dir is not None:
        print(f"\nPlots saved to {plots_dir.resolve()}/")
    print(report.BANNER + "\n")
    return {
        "num_events": len(result.events),
        "peak_index": peak_index,
        "detected_start": detected_start,
        "timing_error": timing_error,
        "cfo_est_hz": post.cfo_est_hz,
        "evm_rms": post.evm_rms,
        "evm_db": post.evm_db,
    }


def plot_detection(result, setup: common.SimSetup, params: ZCStreamingParams, peak_index: int,
                   expected_peak: int, plots_dir) -> None:
    """detection.png (correlation with the gate spans), correlation_zoom.png
    (the correlation around the peak beside the adaptive threshold) and the
    standard artifacts."""
    state = result.state
    corr_mag = report.host(state["corr_mag"])
    report.plot_metric(
        corr_mag, plots_dir / "detection.png",
        f"ZC Matched Filter Correlation ({setup.channel_desc})",
        vlines=[
            (peak_index, "tab:red", ":", f"Peak @ {peak_index}"),
            (expected_peak, "tab:green", "--", f"Expected @ {expected_peak}"),
        ],
        spans=[(e.gate_start, e.gate_end, "gate") for e in result.events],
        xlabel="Sample index", ylabel="|correlation|",
    )
    zoom_half = 500
    z0, z1 = max(0, peak_index - zoom_half), min(corr_mag.size, peak_index + zoom_half)
    plt = report.pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    x = np.arange(z0, z1)
    ax.plot(x, corr_mag[z0:z1], label="|corr|", color="tab:blue")
    thresh = (report.host(state["local_sum"])[z0:z1] * params.threshold_value
              / float(1 << params.threshold_frac_bits))
    ax.plot(x, thresh, label="Adaptive threshold", color="tab:orange", linestyle="--")
    ax.axvline(peak_index, color="tab:red", linestyle=":", label="Detected peak")
    ax.axvline(expected_peak, color="tab:green", linestyle="--", label="Expected peak")
    ax.axhline(params.min_corr_mag, color="gray", linestyle=":", alpha=0.5, label="Min threshold")
    ax.legend(loc="upper right")
    ax.grid(True, alpha=0.3)
    ax.set_title(f"Zoomed Correlation ({setup.channel_desc})")
    fig.tight_layout()
    fig.savefig(plots_dir / "correlation_zoom.png", dpi=150)
    plt.close(fig)
    common.emit_standard_artifacts(setup, plots_dir, "ZC v2")


def main(device: torch.device | str | None = None, plots: bool = True) -> None:
    report.banner("ZC V2 DETECTION - FPGA-FRIENDLY ADAPTIVE THRESHOLD")
    run_simulation(channel_name=None, plots_subdir="flat_awgn" if plots else None,
                   device=device)
    run_simulation(channel_name="cir1", plots_subdir="measured_channel" if plots else None,
                   device=device)
    report.banner("ALL SIMULATIONS COMPLETE")


if __name__ == "__main__":
    main()
