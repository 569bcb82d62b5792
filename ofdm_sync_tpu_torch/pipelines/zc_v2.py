"""ZC streaming CFAR simulation (port of `ofdm_sync_tpu.pipelines.zc_v2`;
reference zc_v2.py:519-787), without the plots.

The run detects with `ZCStreamingDetector.detect`, the reference path in
plain PyTorch, on ``device`` (the card unless the caller asks for the
CPU), as the JAX pipeline does; the fused paths (`detect_fused`,
`detect_fused_iq`, kernels D, E and B on a card) give the same events.

Run: ``python -m ofdm_sync_tpu_torch zc_v2 [--device cpu]``.
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


def run_simulation(channel_name: str | None, plots_subdir: str | None = None,
                   device: torch.device | str | None = None) -> dict:
    """One seeded run (seed 0): PSS without CP -> channel -> CFO -> CFAR
    detection, strongest event -> CFO / LS EQ / EVM; prints the reference's
    report and returns its numbers.  ``plots_subdir`` must be None: plots
    are not ported."""
    common.refuse_plots(plots_subdir)
    sys = SYS_30M72
    rng = np.random.default_rng(0)
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

    post = common.post_detection_chain(setup, detected_start)

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


def main(device: torch.device | str | None = None) -> None:
    report.banner("ZC V2 DETECTION - FPGA-FRIENDLY ADAPTIVE THRESHOLD")
    run_simulation(channel_name=None, device=device)
    run_simulation(channel_name="cir1", device=device)
    report.banner("ALL SIMULATIONS COMPLETE")


if __name__ == "__main__":
    main()
