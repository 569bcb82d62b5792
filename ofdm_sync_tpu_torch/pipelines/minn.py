"""Standard Minn simulation and block-length sweep (port of
`ofdm_sync_tpu.pipelines.minn`; reference minn.py:300-1026), without the
plots (`plot_block_length_comparison` is not ported).

Run: ``python -m ofdm_sync_tpu_torch minn [--device cpu]``.  The detector
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


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_simulation(channel_name: str | None, plots_subdir: str | None = None,
                   device: torch.device | str | None = None) -> dict:
    """One seeded run (seed 0): Minn preamble -> channel (the first two RX
    branches of a measured CIR) -> CFO -> Minn peak -> CFO / LS EQ / EVM,
    with the RTL-style energy-threshold analysis; prints the reference's
    report and returns its numbers."""
    common.refuse_plots(plots_subdir)
    sys = SYS_30M72
    rng = np.random.default_rng(0)
    params = MinnDetectorParams()

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
    P, R = _host(out["P"]), _host(out["R"])
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

    post = common.post_detection_chain(setup, detected_start)

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
        M = _host(out["M"])
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


def main(device: torch.device | str | None = None) -> None:
    report.banner("MINN SYNCHRONIZATION - DUAL CONDITION ANALYSIS")
    run_simulation(channel_name="cir1", device=device)
    run_simulation(channel_name=None, device=device)
    results = compare_block_lengths([512, 1024, 2048], device=device)
    report.banner("BLOCK LENGTH COMPARISON - FLAT AWGN")
    print(f"{'N':>6} {'Peak':>8} {'NoiseAvg':>10} {'NoiseMax':>10} "
          f"{'TimingErr':>10} {'Overhead':>9}")
    for n, r in results.items():
        print(f"{n:>6d} {r['peak_val']:>8.3f} {r['noise_floor']:>10.4f} "
              f"{r['noise_max']:>10.4f} {r['timing_error']:>+10d} "
              f"{r['overhead']:>9d}")
    report.banner("ALL SIMULATIONS COMPLETE")


if __name__ == "__main__":
    main()
