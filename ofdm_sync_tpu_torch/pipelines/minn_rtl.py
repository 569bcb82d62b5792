"""Minn-RTL fixed-point detector simulation and its sequence / Q sweeps
(port of `ofdm_sync_tpu.pipelines.minn_rtl`; reference
minn_rtl.py:849-1735), with the Q comparison plots (`plot_q_comparison`).

Run: ``python -m ofdm_sync_tpu_torch minn_rtl [--device cpu] [--no-plots]``.  Detection
is `MinnRTLDetector.detect`, the reference path in plain PyTorch, on
``device`` (the card unless the caller asks for the CPU), as the JAX
pipeline does; the fused path (`detect_fused_frames`, kernels A and B on a
card) is the receive chain of `pipelines.fused_rx`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.models.detectors import MinnRTLDetector
from ofdm_sync_tpu_torch.ops.detect import mask_segments
from ofdm_sync_tpu_torch.ops.waveforms import build_minn_rtl_preamble
from ofdm_sync_tpu_torch.params import SYS_30M72, MinnRTLParams
from ofdm_sync_tpu_torch.pipelines import common
from ofdm_sync_tpu_torch.utils import report

SNR_DB = 0.0
CFO_HZ = 1000.0
DETECTOR = "minn_rtl"
DEFAULT_PARAMS = MinnRTLParams()
SEQ_TYPES = ("bpsk_freq", "qpsk_freq", "zc_time", "zc_freq", "chirp", "gold", "random_phase")


def _detect_two_frames(params: MinnRTLParams, channel_name: str | None, dev: torch.device,
                       snr_db: float = SNR_DB):
    """Seed-0 stimulus of two frames with an inter-frame guard (reference
    minn_rtl.py:884-889) and the plain detection on it: (setup, metric
    state, result)."""
    sys = SYS_30M72
    rng = np.random.default_rng(0)
    preamble = build_minn_rtl_preamble(params.seq_type, rng, Q=params.quarter_len, sys=sys)
    setup = common.build_setup(
        preamble, rng, sys=sys, channel_name=channel_name, cir_mode="two",
        snr_db=snr_db, cfo_hz=CFO_HZ, two_frames=True, device=dev)
    state, result = MinnRTLDetector(sys, params).detect(setup.rx)
    return setup, state, result


def run_simulation(
    channel_name: str | None,
    plots_subdir: str | None = None,
    params: MinnRTLParams = DEFAULT_PARAMS,
    device: torch.device | str | None = None,
) -> dict:
    """One seeded run (seed 0) of two frames: 5-segment preamble -> channel
    (the first two RX branches of a measured CIR) -> CFO -> RTL gate events
    -> CFO / LS EQ / EVM on the first; prints the reference's report and
    returns its numbers.  With ``plots_subdir`` the reference's plots go to
    ``plots/minn_rtl/<plots_subdir>/``."""
    sys = SYS_30M72
    plots_dir = common.make_plots_dir(DETECTOR, plots_subdir) if plots_subdir else None
    setup, state, result = _detect_two_frames(params, channel_name, resolve_device(device))
    frame_len = setup.extras["frame_len"]
    events = result.events

    if events:
        detected_start = events[0].detected_start
        peak_position = events[0].peak_index
    else:
        peak_position = int(torch.argmax(state.smooth_metric))
        detected_start = peak_position + params.timing_offset
    gate_segments = [(e.gate_start, e.gate_end) for e in events] or mask_segments(
        result.gate_mask)

    # expected: the RTL peak is each frame's pilot N start
    frame_starts = [sys.tx_pre_pad, sys.tx_pre_pad + 2 * frame_len]
    s0_starts = [s + setup.channel_peak_offset for s in frame_starts]
    pilot_n_starts = [s0 + 5 * params.quarter_len + sys.cp_len for s0 in s0_starts]
    timing_error = detected_start - pilot_n_starts[0]
    per_event_errors = [
        e.detected_start - pilot_n_starts[i] if i < len(pilot_n_starts) else None
        for i, e in enumerate(events)
    ]

    if plots_dir is not None:
        plot_detection(setup, state, params, peak_position, detected_start, s0_starts[0],
                       pilot_n_starts, gate_segments, plots_dir)

    post = common.post_detection_chain(setup, detected_start, plots_dir, "Minn RTL")
    if plots_dir is not None:
        common.emit_ls_cir_artifact(setup, post, timing_error, plots_dir, "Minn RTL")

    common.print_common_header(setup, "MINN RTL SYNCHRONIZATION RESULTS")
    print("\nTiming Detections:")
    if events:
        print(f"  Detected {len(events)} event(s)")
        for i, e in enumerate(events):
            exp = pilot_n_starts[i] if i < len(pilot_n_starts) else None
            err = per_event_errors[i]
            if exp is not None and err is not None:
                print(f"    Event {i}: peak={e.peak_index} detected={e.detected_start} "
                      f"expected={exp} error={err} samples")
            else:
                print(f"    Event {i}: peak={e.peak_index} detected={e.detected_start} "
                      "(no expected reference)")
    else:
        print(f"  No detection events; fallback peak at d={peak_position}")
    frac = params.threshold_value / float(1 << params.threshold_frac_bits)
    for i, (s, e) in enumerate(gate_segments):
        print(f"  Gate {i}: [{s}, {e}) threshold >={frac:.1%} span {e - s} samples")
    print(f"  Frame length: {frame_len} samples, guard length: {frame_len} samples")
    print(f"  Primary timing error: {timing_error} samples "
          f"({abs(timing_error) / sys.n_fft * 100:.1f}% of symbol)")
    common.print_cfo_block(CFO_HZ, post.cfo_est_hz)
    common.print_eq_block(post)
    if plots_dir is not None:
        print(f"\nPlots saved to {plots_dir.resolve()}/")
    print(report.BANNER + "\n")
    return {
        "events": [(e.peak_index, e.detected_start) for e in events],
        "timing_error": timing_error,
        "per_event_errors": per_event_errors,
        "cfo_est_hz": post.cfo_est_hz,
        "evm_rms": post.evm_rms,
        "evm_db": post.evm_db,
    }


def plot_detection(setup, state, params: MinnRTLParams, peak_position: int,
                   detected_start: int, s0_start: int, pilot_n_starts: list[int],
                   gate_segments, plots_dir) -> None:
    """minn_rtl_metric.png (the metric, the smoothed metric and the scaled
    threshold with the gates), the start-detection overview and the
    standard artifacts."""
    valid = report.host(state.metric_valid)
    thresh_trace = np.full(valid.shape, np.nan)
    thresh_trace[valid] = (report.host(state.energy_scaled)[valid]
                           / float(1 << params.threshold_frac_bits))
    expected = pilot_n_starts[0]
    report.plot_metric(
        state.corr_positive, plots_dir / "minn_rtl_metric.png",
        f"Minn RTL Metric & Gate - {setup.channel_desc}",
        vlines=[(peak_position, "tab:red", ":", "Detected peak")]
        + [(e, "tab:green", "--", "Pilot N start (exp)" if i == 0 else None)
           for i, e in enumerate(pilot_n_starts)],
        extra_traces=[
            (state.smooth_metric, "RTL smooth(d)", "--"),
            (thresh_trace, "Threshold (scaled)", ":"),
        ],
        spans=[(s, e, "Gate window") for s, e in gate_segments],
        ylabel="Metric",
    )
    report.plot_rx_and_metric(
        setup.rx, state.corr_positive, plots_dir / "start_detection.png",
        f"Received Magnitude and Detected Start (Minn RTL, {setup.channel_desc})",
        "Timing Metrics (Minn RTL)",
        vlines_top=[
            (s0_start, "tab:purple", "--", "Preamble S0 start"),
            (expected, "tab:green", "--", "Pilot N start (exp)"),
            (detected_start, "tab:red", ":", "Detected start"),
        ],
        vlines_bottom=[
            (peak_position, "tab:red", ":", "Detected peak"),
            (expected, "tab:green", "--", "Pilot N start (exp)"),
        ],
        spans=[(s, e, "Gate window") for s, e in gate_segments],
    )
    common.emit_standard_artifacts(setup, plots_dir, "Minn RTL")


# ---------------------------------------------------------------------------
# Sweeps (reference minn_rtl.py:1187-1328, 1493-1592)
# ---------------------------------------------------------------------------

def _metric_quality(metric: np.ndarray, peak_idx: int, tx_pre_pad: int) -> dict:
    """Peak value, noise floor and maximum more than 500 samples from the
    peak (and past the leading pad), and the peak-to-average (PAR) and
    peak-to-maximum (PMR) ratios."""
    mask = np.ones(metric.size, bool)
    mask[max(0, peak_idx - 500): min(metric.size, peak_idx + 500)] = False
    mask[:tx_pre_pad] = False
    noise = metric[mask]
    peak_val = float(metric[peak_idx])
    nf = float(noise.mean()) if noise.size else 0.0
    nm = float(noise.max()) if noise.size else 0.0
    return {
        "peak_val": peak_val,
        "noise_floor": nf,
        "noise_max": nm,
        "par": peak_val / nf if nf > 0 else float("inf"),
        "pmr": peak_val / nm if nm > 0 else float("inf"),
    }


def _first_peak(setup, state, result, params: MinnRTLParams) -> tuple[int, int]:
    """(peak index, timing error against the first pilot N start) of the
    first event, or of the smoothed metric's argmax without one."""
    sys = setup.sys
    pilot_n_start = (sys.tx_pre_pad + setup.channel_peak_offset + 5 * params.quarter_len
                     + sys.cp_len)
    if result.events:
        return result.events[0].peak_index, result.events[0].detected_start - pilot_n_start
    peak_idx = int(torch.argmax(state.smooth_metric))
    return peak_idx, peak_idx - pilot_n_start


def run_sequence_comparison(
    channel_name: str | None,
    seq_types: tuple[str, ...] = SEQ_TYPES,
    params: MinnRTLParams = DEFAULT_PARAMS,
    device: torch.device | str | None = None,
) -> list[dict]:
    """Peak-to-sidelobe quality of the preamble's base sequences, best PMR
    first; prints the table (reference minn_rtl.py:1187-1328)."""
    sys = SYS_30M72
    dev = resolve_device(device)
    results = []
    for seq_type in seq_types:
        p = dataclasses.replace(params, seq_type=seq_type)
        setup, state, result = _detect_two_frames(p, channel_name, dev)
        peak_idx, timing_error = _first_peak(setup, state, result, p)
        q = _metric_quality(report.host(state.corr_positive), peak_idx, sys.tx_pre_pad)
        results.append({"seq_type": seq_type, "peak_idx": peak_idx,
                        "timing_error": timing_error, **q})
    results.sort(key=lambda r: -r["pmr"])
    desc = f"Measured CIR '{channel_name}'" if channel_name else "Flat AWGN"
    report.banner(f"SEQUENCE COMPARISON - {desc.upper()}")
    print(f"{'Sequence':<15} {'Peak':>10} {'Noise Avg':>12} {'Noise Max':>12} "
          f"{'PAR':>8} {'PMR':>8} {'Timing Err':>12}")
    for r in results:
        print(f"{r['seq_type']:<15} {r['peak_val']:>10.1f} {r['noise_floor']:>12.1f} "
              f"{r['noise_max']:>12.1f} {r['par']:>8.1f} {r['pmr']:>8.1f} "
              f"{r['timing_error']:>+12d}")
    return results


def compare_q_values(
    q_values: list[int],
    channel_name: str | None = None,
    params: MinnRTLParams = DEFAULT_PARAMS,
    device: torch.device | str | None = None,
) -> dict[int, dict]:
    """Detection quality against the segment length Q (reference
    minn_rtl.py:1493-1592)."""
    sys = SYS_30M72
    dev = resolve_device(device)
    out: dict[int, dict] = {}
    for Q in q_values:
        p = dataclasses.replace(params, quarter_len=Q)
        setup, state, result = _detect_two_frames(p, channel_name, dev)
        peak_idx, timing_error = _first_peak(setup, state, result, p)
        q = _metric_quality(report.host(state.corr_positive), peak_idx, sys.tx_pre_pad)
        out[Q] = {
            "peak": q["peak_val"],
            "par": q["par"],
            "pmr": q["pmr"],
            "timing_error": timing_error,
            "preamble_len": 5 * Q,
            "overhead_pct": 100.0 * 5 * Q / setup.extras["frame_len"],
        }
    return out


def plot_q_comparison(
    channel_name: str | None,
    q_values: tuple[int, ...] = (128, 256, 512),
    snr_values: tuple[float, ...] = (-5.0, 0.0, 5.0, 10.0),
    params: MinnRTLParams = DEFAULT_PARAMS,
    device: torch.device | str | None = None,
) -> None:
    """Per-SNR overlay of the smoothed Minn-RTL metric for each segment
    length Q (reference minn_rtl.py:1620-1731; artifact set
    plots/minn_rtl/q_comparison/); detection on ``device``."""
    plt = report.pyplot()
    dev = resolve_device(device)
    cond = "measured_channel" if channel_name else "flat_awgn"
    out_dir = common.PLOTS_ROOT / "minn_rtl" / "q_comparison"
    out_dir.mkdir(parents=True, exist_ok=True)
    for snr_db in snr_values:
        fig, ax = plt.subplots(figsize=(11, 5))
        for Q in q_values:
            p = dataclasses.replace(params, quarter_len=Q)
            _, state, _ = _detect_two_frames(p, channel_name, dev, snr_db)
            sm = report.host(state.smooth_metric)
            ax.plot(sm / max(sm.max(), 1e-12), label=f"Q={Q}", linewidth=0.9)
        ax.set_title(f"Minn-RTL smoothed metric vs Q - {cond}, SNR {snr_db:+.0f} dB")
        ax.set_xlabel("Sample offset")
        ax.set_ylabel("Normalized smoothed metric")
        ax.grid(True, alpha=0.4)
        ax.legend()
        fig.tight_layout()
        fig.savefig(out_dir / f"{cond}_q_comparison_snr{snr_db:+.0f}dB.png", dpi=110)
        plt.close(fig)
    print(f"Q comparison artifacts written to {out_dir}/")


def main(device: torch.device | str | None = None, plots: bool = True) -> None:
    report.banner("MINN RTL PREAMBLE SYNCHRONIZATION - DUAL CONDITION ANALYSIS")
    run_simulation(channel_name="cir1", plots_subdir="measured_channel" if plots else None,
                   device=device)
    run_simulation(channel_name=None, plots_subdir="flat_awgn" if plots else None,
                   device=device)
    run_sequence_comparison(channel_name=None, device=device)
    q_results = compare_q_values([128, 256, 512], device=device)
    report.banner("Q VALUE COMPARISON - FLAT AWGN")
    print(f"{'Q':>6} {'Peak':>10} {'PAR':>8} {'PMR':>8} "
          f"{'TimingErr':>10} {'PreLen':>8} {'Overhead%':>10}")
    for Q, r in q_results.items():
        print(f"{Q:>6d} {r['peak']:>10.1f} {r['par']:>8.1f} {r['pmr']:>8.1f} "
              f"{r['timing_error']:>+10d} {r['preamble_len']:>8d} "
              f"{r['overhead_pct']:>10.2f}")
    if plots:
        plot_q_comparison(None, device=device)
        plot_q_comparison("cir1", device=device)
    report.banner("ALL MINN RTL SIMULATIONS COMPLETE")


if __name__ == "__main__":
    main()
