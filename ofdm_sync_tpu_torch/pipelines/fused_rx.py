"""The flagship receive chain end to end (port of
`ofdm_sync_tpu.pipelines.fused_rx.run_fused_rx_minn_rtl`).

Two-frame Minn-RTL stimulus on the 30.72 MHz system (reference
minn_rtl.py:884-889: [pad | frame | guard | frame]) -> fused detection ->
aligned frame re-emission -> per frame: CP-based CFO on the pilot CP ->
LS channel estimate from the pilot -> equalize the data symbol -> EVM.
Everything after the host-built stimulus runs on ``device``: the CUDA
kernels on a card, their plain versions on the CPU.

Run: ``python -m ofdm_sync_tpu_torch fused_rx --family minn_rtl
[--snr 0] [--channel cir1] [--cfo 1000] [--device cuda]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.models.detectors import MinnRTLDetector
from ofdm_sync_tpu_torch.ops.channel import apply_cfo
from ofdm_sync_tpu_torch.ops.estimate import (
    align_complex_gain,
    equalize,
    estimate_cfo_from_cp,
    evm_rms_db,
    ls_channel_estimate,
)
from ofdm_sync_tpu_torch.ops.waveforms import build_minn_rtl_preamble, ofdm_fft_used
from ofdm_sync_tpu_torch.params import MinnRTLParams, SYS_30M72
from ofdm_sync_tpu_torch.pipelines import common
from ofdm_sync_tpu_torch.utils import report


@dataclass
class FrameResult:
    timing_error: int
    cfo_error_hz: float
    evm_pct: float
    evm_db: float


@dataclass
class FusedRxResult:
    detected: bool
    timing_error: int
    cfo_error_hz: float
    evm_pct: float
    evm_db: float
    frames: list = field(default_factory=list)  # per-frame FrameResult
    starts: list = field(default_factory=list)  # detected frame starts


def run_fused_rx_minn_rtl(
    snr_db: float = 0.0,
    channel_name: str | None = None,
    cfo_hz: float = 1000.0,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> FusedRxResult:
    """Synthesize two Minn-RTL frames, detect them with the fused detector,
    re-emit each aligned frame window and demodulate it; prints the same
    report as the JAX pipeline."""
    dev = resolve_device(device)
    sys_p = SYS_30M72
    params = MinnRTLParams()
    Q = params.quarter_len
    fs = sys_p.sample_rate_hz
    rng = np.random.default_rng(seed)

    preamble = build_minn_rtl_preamble(params.seq_type, rng, Q=Q, sys=sys_p)
    setup = common.build_setup(
        preamble, rng, sys=sys_p, channel_name=channel_name, cir_mode="two",
        snr_db=snr_db, cfo_hz=cfo_hz, two_frames=True, device=dev)
    frame_len = setup.extras["frame_len"]
    # margin so the SECOND frame's window fits after channel group delay
    margin = sys_p.cp_len + 256
    rx = torch.cat([setup.rx, setup.rx.new_zeros((setup.rx.shape[0], margin))], dim=-1)
    true_starts = [
        sys_p.tx_pre_pad + setup.channel_peak_offset,
        sys_p.tx_pre_pad + 2 * frame_len + setup.channel_peak_offset,
    ]

    det = MinnRTLDetector(sys_p, params)
    result, frames, starts, valid = det.detect_fused_frames(
        rx, frame_len=frame_len, max_frames=4)
    starts_h = starts.cpu().numpy()
    valid_h = valid.cpu().numpy()

    channel_str = channel_name if channel_name else "awgn"
    report.banner(
        f"FUSED-KERNEL RECEIVE CHAIN - MINN-RTL Q={Q} (30.72 MHz), "
        f"{channel_str.upper()}, SNR {snr_db:+.0f} dB"
    )
    kind = "CUDA kernels" if dev.type == "cuda" else "plain PyTorch"
    print(f"Stream: {rx.shape[1]} samples x {rx.shape[0]} branch(es), "
          f"2 frames sent, frame_len {frame_len}; detector: fused "
          f"Minn-RTL detect ({kind})")
    if not valid_h.any():
        print("NO DETECTION -- receiver idle")
        return FusedRxResult(False, -1, float("nan"), float("nan"), float("nan"))

    n_det = int(valid_h.sum())
    print(f"\nDetection (in-kernel event table -> device-side frame "
          f"re-emission, {n_det} frame window(s)):")

    n_fft, cp = sys_p.n_fft, sys_p.cp_len
    pilot_cp_off = 5 * Q                        # local frame layout
    pilot_n_off = pilot_cp_off + cp
    data_cp_off = pilot_n_off + n_fft
    data_n_off = data_cp_off + cp
    pilot_used = torch.as_tensor(setup.pilot_used, device=dev).to(torch.complex64)
    data_used = torch.as_tensor(setup.data_used, device=dev).to(torch.complex64)

    frame_results: list[FrameResult] = []
    for k in range(n_det):
        tstart = true_starts[k] if k < len(true_starts) else true_starts[-1]
        timing_err = int(starts_h[k]) - tstart
        fp = frames[k]  # planar (2*branches, frame_len) float32
        ants = torch.complex(fp[0::2], fp[1::2])
        cfo_est = float(estimate_cfo_from_cp(ants, pilot_cp_off, n_fft, cp, fs))
        cfo_err = cfo_est - cfo_hz
        combined = apply_cfo(ants, -cfo_est, fs).mean(dim=0)
        pilot_bins = ofdm_fft_used(combined[pilot_n_off: pilot_n_off + n_fft], sys_p)
        data_bins = ofdm_fft_used(combined[data_n_off: data_n_off + n_fft], sys_p)
        h_est = ls_channel_estimate(pilot_bins, pilot_used)
        eq_aligned, _gain = align_complex_gain(equalize(data_bins, h_est), data_used)
        evm_rms, evm_db = evm_rms_db(eq_aligned, data_used)
        evm_pct, evm_db = 100.0 * float(evm_rms), float(evm_db)
        frame_results.append(FrameResult(timing_err, float(cfo_err), evm_pct, evm_db))
        print(f"  Frame {k}: start {int(starts_h[k])} (true {tstart}, "
              f"error {timing_err:+d}), CFO {cfo_est:.2f} Hz "
              f"(error {cfo_err:+.2f}), EVM {evm_pct:.2f}% "
              f"({evm_db:.2f} dB)")

    if result.events:
        e0 = result.events[0]
        print(f"\n  Gate [{e0.gate_start}, {e0.gate_end}), peak metric "
              f"{e0.peak_value:.0f}, events={len(result.events)}")
    print(report.BANNER)
    first = frame_results[0]
    return FusedRxResult(
        True, first.timing_error, first.cfo_error_hz, first.evm_pct,
        first.evm_db, frames=frame_results,
        starts=[int(s) for s in starts_h[:n_det]],
    )


def add_cli_args(ap) -> None:
    ap.add_argument("--family", default="minn_rtl", choices=("minn_rtl",),
                    help="minn_rtl: the flagship Minn-RTL 30.72 MHz family "
                    "(the only family ported so far)")
    ap.add_argument("--snr", type=float, default=0.0)
    ap.add_argument("--channel", default=None, help="cir1 / cir2 / omit for AWGN")
    ap.add_argument("--cfo", type=float, default=1000.0)
    ap.add_argument("--device", default="cpu", help="cpu or cuda")


def run_cli(args) -> FusedRxResult:
    return run_fused_rx_minn_rtl(
        snr_db=args.snr, channel_name=args.channel, cfo_hz=args.cfo,
        device=args.device)


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    add_cli_args(ap)
    run_cli(ap.parse_args(argv))


if __name__ == "__main__":
    main()
