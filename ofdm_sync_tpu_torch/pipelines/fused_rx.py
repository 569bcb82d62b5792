"""The receive chains end to end (port of `ofdm_sync_tpu.pipelines.fused_rx`).

* `run_fused_rx`: the [A][A] chain on the 10 MHz AA system: frames through
  a 2-antenna channel, CFO and a 12-bit ADC -> fused [A][A] detection
  (kernels C + B) with (P, M) captured at each peak -> aligned frame
  re-emission -> CFO from the event table -> LS channel estimate on the
  pilot -> equalize the data symbol -> EVM, per frame.
* `run_fused_rx_minn_rtl`: the flagship Minn-RTL chain (reference
  minn_rtl.py:884-889: [pad | frame | guard | frame]) -> fused Minn-RTL
  detection (kernels A + B) -> aligned frame re-emission -> per frame:
  CP-based CFO on the pilot CP -> LS channel estimate -> equalize -> EVM.

Everything after the host-built stimulus runs on ``device``: the CUDA
kernels on a card, their plain versions on the CPU.

Run: ``python -m ofdm_sync_tpu_torch fused_rx [--family aa|minn_rtl]
[--snr 10] [--channel cir1] [--cfo 500] [--num-frames 2] [--device cuda]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.models.detectors import AADetector, MinnRTLDetector
from ofdm_sync_tpu_torch.ops.channel import (
    apply_cfo,
    apply_channel_multi_antenna,
    compute_clipping_stats,
    quantize_adc,
)
from ofdm_sync_tpu_torch.ops.estimate import (
    align_complex_gain,
    equalize,
    estimate_cfo_from_cp,
    evm_rms_db,
    ls_channel_estimate,
)
from ofdm_sync_tpu_torch.ops.waveforms import (
    build_aa_preamble,
    build_aa_qpsk_symbol,
    build_minn_rtl_preamble,
    ofdm_fft_used,
)
from ofdm_sync_tpu_torch.params import AADetectorParams, MinnRTLParams, SYS_30M72, SYS_AA_10M
from ofdm_sync_tpu_torch.pipelines import common
from ofdm_sync_tpu_torch.utils import report


SNR_DB = 10.0
CFO_HZ = 500.0
PREAMBLE_LEN = 1024
FULL_SCALE_RATIO = 2.0
SEED = 42


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


def _demod(frame_planar: torch.Tensor, cfo_est: float, offsets: tuple[int, int], sys_p,
           pilot_used: torch.Tensor, data_used: torch.Tensor):
    """Receive stages of one re-emitted frame on its device: CFO
    correction, antenna combine, pilot LS channel estimate, equalize the
    data symbol, EVM.  Returns (evm_pct, evm_db, gain)."""
    ants = torch.complex(frame_planar[0::2], frame_planar[1::2])
    combined = apply_cfo(ants, -cfo_est, sys_p.sample_rate_hz).mean(dim=0)
    pilot_off, data_off = offsets
    n_fft = sys_p.n_fft
    pilot_bins = ofdm_fft_used(combined[pilot_off: pilot_off + n_fft], sys_p)
    data_bins = ofdm_fft_used(combined[data_off: data_off + n_fft], sys_p)
    h_est = ls_channel_estimate(pilot_bins, pilot_used)
    eq_aligned, gain = align_complex_gain(equalize(data_bins, h_est), data_used)
    evm_rms, evm_db = evm_rms_db(eq_aligned, data_used)
    return 100.0 * float(evm_rms), float(evm_db), complex(gain)


def run_fused_rx(
    snr_db: float = SNR_DB,
    channel_name: str | None = None,
    cfo_hz: float = CFO_HZ,
    preamble_length: int = PREAMBLE_LEN,
    full_scale_ratio: float = FULL_SCALE_RATIO,
    seed: int = SEED,
    num_frames: int = 1,
    device: torch.device | str | None = None,
) -> FusedRxResult:
    """Synthesize ``num_frames`` [A][A] frames, receive them through the
    fused detector, re-emit each aligned frame window on the device and
    demodulate it; prints the same report as the JAX pipeline."""
    dev = resolve_device(device)
    sys_p = SYS_AA_10M
    fs = sys_p.sample_rate_hz
    rng = np.random.default_rng(seed)

    # --- transmit: [pad | frame | gap | frame ... | pad] ------------------
    preamble, _, papr_db = build_aa_preamble(preamble_length, sys_p)
    pilot_symbol, pilot_used = build_aa_qpsk_symbol(rng, sys_p)
    data_symbol, data_used = build_aa_qpsk_symbol(rng, sys_p)
    frame = np.concatenate([preamble, pilot_symbol, data_symbol])
    flen = frame.shape[0]
    parts = [np.zeros(sys_p.tx_pre_pad, complex)]
    tx_starts = []
    pos = sys_p.tx_pre_pad
    for k in range(num_frames):
        parts.append(frame)
        tx_starts.append(pos)
        pos += flen
        if k < num_frames - 1:
            parts.append(np.zeros(flen, complex))
            pos += flen
    parts.append(np.zeros(500, complex))
    tx = np.concatenate(parts)

    # --- channel + CFO + 12-bit ADC (reference sync_aa.py:712-735) --------
    rx, _cir, channel_peak_offset = apply_channel_multi_antenna(
        tx, snr_db, rng, channel_name, num_rx_antennas=2, device=dev)
    true_starts = [s + channel_peak_offset for s in tx_starts]
    rx = apply_cfo(torch.as_tensor(rx, device=dev).to(torch.complex64), cfo_hz, fs)
    # full scale and clipping from the complex64 samples on the host, as
    # the JAX pipeline takes them (a 1-ulp change moves round() at .5)
    rx_host = rx.cpu().numpy()
    full_scale = float(np.sqrt(np.mean(np.abs(rx_host) ** 2)) * full_scale_ratio)
    clip = compute_clipping_stats(rx_host.flatten(), full_scale)
    rx_q = quantize_adc(rx, full_scale)

    # --- detect + re-emit aligned frames, all on the device ---------------
    det = AADetector(sys_p, AADetectorParams(preamble_len=preamble_length))
    result, frames, starts, valid = det.detect_fused_frames(rx_q, frame_len=flen, max_frames=4)
    best = AADetector.best(result)
    starts_h = starts.cpu().numpy()
    valid_h = valid.cpu().numpy()

    channel_str = channel_name if channel_name else "awgn"
    report.banner(
        f"FUSED-KERNEL RECEIVE CHAIN - [A][A] {preamble_length}, "
        f"{channel_str.upper()}, SNR {snr_db:+.0f} dB"
    )
    print(f"Stream: {rx_q.shape[1]} samples x {rx_q.shape[0]} antennas, "
          f"12-bit ADC (clipping {clip['total_clip_pct']:.2f}%), "
          f"preamble PAPR {papr_db:.2f} dB, {num_frames} frame(s) sent")
    if best is None or not valid_h.any():
        print("NO DETECTION -- receiver idle")
        return FusedRxResult(False, -1, float("nan"), float("nan"), float("nan"))

    n_det = int(valid_h.sum())
    print(f"\nDetection (in-kernel event table -> device-side frame "
          f"re-emission, {n_det} frame window(s)):")

    pilot_off = preamble_length + sys_p.cp_len
    data_off = pilot_off + sys_p.n_fft + sys_p.cp_len
    pilot_t = torch.as_tensor(pilot_used, device=dev).to(torch.complex64)
    data_t = torch.as_tensor(data_used, device=dev).to(torch.complex64)
    frame_results: list[FrameResult] = []
    events = result.events
    for k in range(n_det):
        ev = events[k] if k < len(events) else None
        tstart = true_starts[k] if k < len(true_starts) else true_starts[-1]
        timing_err = int(starts_h[k]) - tstart
        cfo_est = ev.cfo_hz if ev is not None else 0.0
        cfo_err = cfo_est - cfo_hz
        # local-index CFO correction: the constant phase offset against the
        # stream-absolute correction is absorbed by the LS estimate
        evm_pct, evm_db, gain = _demod(frames[k], cfo_est, (pilot_off, data_off), sys_p,
                                       pilot_t, data_t)
        frame_results.append(FrameResult(timing_err, float(cfo_err), evm_pct, evm_db))
        print(f"  Frame {k}: start {int(starts_h[k])} (true {tstart}, "
              f"error {timing_err:+d}), CFO {cfo_est:.2f} Hz "
              f"(error {cfo_err:+.2f}), EVM {evm_pct:.2f}% "
              f"({evm_db:.2f} dB), gain {abs(gain):.3f}")
        if abs(timing_err) > sys_p.cp_len:
            # the multipath group-delay offset (+77..+94 samples, reference
            # docs/aa_preamble_sync_design.md section 13) exceeds this
            # system's 72-sample CP: ISI degrades the EQ below
            print(f"    NOTE: timing error exceeds the {sys_p.cp_len}-sample "
                  "CP (multipath group delay) -- expect ISI")

    first = frame_results[0]
    print(f"\n  Gate [{best.gate_start}, {best.gate_end}], peak metric "
          f"M={best.metric_at_peak:.3f}, events={len(result.events)}")
    print(report.BANNER)
    return FusedRxResult(
        True, first.timing_error, first.cfo_error_hz, first.evm_pct,
        first.evm_db, frames=frame_results,
        starts=[int(s) for s in starts_h[:n_det]],
    )


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
    data_n_off = pilot_n_off + n_fft + cp
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
        evm_pct, evm_db, _gain = _demod(fp, cfo_est, (pilot_n_off, data_n_off), sys_p,
                                        pilot_used, data_used)
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
    ap.add_argument("--family", default="aa", choices=("aa", "minn_rtl"),
                    help="aa: 10 MHz [A][A] system; minn_rtl: the flagship "
                    "Minn-RTL 30.72 MHz family")
    ap.add_argument("--snr", type=float, default=None)
    ap.add_argument("--channel", default=None, help="cir1 / cir2 / omit for AWGN")
    ap.add_argument("--cfo", type=float, default=None)
    ap.add_argument("--preamble-len", type=int, default=PREAMBLE_LEN)
    ap.add_argument("--num-frames", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")


def run_cli(args) -> FusedRxResult:
    if args.family == "minn_rtl":
        return run_fused_rx_minn_rtl(
            snr_db=args.snr if args.snr is not None else 0.0,
            channel_name=args.channel,
            cfo_hz=args.cfo if args.cfo is not None else 1000.0,
            device=args.device)
    return run_fused_rx(
        snr_db=args.snr if args.snr is not None else SNR_DB,
        channel_name=args.channel,
        cfo_hz=args.cfo if args.cfo is not None else CFO_HZ,
        preamble_length=args.preamble_len,
        num_frames=args.num_frames,
        device=args.device)


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    add_cli_args(ap)
    run_cli(ap.parse_args(argv))


if __name__ == "__main__":
    main()
