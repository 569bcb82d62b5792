"""Shared simulation plumbing (port of `ofdm_sync_tpu.pipelines.common`):
the stimulus + channel of one run (`SimSetup`, `select_cir`,
`build_setup`), the receive stages after detection (`post_detection_chain`),
the report blocks every pipeline prints and the plot artifacts every
simulation shares (`emit_standard_artifacts`, `emit_ls_cir_artifact`),
written under ``plots/<detector>/<subdir>/`` (`make_plots_dir`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ofdm_sync_tpu_torch.ops.channel import (
    apply_cfo,
    apply_channel,
    compute_channel_peak_offset,
    load_measured_cir,
)
from ofdm_sync_tpu_torch.ops.estimate import (
    align_complex_gain,
    equalize,
    estimate_cfo_from_cp,
    estimate_timing_offset_from_phase_slope,
    evm_rms_db,
    ls_channel_estimate,
    reconstruct_cir_from_ls,
)
from ofdm_sync_tpu_torch.ops.waveforms import (
    assemble_frame,
    build_random_qpsk_symbol,
    ofdm_fft_used,
)
from ofdm_sync_tpu_torch.params import SYS_30M72, SystemParams
from ofdm_sync_tpu_torch.utils import report

PLOTS_ROOT = Path("plots")


@dataclass
class SimSetup:
    """Stimulus + channel for one run; ``rx`` is a complex64 tensor on the
    run's device, the rest host NumPy."""

    sys: SystemParams
    tx: np.ndarray
    rx: torch.Tensor
    pilot_symbol: np.ndarray
    pilot_used: np.ndarray
    data_symbol: np.ndarray
    data_used: np.ndarray
    cir: np.ndarray | None
    channel_name: str | None
    channel_peak_offset: int
    cfo_hz: float
    extras: dict = field(default_factory=dict)

    @property
    def channel_desc(self) -> str:
        return f"Measured CIR '{self.channel_name}'" if self.channel_name else "Flat AWGN"

    @property
    def true_cp_start(self) -> int:
        return self.sys.tx_pre_pad + self.channel_peak_offset


def select_cir(channel_name: str | None, mode: str) -> np.ndarray | None:
    """Branch selection of the reference scripts: 'ch1' -> RX channel 1,
    'two' -> the first two RX channels, 'all' -> the full bank."""
    if channel_name is None:
        return None
    bank = load_measured_cir(channel_name)
    if mode == "ch1":
        return bank[1:2]
    if mode == "two":
        return bank[:2].copy() if bank.shape[0] > 2 else bank.copy()
    if mode == "all":
        return bank.copy()
    raise ValueError(f"unknown CIR selection mode '{mode}'")


def build_setup(
    preamble: np.ndarray,
    rng: np.random.Generator,
    *,
    sys: SystemParams = SYS_30M72,
    channel_name: str | None,
    cir_mode: str,
    snr_db: float,
    cfo_hz: float,
    two_frames: bool = False,
    device: torch.device | str | None = None,
) -> SimSetup:
    """Assemble [pad | preamble | pilot | data] (optionally doubled with an
    inter-frame guard), apply channel + CFO.  The NumPy RNG is called in the
    reference's order, so a seed gives the same stimulus as the JAX
    package."""
    pilot_symbol, pilot_used = build_random_qpsk_symbol(rng, sys, include_cp=True)
    data_symbol, data_used = build_random_qpsk_symbol(rng, sys, include_cp=True)
    frame = np.concatenate((preamble, pilot_symbol, data_symbol))
    if two_frames:
        inter_guard = np.zeros(frame.size, dtype=complex)
        tx = np.concatenate(
            (np.zeros(sys.tx_pre_pad, dtype=complex), frame, inter_guard, frame))
    else:
        tx = assemble_frame(frame, pre_pad=sys.tx_pre_pad)

    cir = select_cir(channel_name, cir_mode)
    rx = apply_channel(tx, snr_db, rng, cir, device=device)
    rx = apply_cfo(torch.as_tensor(rx, device=device).to(torch.complex64), cfo_hz,
                   sys.sample_rate_hz)
    return SimSetup(
        sys=sys,
        tx=tx,
        rx=rx,
        pilot_symbol=pilot_symbol,
        pilot_used=pilot_used,
        data_symbol=data_symbol,
        data_used=data_used,
        cir=cir,
        channel_name=channel_name,
        channel_peak_offset=compute_channel_peak_offset(cir),
        cfo_hz=cfo_hz,
        extras={"frame_len": frame.size},
    )


@dataclass
class PostDetection:
    cfo_est_hz: float
    h_est: np.ndarray
    slope_rad_per_bin: float
    timing_offset_samples: float
    gain: complex
    evm_rms: float
    evm_db: float
    xhat_aligned: np.ndarray


def post_detection_chain(setup: SimSetup, preamble_n_start_est: int,
                         plots_dir: Path | None = None,
                         detector_label: str = "") -> PostDetection:
    """CFO estimate on the pilot CP -> compensate -> antenna mean -> LS
    channel estimate on the pilot -> STO from the phase slope -> equalize
    the data symbol -> EVM (reference sc.py:274-310 and its clones), on the
    device of ``setup.rx``.  With ``plots_dir``, also writes the phase-slope
    and constellation plots, titled with ``detector_label``; the slope and
    STO are the estimator's either way."""
    sys = setup.sys
    rx = setup.rx
    n_fft, cp, fs = sys.n_fft, sys.cp_len, sys.sample_rate_hz
    pilot_cp_start = preamble_n_start_est + n_fft
    cfo_est = float(estimate_cfo_from_cp(rx, pilot_cp_start, n_fft, cp, fs))
    rx_corr = apply_cfo(rx, -cfo_est, fs)
    rx_eff = rx_corr.mean(dim=0) if rx_corr.ndim == 2 else rx_corr

    def used(values: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(values, device=rx.device).to(torch.complex64)

    pilot_td = rx_eff[pilot_cp_start + cp: pilot_cp_start + cp + n_fft]
    h_est = ls_channel_estimate(ofdm_fft_used(pilot_td, sys), used(setup.pilot_used))
    slope, sto = estimate_timing_offset_from_phase_slope(h_est, n_fft, sys.num_active)
    if plots_dir is not None:
        report.plot_phase_slope(
            h_est, plots_dir / "phase_slope_sto.png",
            f"Residual Timing From Phase Slope ({detector_label}, {setup.channel_desc})",
            n_fft, sys.num_active)

    data_cp_start = pilot_cp_start + cp + n_fft
    data_td = rx_eff[data_cp_start + cp: data_cp_start + cp + n_fft]
    xhat = equalize(ofdm_fft_used(data_td, sys), h_est)
    data_used = used(setup.data_used)
    xhat_aligned, gain = align_complex_gain(xhat, data_used)
    evm, evm_db = evm_rms_db(xhat_aligned, data_used)
    if plots_dir is not None:
        report.plot_constellation(
            xhat_aligned, setup.data_used, plots_dir / "constellation.png",
            f"Equalized Data Constellation ({detector_label}, {setup.channel_desc})")
    return PostDetection(
        cfo_est_hz=cfo_est,
        h_est=h_est.cpu().numpy(),
        slope_rad_per_bin=float(slope),
        timing_offset_samples=float(sto),
        gain=complex(gain),
        evm_rms=float(evm),
        evm_db=float(evm_db),
        xhat_aligned=xhat_aligned.cpu().numpy(),
    )


def emit_standard_artifacts(setup: SimSetup, plots_dir: Path, detector_label: str) -> None:
    """tx/rx time series + channel CIR plots shared by every sim."""
    report.plot_time_series(
        setup.tx, "Transmit Frame (with Leading Zeros)", plots_dir / "tx_frame_time.png")
    report.plot_time_series(
        setup.rx, f"Received Frame After Channel ({setup.channel_desc})",
        plots_dir / "rx_frame_time.png")
    if setup.cir is not None:
        report.plot_time_series(
            setup.cir, f"Measured Channel CIR ('{setup.channel_name}')",
            plots_dir / "channel_cir.png")


def emit_ls_cir_artifact(setup: SimSetup, post: PostDetection, timing_error: int,
                         plots_dir: Path, detector_label: str) -> None:
    ls_cir = reconstruct_cir_from_ls(torch.from_numpy(post.h_est), setup.sys.n_fft,
                                     setup.sys.num_active)
    report.plot_ls_cir(
        ls_cir, setup.cir, setup.channel_peak_offset, timing_error,
        plots_dir / "ls_cir.png", f"LS-Derived CIR ({detector_label}, {setup.channel_desc})")


def print_common_header(setup: SimSetup, title: str) -> None:
    report.banner(f"{title} - {setup.channel_desc.upper()}")
    print(f"Transmit sequence length: {setup.tx.size} samples")
    print(f"Receive branches: {setup.rx.shape[0] if setup.rx.ndim == 2 else 1}")
    if setup.cir is not None:
        print(
            f"Applied measured channel '{setup.channel_name}' using "
            f"{setup.cir.shape[0]} RX branch(es) taps={setup.cir.shape[1]} "
            f"main-path offset={setup.channel_peak_offset}"
        )
    else:
        print("Channel profile: Flat AWGN (no multipath)")


def print_cfo_block(applied: float, estimated: float) -> None:
    print("\nCarrier Frequency Offset:")
    print(f"  Applied CFO: {applied} Hz")
    print(f"  Estimated CFO from CP: {estimated:.2f} Hz")
    err = abs(estimated - applied)
    pct = err / applied * 100 if applied else float("inf")
    print(f"  CFO error: {err:.2f} Hz ({pct:.1f}%)")


def print_eq_block(post: PostDetection) -> None:
    print("\nChannel Estimation & Equalization:")
    print(
        f"  Pilot LS phase slope: {post.slope_rad_per_bin:.6f} rad/bin "
        f"-> timing ~ {post.timing_offset_samples:.2f} samples"
    )
    print(
        f"  Post-EQ complex gain (mag, angle): "
        f"{abs(post.gain):.3f}, {np.angle(post.gain):.3f} rad"
    )
    print(f"  EVM RMS: {100 * post.evm_rms:.2f}%  ({post.evm_db:.2f} dB)")


def make_plots_dir(detector: str, subdir: str) -> Path:
    d = PLOTS_ROOT / detector / subdir
    d.mkdir(parents=True, exist_ok=True)
    return d
