"""Stimulus + channel for one simulation run (port of `SimSetup`,
`select_cir` and `build_setup` of `ofdm_sync_tpu.pipelines.common`)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ofdm_sync_tpu_torch.ops.channel import (
    apply_cfo,
    apply_channel,
    compute_channel_peak_offset,
    load_measured_cir,
)
from ofdm_sync_tpu_torch.ops.waveforms import assemble_frame, build_random_qpsk_symbol
from ofdm_sync_tpu_torch.params import SYS_30M72, SystemParams


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
