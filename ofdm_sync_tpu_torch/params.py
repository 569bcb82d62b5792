"""System and detector parameter dataclasses (the port's own copy of
`ofdm_sync_tpu.params`).

The port imports nothing of the JAX package, so it keeps these frozen
dataclasses and constants itself; tests/test_torch_port_boundary.py holds
every field of every constant equal to the JAX package's.  Configurations
are hashable and sweepable (reference core.py:6-10, sync_aa.py:99-125,
minn_rtl.py:828-846, zc_v2.py:112-158, ref/ofdm.py:15-31).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class SystemParams:
    """Core OFDM dimensions (reference core.py:6-10, ref/ofdm.py:15-31)."""

    n_fft: int = 2048
    num_active: int = 1200
    cp_len: int = 512
    sample_rate_hz: float = 30_720_000.0
    tx_pre_pad: int = 1337

    def __post_init__(self) -> None:
        if self.n_fft % 4:
            raise ValueError("FFT size must be divisible by 4.")
        if self.num_active % 2:
            raise ValueError("Active subcarrier count must be even to skip DC.")
        if self.num_active > self.n_fft:
            raise ValueError("Active subcarriers must fit inside the FFT.")
        if self.cp_len < 0:
            raise ValueError("Cyclic prefix length must be non-negative.")

    @property
    def half(self) -> int:
        return self.n_fft // 2

    @property
    def quarter(self) -> int:
        return self.n_fft // 4

    def replace(self, **kw) -> "SystemParams":
        return dataclasses.replace(self, **kw)


#: The 30.72 MHz wideband system every flat-script detector uses
#: (reference core.py:6-10).
SYS_30M72 = SystemParams()

#: The 10 MHz LTE-like system of the [A][A] detector and the FPGA design doc
#: (reference sync_aa.py:99-102).
SYS_AA_10M = SystemParams(
    n_fft=1024,
    num_active=600,
    cp_len=72,
    sample_rate_hz=15_360_000.0,
    tx_pre_pad=500,
)

#: The pedagogy demo system (reference ofdm_cp_fft_demo.py:6-8).
SYS_DEMO_512 = SystemParams(
    n_fft=512, num_active=512, cp_len=128, sample_rate_hz=30_720_000.0, tx_pre_pad=0
)


@dataclass(frozen=True)
class SCDetectorParams:
    """Schmidl-Cox plateau detector knobs (reference sc.py:150-156)."""

    sc_delta: int = 16
    smooth_win: int = 16
    plateau_frac: float = 0.95
    run_threshold: float = 0.6


@dataclass(frozen=True)
class MinnDetectorParams:
    """Standard Minn peak finder knobs (reference minn.py:288-294)."""

    smooth_win: int = 16
    gate_threshold: float = 0.5


@dataclass(frozen=True)
class MinnRTLParams:
    """Fixed-point RTL detector parameters.

    Mirrors the SystemVerilog parameter list (reference
    ref/minn_preamble_detector.sv:8-19) and the script defaults
    (reference minn_rtl.py:828-846).
    """

    quarter_len: int = 512
    smooth_shift: int = 3
    threshold_frac_bits: int = 15
    threshold_value: int = int(0.10 * (1 << 15))
    hysteresis: int = 2
    timing_offset: int = 0
    seq_type: str = "qpsk_freq"


@dataclass(frozen=True)
class ZCParams:
    """LTE-like PSS parameters (reference zc.py:30-31, zc_v2.py:115-116)."""

    pss_length: int = 62
    pss_root: int = 25


@dataclass(frozen=True)
class ZCStreamingParams:
    """FPGA-friendly CFAR detection parameters (reference zc_v2.py:119-158)."""

    corr_window: int = 2048
    threshold_frac_bits: int = 15
    threshold_value: int = int(4.0 * (1 << 15) / 2048)
    min_corr_mag: float = 0.3
    hysteresis: int = 256


@dataclass(frozen=True)
class AADetectorParams:
    """[A][A] streaming detector parameters (reference sync_aa.py:104-122)."""

    preamble_len: int = 1024
    threshold: float = 0.15
    hysteresis: int = 128
    adc_bits: int = 12

    @property
    def half_len(self) -> int:
        return self.preamble_len // 2
