"""ctypes binding of the C++ integer models of the reference's RTL
detectors (`native/src/minn_rtl.cc`), the port's own copy of what it needs
from `ofdm_sync_tpu.native`.

The C++ models are bit-accurate fixed-point versions of the reference's
SystemVerilog modules: the independent integer oracle the float paths and
the CUDA kernels are held against (the role Verilator co-simulation plays
in the reference, ref/test_minn_preamble_detector.py:455-489), and a
host-side streaming detector.

The source is a file of the repo, read as is.  It is built with ``g++`` at
first use into ``kernels/_build/native-<hash of the source>/`` (listed in
.gitignore), away from the JAX package's ``native/build/``, so the two
never race; a second process finds the library already there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "src" / "minn_rtl.cc"
BUILD_ROOT = Path(__file__).resolve().parent / "kernels" / "_build"

#: the C++ library's ABI version (`minn_rtl_abi_version()`)
_ABI_VERSION = 2


class NativeBuildError(RuntimeError):
    pass


def lib_path() -> Path:
    """Where the library of this source is built."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / f"native-{digest}" / "libminn_rtl.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    # a per-process name, renamed into place: concurrent processes may race
    tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(f"native build failed: {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)


class _Params(ctypes.Structure):
    _fields_ = [
        ("quarter_len", ctypes.c_int32),
        ("smooth_shift", ctypes.c_int32),
        ("frac_bits", ctypes.c_int32),
        ("threshold_value", ctypes.c_int64),
        ("hysteresis", ctypes.c_int32),
        ("emit_unclosed", ctypes.c_int32),
        ("timing_offset", ctypes.c_int32),
    ]


class _AAParams(ctypes.Structure):
    _fields_ = [
        ("half_len", ctypes.c_int32),
        ("threshold_q", ctypes.c_int64),
        ("frac_bits", ctypes.c_int32),
        ("hysteresis", ctypes.c_int32),
        ("emit_unclosed", ctypes.c_int32),
    ]


class _Optional:
    """A nullable array argument: None passes a null pointer."""

    def __init__(self, ptr_type):
        self.ptr_type = ptr_type

    def from_param(self, obj):
        return None if obj is None else self.ptr_type.from_param(obj)


_lib: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native library; its ABI version must
    be the one this binding was written for."""
    global _lib
    if _lib is not None:
        return _lib
    path = lib_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    lib.minn_rtl_abi_version.restype = ctypes.c_int32
    if lib.minn_rtl_abi_version() != _ABI_VERSION:
        raise NativeBuildError(
            f"{SRC} has ABI {lib.minn_rtl_abi_version()}, this binding {_ABI_VERSION}")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    oi64, ou8 = _Optional(i64p), _Optional(u8p)
    lib.minn_rtl_detect_i16.restype = ctypes.c_int64
    lib.minn_rtl_detect_i16.argtypes = [
        i16p, ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(_Params),
        i32p, i32p, i32p, f64p, u8p, ctypes.c_int32, oi64, oi64, oi64, ou8]
    lib.aa_detect_i16.restype = ctypes.c_int64
    lib.aa_detect_i16.argtypes = [
        i16p, ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(_AAParams),
        i32p, i32p, i32p, f64p, f64p, f64p, u8p, ctypes.c_int32, oi64, oi64, oi64, ou8]
    _lib = lib
    return lib


def _planar_i16(iq: np.ndarray) -> tuple[np.ndarray, int, int]:
    """(branches, 2, L) int16 C-contiguous IQ, with its branch count and L."""
    iq = np.ascontiguousarray(iq, dtype=np.int16)
    if iq.ndim == 2:  # (2, L): one branch
        iq = iq[None]
    branches, planes, n = iq.shape
    if planes != 2:
        raise ValueError("expected planar (branches, 2, L) IQ")
    return iq, branches, n


@dataclass
class NativeDetection:
    """Minn-RTL event table and, optionally, the integer traces."""

    count: int           # events stored (clipped to the capacity)
    total: int           # gates seen (overflow where > count)
    gate_start: np.ndarray
    gate_close: np.ndarray
    peak_idx: np.ndarray
    peak_value: np.ndarray
    closed: np.ndarray
    corr_total: np.ndarray | None = None
    energy_total: np.ndarray | None = None
    smooth: np.ndarray | None = None
    above: np.ndarray | None = None

    @property
    def overflow(self) -> bool:
        return self.total > self.count


def minn_rtl_detect_native(
    iq: np.ndarray,
    *,
    quarter_len: int,
    smooth_shift: int = 3,
    threshold_value: int = 3276,
    threshold_frac_bits: int = 15,
    hysteresis: int = 2,
    emit_unclosed: bool = False,
    timing_offset: int = 0,
    max_events: int = 8,
    return_traces: bool = False,
) -> NativeDetection:
    """The C++ integer Minn-RTL detector on planar int16 IQ.

    iq: (branches, 2, L) int16 ADC codes (int12 range, as
    `ops.channel.quantize_int` makes them).  The defaults are the RTL's
    parameters (reference minn_rtl.py:829-844).  ``return_traces`` adds the
    per-sample corr_total, energy_total, smooth (int64) and above (uint8)."""
    lib = load_library()
    iq, branches, n = _planar_i16(iq)
    p = _Params(quarter_len=quarter_len, smooth_shift=smooth_shift,
                frac_bits=threshold_frac_bits, threshold_value=threshold_value,
                hysteresis=hysteresis, emit_unclosed=int(emit_unclosed),
                timing_offset=timing_offset)
    start, close, peak = (np.zeros(max_events, np.int32) for _ in range(3))
    val = np.zeros(max_events, np.float64)
    closed = np.zeros(max_events, np.uint8)
    tc, te, ts = (np.zeros(n, np.int64) if return_traces else None for _ in range(3))
    ta = np.zeros(n, np.uint8) if return_traces else None
    total = lib.minn_rtl_detect_i16(iq, n, branches, ctypes.byref(p), start, close, peak,
                                    val, closed, max_events, tc, te, ts, ta)
    count = int(min(total, max_events))
    return NativeDetection(count=count, total=int(total), gate_start=start[:count],
                           gate_close=close[:count], peak_idx=peak[:count],
                           peak_value=val[:count], closed=closed[:count].astype(bool),
                           corr_total=tc, energy_total=te, smooth=ts, above=ta)


@dataclass
class NativeAADetection:
    """[A][A] event table and, optionally, the integer traces."""

    count: int
    total: int
    gate_start: np.ndarray
    gate_close: np.ndarray
    peak_idx: np.ndarray
    peak_value: np.ndarray   # |P|^2 at the peak
    p_at_peak: np.ndarray    # complex P at the peak: CFO = angle(P) fs / (2 pi L)
    closed: np.ndarray
    P_re: np.ndarray | None = None
    P_im: np.ndarray | None = None
    R: np.ndarray | None = None
    above: np.ndarray | None = None

    @property
    def overflow(self) -> bool:
        return self.total > self.count


def aa_detect_native(
    iq: np.ndarray,
    *,
    half_len: int = 512,
    threshold: float = 0.15,
    threshold_frac_bits: int = 15,
    hysteresis: int = 128,
    emit_unclosed: bool = True,
    max_events: int = 8,
    return_traces: bool = False,
) -> NativeAADetection:
    """The C++ fixed-point [A][A] detector on planar int16 IQ (branches, 2,
    L): the FPGA design's pipeline (reference docs/aa_preamble_sync_design.md
    sections 5-9) in exact integers, with a division-free 128-bit
    ``M >= threshold`` compare."""
    lib = load_library()
    iq, branches, n = _planar_i16(iq)
    p = _AAParams(half_len=half_len,
                  threshold_q=int(round(threshold * (1 << threshold_frac_bits))),
                  frac_bits=threshold_frac_bits, hysteresis=hysteresis,
                  emit_unclosed=int(emit_unclosed))
    start, close, peak = (np.zeros(max_events, np.int32) for _ in range(3))
    val, pre, pim = (np.zeros(max_events, np.float64) for _ in range(3))
    closed = np.zeros(max_events, np.uint8)
    tp, tq, tr = (np.zeros(n, np.int64) if return_traces else None for _ in range(3))
    ta = np.zeros(n, np.uint8) if return_traces else None
    total = lib.aa_detect_i16(iq, n, branches, ctypes.byref(p), start, close, peak, val, pre,
                              pim, closed, max_events, tp, tq, tr, ta)
    count = int(min(total, max_events))
    return NativeAADetection(count=count, total=int(total), gate_start=start[:count],
                             gate_close=close[:count], peak_idx=peak[:count],
                             peak_value=val[:count], p_at_peak=pre[:count] + 1j * pim[:count],
                             closed=closed[:count].astype(bool), P_re=tp, P_im=tq, R=tr,
                             above=ta)
