"""Build and load the hand-written CUDA kernels of `kernels/csrc/`.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
library with a plain C interface, loaded with `ctypes`.  The build runs at
first use into ``kernels/_build/<hash of the sources>/`` (listed in
.gitignore), so a fresh checkout builds itself; a second process finds the
library already there.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
LIB_NAME = "libofdm_sync_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double

#: C signatures of the library's entry points (all return cudaError_t).
SIGNATURES = {
    "minn_rtl_metric": [_I, _I, _P, _P, _P, _I, _I, _LL, _LL, _LL, _I, _I, _I, _I, _LL, _F,
                        _LL, _F, _F, _P, _P, _P, _P, _P, _P, _P],
    "minn_rtl_step": [_I, _P, _LL, _LL, _P, _I, _P, _P, _I, _I, _LL, _I, _LL, _F, _LL, _F, _F,
                      _I, _I, _I, _LL, *[_P] * 11, _P],
    "gate_events_f32": [_P, _P, _I, _LL, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                        _I, _LL, _P, _P, _P, _I, _P],
    "aa_metric": [_I, _I, _P, _P, _I, _I, _LL, _I, _I, _LL, _F, _F, _P, _P, _P, _P, _P, _P, _P,
                  _P],
    "aa_peak_capture": [_P, _P, _I, _I, _LL, _I, _I, _LL, _F, _P, _P],
    "zc_cfar_mag_f32": [_P, _P, _I, _LL, _I, _I, _LL, _F, _F, _F, _P, _P],
    "zc_cfar_iq": [_I, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _LL, _I, _F, _F, _F, _F,
                   _P, _P, _P, _P],
    "matched_filter_f32": [_P, _P, _P, _I, _I, _LL, _I, _LL, _I, _P, _P],
    "minn_rx_front": [_I, _P, _I, _I, _LL, _LL, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I,
                      _LL, _D, _P, _P, _P, _P, _P],
    "minn_rx_back": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class BuildInfo:
    """Where the library is, how long the build took (0 if it was cached)
    and what ptxas reported."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path, self.seconds, self.log = path, seconds, log


@functools.lru_cache(maxsize=None)
def build() -> BuildInfo:
    """Compile the kernels if this source hash has no library yet."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return BuildInfo(lib, 0.0, (out_dir / "build.log").read_text()
                         if (out_dir / "build.log").exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    common = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp_dir, src.stem + ".o")
            cmd = [*common, "-Xptxas", "-v", "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        log, failed = "", []
        for cmd, proc in procs:
            out = proc.communicate()[0]
            log += out
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        # link into a private name, then rename: concurrent builds never
        # load a half-written library
        tmp_lib = os.path.join(tmp_dir, LIB_NAME)
        link = [*common, "-shared", "-o", tmp_lib, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stdout}{proc.stderr}")
        seconds = time.perf_counter() - t0
        (out_dir / "build.log").write_text(log)
        os.replace(tmp_lib, lib)
    return BuildInfo(lib, seconds, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with argtypes set for every entry."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ofdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ofdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().ofdm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
