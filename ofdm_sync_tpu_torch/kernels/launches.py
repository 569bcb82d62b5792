"""Launch counts of the CUDA kernels.

Each kernel wrapper adds one to its ``.launches`` where it launches its
kernel on a card, and nowhere else (a CPU tensor runs the plain version and
counts nothing); at the same place it adds one to ``.modes[name]`` for each
mode the launch ran in (kernel A: ``corr_above`` / ``full`` /
``corr_energy``, ``primed``, ``strided`` for a view read in place, and
``exact_i16`` for int16 codes of up to two branches without a history,
which take its exact integer path; kernels B, C, D: ``primed``, the
carried-state mode, which for D is its magnitude mode; D's IQ mode with a
halo or a global base: ``primed_iq``; kernel F, the Minn-RTL stream step:
``int16`` for a chunk of int16 codes).  A run shows that it went through
the kernels by resetting the counts, driving its path and reading them.
Each wrapper's spans carry its name too (`utils.profiling.wrapper_spans`),
so a span, a launch count and a kernel line up.
"""

from __future__ import annotations

from ofdm_sync_tpu_torch.kernels.aa_fused import aa_metric
from ofdm_sync_tpu_torch.kernels.matched_filter import matched_filter_ols
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import gate_events, minn_rtl_metric, minn_rtl_step
from ofdm_sync_tpu_torch.kernels.zc_fused import zc_metric

#: one wrapper per kernel: A, B, C, D, E, F
KERNEL_WRAPPERS = (minn_rtl_metric, gate_events, aa_metric, zc_metric, matched_filter_ols,
                   minn_rtl_step)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        if hasattr(fn, "modes"):
            fn.modes.clear()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def mode_launch_counts() -> dict[str, int]:
    """Launches per kernel and mode, as ``"<kernel>/<mode>"``."""
    return {f"{fn.__name__}/{mode}": n for fn in KERNEL_WRAPPERS
            for mode, n in sorted(getattr(fn, "modes", {}).items())}
