"""Launch counts of the CUDA kernels.

Each kernel wrapper adds one to its ``.launches`` where it launches its
kernel on a card, and nowhere else (a CPU tensor runs the plain version and
counts nothing).  A run shows that it went through the kernels by resetting
the counts, driving its path and reading them.
"""

from __future__ import annotations

from ofdm_sync_tpu_torch.kernels.aa_fused import aa_metric
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import gate_events, minn_rtl_metric

#: one wrapper per kernel: A, B, C
KERNEL_WRAPPERS = (minn_rtl_metric, gate_events, aa_metric)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
