"""Launch counts of the CUDA kernels.

Each kernel wrapper adds one to its ``.launches`` where it launches its
kernel on a card, and nowhere else (a CPU tensor runs the plain version and
counts nothing); at the same place it adds one to ``.modes[name]`` for each
mode the launch ran in (kernel A: ``corr_above`` / ``full`` /
``corr_energy``, ``primed``, ``strided`` for a view read in place, and
``exact_i16`` for int16 codes of up to two branches without a history,
which take its exact integer path; kernels B, C, D: ``primed``, the
carried-state mode, which for D is its magnitude mode, and the peak
capture's ``primed`` for a call at a global base; B: ``capture`` for
a launch that reads channels at each slot's peak; C: ``detect`` for its
detect mode (the tracked |P|^2 and the gate input above, with P and M),
``gate_input`` for a detect launch that writes only the tracked |P|^2 and
above (int16 codes without a history), whose P and M the peak capture
(`aa_peak_capture`) forms at a table's peaks instead, and ``exact_i16``
for int16 codes of up to two branches without a history, which take its
exact integer path (`aa_fused.exact_route`); D's IQ mode with a
halo or a global base: ``primed_iq``; kernel F, the Minn-RTL stream step:
``int16`` for a chunk of int16 codes; kernels G and H, the batched
Minn-RTL receive's front and back ends (`minn_rx`): ``int16`` or
``float32``, the type of the codes the slots were read from).  A run
shows that it went through the kernels by resetting the counts, driving
its path and reading them.
Each wrapper's spans carry its name too (`utils.profiling.wrapper_spans`),
so a span, a launch count and a kernel line up.

A stage may count its calls too
(`pipelines.fused_rx.receive_minn_rtl_frames`: ``.calls`` and ``.slots``);
its module appends the reset of those counters to `COUNTER_RESETS`, and
`reset_launch_counts` runs them with the launch counts.
"""

from __future__ import annotations

from ofdm_sync_tpu_torch.kernels.aa_fused import aa_metric, aa_peak_capture
from ofdm_sync_tpu_torch.kernels.matched_filter import matched_filter_ols
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import gate_events, minn_rtl_metric, minn_rtl_step
from ofdm_sync_tpu_torch.kernels.minn_rx import minn_rx_back, minn_rx_front
from ofdm_sync_tpu_torch.kernels.zc_fused import zc_metric

#: one wrapper per kernel: A, B, C, D, E, F, C's peak capture, G and H
KERNEL_WRAPPERS = (minn_rtl_metric, gate_events, aa_metric, zc_metric, matched_filter_ols,
                   minn_rtl_step, aa_peak_capture, minn_rx_front, minn_rx_back)
#: resets of the call counters of plain-PyTorch stages, appended by their modules
COUNTER_RESETS: list = []


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        if hasattr(fn, "modes"):
            fn.modes.clear()
    for reset in COUNTER_RESETS:
        reset()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def mode_launch_counts() -> dict[str, int]:
    """Launches per kernel and mode, as ``"<kernel>/<mode>"``."""
    return {f"{fn.__name__}/{mode}": n for fn in KERNEL_WRAPPERS
            for mode, n in sorted(getattr(fn, "modes", {}).items())}
