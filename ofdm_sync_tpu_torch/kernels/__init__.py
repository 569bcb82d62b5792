"""The port's detection kernels and their plain PyTorch versions.

* `streaming` -- plain PyTorch planar datapaths (the kernels' plain
  versions, `to_planar` / `from_planar`)
* `minn_rtl_fused` -- kernels A (Minn-RTL metric, every mode) and B (gate
  events) for the flagship Minn-RTL detector
* `aa_fused` -- kernel C ([A][A] metric and detect) with B's capture mode
* `zc_fused` -- kernel D (ZC CFAR, magnitude and IQ modes) with B
* `matched_filter` -- kernel E (the ZC matched filter, overlap-save FFT)
* `streaming_chunked` -- the chunked streaming receivers on those kernels
* `build`, `launches` -- the nvcc build of `csrc/` and the launch counts

Names are re-exported lazily: this module imports no submodule itself, and
no access builds anything (the CUDA library is built on the first launch
on a card).  The JAX package's TPU-only names have no counterpart
here: `to_time_tiled` / `from_time_tiled` make the TPU's time-major tiled
buffer, a layout for the TPU's DMA that no CUDA kernel reads (kernel A
takes the (channels, batch, time) layout, or a strided view of it), so
they are not here (AttributeError).  The JAX package's `pallas_minn` /
`pallas_minn_tm` entry points map to `minn_rtl_fused`'s.
"""

_STREAMING = (
    "aa_metric_planar",
    "from_planar",
    "minn_rtl_detect_planar",
    "minn_rtl_metric_planar",
    "to_planar",
)
_MINN_RTL_FUSED = (
    "minn_rtl_detect_fused",
    "minn_rtl_detect_planar_fused",
    "minn_rtl_metric_planar_fused",
)
_SUBMODULES = (
    "streaming", "streaming_chunked", "minn_rtl_fused", "aa_fused", "zc_fused",
    "matched_filter", "build", "launches",
)

__all__ = list(_STREAMING + _MINN_RTL_FUSED) + list(_SUBMODULES)


def __getattr__(name: str):
    import importlib

    if name in _STREAMING:
        return getattr(importlib.import_module("ofdm_sync_tpu_torch.kernels.streaming"), name)
    if name in _MINN_RTL_FUSED:
        return getattr(importlib.import_module("ofdm_sync_tpu_torch.kernels.minn_rtl_fused"),
                       name)
    if name in _SUBMODULES:
        return importlib.import_module(f"ofdm_sync_tpu_torch.kernels.{name}")
    raise AttributeError(name)
