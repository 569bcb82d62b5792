"""ofdm_sync_tpu_torch: the PyTorch + CUDA port of `ofdm_sync_tpu`.

The JAX package beside it is the reference this port is tested against.
Ported so far:

* the flagship Minn-RTL receive chain (detector D3 on the 30.72 MHz system,
  Q = 512, 2 RX branches): planar IQ -> fused detection -> aligned frame
  re-emission -> CP-based CFO -> LS channel estimate -> equalize -> EVM;
* the [A][A] receive chain (detector D9 on the 10 MHz AA system, 12-bit
  ADC): fused detection with (P, M) captured at each peak -> aligned frame
  re-emission -> CFO from the event table -> LS EQ -> EVM, and the [A][A]
  grid harness (`pipelines.aa`);
* the Zadoff-Chu family (detectors D5 and D7 on the 30.72 MHz system):
  matched filter -> per-branch normalization -> CFAR -> strongest event ->
  CFO / LS EQ / EVM (`pipelines.zc`, `pipelines.zc_v2`), with the fused
  CFAR paths of `ZCStreamingDetector`;
* the chunked streaming receivers (`kernels.streaming_chunked`, exported
  here): Minn-RTL plain and fused, [A][A] fused and ZC CFAR fused, each
  carrying its state between chunks;
* the reference-parity simulations of every family: the Minn-RTL pipeline
  with its sweeps, and the families without a TPU kernel (D1 Schmidl-Cox,
  D2 Minn, D4 Park, D6 ZC-frequency, D8 combined S&C + Minn, plain
  PyTorch), and the ctypes binding of the C++ integer RTL models
  (`native`), the oracle the kernels are held to;
* the simulations' plot artifacts (`utils.report`, matplotlib imported only
  when a plot is made), the CLI (`python -m ofdm_sync_tpu_torch`) and the
  timing helpers of `utils.profiling`.

Plain tensor code is PyTorch; the detection hot paths are the five
hand-written CUDA kernels for the H100 in `kernels/csrc/`.  On CPU tensors
every kernel wrapper runs its plain PyTorch version instead.  The package
never imports JAX.
"""

from ofdm_sync_tpu_torch.params import (  # noqa: F401
    SystemParams,
    SYS_30M72,
    SYS_AA_10M,
    SCDetectorParams,
    MinnDetectorParams,
    MinnRTLParams,
    ZCParams,
    ZCStreamingParams,
    AADetectorParams,
)
from ofdm_sync_tpu_torch.kernels.streaming_chunked import (  # noqa: F401
    EPOCH_HORIZON,
    AAFusedStreamState,
    MinnRTLFusedStreamState,
    MinnRTLStreamParams,
    MinnRTLStreamState,
    ZCCFARFusedStreamState,
    aa_fused_stream_init,
    aa_fused_stream_rebase,
    aa_fused_stream_step,
    epoch_headroom,
    minn_rtl_fused_stream_init,
    minn_rtl_fused_stream_rebase,
    minn_rtl_fused_stream_step,
    minn_rtl_stream_finalize,
    minn_rtl_stream_init,
    minn_rtl_stream_rebase,
    minn_rtl_stream_step,
    stitch_chunk_tables,
    zc_cfar_fused_stream_init,
    zc_cfar_fused_stream_step,
)

__version__ = "0.1.0"
