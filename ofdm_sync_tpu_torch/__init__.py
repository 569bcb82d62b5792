"""ofdm_sync_tpu_torch: the PyTorch + CUDA port of `ofdm_sync_tpu`.

The JAX package beside it is the reference this port is tested against.
Ported so far:

* the flagship Minn-RTL receive chain (detector D3 on the 30.72 MHz system,
  Q = 512, 2 RX branches): planar IQ -> fused detection -> aligned frame
  re-emission -> CP-based CFO -> LS channel estimate -> equalize -> EVM;
* the [A][A] receive chain (detector D9 on the 10 MHz AA system, 12-bit
  ADC): fused detection with (P, M) captured at each peak -> aligned frame
  re-emission -> CFO from the event table -> LS EQ -> EVM, and the [A][A]
  grid harness (`pipelines.aa`).

Plain tensor code is PyTorch; the detection hot paths are the three
hand-written CUDA kernels for the H100 in `kernels/csrc/`.  On CPU tensors
every kernel wrapper runs its plain PyTorch version instead.  The package
never imports JAX.
"""

from ofdm_sync_tpu_torch.params import (  # noqa: F401
    SystemParams,
    SYS_30M72,
    SYS_AA_10M,
    MinnRTLParams,
)

__version__ = "0.1.0"
