"""ofdm_sync_tpu_torch: the PyTorch + CUDA port of `ofdm_sync_tpu`.

The JAX package beside it is the reference this port is tested against.
The first slice ported is the flagship Minn-RTL receive chain (detector D3
on the 30.72 MHz system, Q = 512, 2 RX branches): planar IQ -> fused
detection (hand-written CUDA kernels for the H100) -> aligned frame
re-emission -> CP-based CFO -> LS channel estimate -> equalize -> EVM.

Plain tensor code is PyTorch; the detection hot path is the two kernels in
`kernels/csrc/`.  On CPU tensors every kernel wrapper runs its plain
PyTorch version instead.  The package never imports JAX.
"""

from ofdm_sync_tpu_torch.params import (  # noqa: F401
    SystemParams,
    SYS_30M72,
    SYS_AA_10M,
    MinnRTLParams,
)

__version__ = "0.1.0"
