"""Device resolution and checks.

Every entry point of the port takes an explicit ``device``.  A CUDA device
is used only when one is really there: asking for "cuda" on a machine
without a card raises instead of silently running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> CPU; otherwise the named device, checked to exist."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cpu' or 'cuda'")
    return dev


def check_kernel_device(*tensors: torch.Tensor) -> str:
    """Return "cuda" or "cpu" for a set of tensors that must share one
    device; raise for mixed devices or any other device type.  Kernel
    wrappers dispatch on this: "cuda" launches the kernel, "cpu" runs the
    plain version."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type
