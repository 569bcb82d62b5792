"""The benchmark's inputs, made on the device from the seed.

A frozen copy of the recipe of the port's `testing.minn_stimulus` /
`zc_iq_stimulus`, extended: every stream carries a configuration's
preamble at seeded positions (one in each of ``preambles_per_stream``
equal segments), with a per-stream SNR drawn in the traffic's range, a
per-stream CFO within its bound, a per-branch gain and random phase, over
Gaussian noise of ``noise_std_codes`` a component; the samples are then
rounded to ADC codes and clipped to the ADC's range.  The templates are
built by ``preambles/<kind>.py`` from the upstream recipes the
configurations name, never taken from the program.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def dtype(name: str) -> torch.dtype:
    """The torch dtype a configuration's ``input.dtype`` names."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown input dtype {name!r}")
    return dt


def template(config: dict) -> np.ndarray:
    """The configuration's preamble (complex128), built by
    ``preambles/<kind>.py`` for its ``preamble.kind``."""
    kind = config["preamble"]["kind"]
    return importlib.import_module(f"benchmark.preambles.{kind}").template(config)


def seeded(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def streams(config: dict, traffic: dict, g: torch.Generator, batch: int, n: int,
            device) -> torch.Tensor:
    """One block of streams: planar channel-leading (2 * branches, batch, n)
    ADC codes in the configuration's input dtype."""
    inp, sys = config["input"], config["system"]
    branches, gains = inp["branches"], inp["branch_gains"]
    C = 2 * branches
    sigma = float(traffic["noise_std_codes"])
    full = (1 << (inp["adc_bits"] - 1)) - 1
    pre = torch.as_tensor(template(config), dtype=torch.complex64, device=device)
    plen = pre.shape[0]
    P = int(traffic["preambles_per_stream"])
    seg = n // P
    if seg < plen:
        raise ValueError(f"{P} preambles of {plen} samples do not fit {n} samples")
    x = torch.randn((C, batch, n), generator=g, device=device).mul_(sigma)
    pos = (torch.randint(0, seg - plen + 1, (batch, P), generator=g, device=device)
           + seg * torch.arange(P, device=device))
    lo, hi = traffic["snr_db"]
    snr = lo + (hi - lo) * torch.rand(batch, generator=g, device=device, dtype=torch.float64)
    amp = sigma * np.sqrt(2.0) * torch.pow(10.0, snr / 20.0)
    cfo = (2.0 * torch.rand(batch, generator=g, device=device, dtype=torch.float64) - 1.0) \
        * float(traffic["cfo_hz"])
    phase = 2.0 * np.pi * torch.rand((batch, branches), generator=g, device=device,
                                     dtype=torch.float64)
    at = pos.unsqueeze(-1) + torch.arange(plen, device=device)           # (batch, P, plen)
    turn = 2.0 * np.pi * cfo[:, None, None] / sys["sample_rate_hz"] * at
    flat = (at + n * torch.arange(batch, device=device)[:, None, None]).reshape(-1)
    for b in range(branches):
        rot = torch.polar(amp[:, None, None] * gains[b], turn + phase[:, b, None, None])
        s = (rot.to(torch.complex64) * pre).reshape(-1)
        x[2 * b].view(-1).index_add_(0, flat, s.real)
        x[2 * b + 1].view(-1).index_add_(0, flat, s.imag)
    return x.round_().clamp_(-full, full).to(dtype(inp["dtype"]))


def distinct(config: dict, traffic: dict) -> int:
    """How many distinct batches a closed-loop mix cycles: ``distinct``, or
    as many as ``distinct_bytes`` holds (at least two)."""
    if "distinct" in traffic:
        return int(traffic["distinct"])
    inp = config["input"]
    per = (2 * inp["branches"] * traffic["batch"] * traffic["samples"]
           * dtype(inp["dtype"]).itemsize)
    return max(2, int(traffic["distinct_bytes"]) // per)
