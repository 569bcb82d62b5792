"""Comparison helpers and stimulus shared by the tests and `chip_smoke.py`."""

from __future__ import annotations

import numpy as np
import torch

TABLE_FIELDS = ("valid", "closed", "gate_start", "gate_close", "peak_idx",
                "peak_value", "count", "overflow")
EXACT_FIELDS = TABLE_FIELDS[:5] + TABLE_FIELDS[6:]


def table_arrays(table) -> dict[str, np.ndarray]:
    """Host arrays of any event table: the port's `GateEvents` (tensors on
    any device) or the JAX package's (jax arrays)."""
    out = {}
    for f in TABLE_FIELDS:
        a = getattr(table, f)
        out[f] = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    return out


def assert_tables_equal(ref, out, what: str = "", peak_rtol: float = 0.0) -> None:
    """Every field equal; ``peak_value`` within ``peak_rtol * max(1,
    |ref|max)`` (0: exact)."""
    r, o = table_arrays(ref), table_arrays(out)
    for f in EXACT_FIELDS:
        if r[f].shape != o[f].shape or not np.array_equal(r[f], o[f]):
            bad = (np.argwhere(r[f] != o[f])[:5].tolist()
                   if r[f].shape == o[f].shape else f"shape {r[f].shape} vs {o[f].shape}")
            raise AssertionError(f"{what}: table field {f} differs at {bad}")
    rv, ov = r["peak_value"], o["peak_value"]
    finite = np.isfinite(rv)
    tol = peak_rtol * max(1.0, float(np.abs(rv[finite]).max()) if finite.any() else 1.0)
    if rv.shape != ov.shape:
        raise AssertionError(f"{what}: peak_value shape {rv.shape} vs {ov.shape}")
    with np.errstate(invalid="ignore"):  # equal infinities (empty slots) differ by 0
        diff = np.where(rv == ov, 0.0, np.abs(rv - ov))
    if rv.size and not float(diff.max()) <= tol:
        raise AssertionError(f"{what}: peak_value differs beyond {tol}")


def aa_stimulus(batch: int, n: int, half_len: int, device, *, seed: int = 0,
                events=(), branches: int = 2) -> torch.Tensor:
    """Channel-leading (2*branches, batch, n) float32 integer-valued noise
    round(8 N(0,1)) from a seeded `torch.Generator` on ``device``, with the
    [A][A] preamble of length 2*half_len (`build_aa_preamble`, scaled to
    integers round(72 x)) added on every branch at each ``(stream,
    position)`` of ``events``.  Integer values keep every product and
    window sum of kernel C and its plain version exact."""
    from ofdm_sync_tpu_torch.ops.waveforms import build_aa_preamble

    pre = build_aa_preamble(2 * half_len)[0]
    planes = [torch.as_tensor(np.round(72.0 * pre.real), dtype=torch.float32, device=device),
              torch.as_tensor(np.round(72.0 * pre.imag), dtype=torch.float32, device=device)]
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((2 * branches, batch, n), generator=g, device=device).mul_(8.0).round_()
    for b, pos in events:
        for c in range(2 * branches):
            x[c, b, pos: pos + 2 * half_len] += planes[c % 2][: n - pos]
    return x
