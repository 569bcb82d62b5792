"""Comparison helpers shared by the tests and `chip_smoke.py`."""

from __future__ import annotations

import numpy as np

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
    tol = peak_rtol * max(1.0, float(np.abs(rv).max()) if rv.size else 1.0)
    if rv.shape != ov.shape or (rv.size and float(np.abs(rv - ov).max()) > tol):
        raise AssertionError(f"{what}: peak_value differs beyond {tol}")
