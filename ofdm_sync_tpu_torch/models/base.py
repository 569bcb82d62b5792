"""Common detection-result containers (port of `ofdm_sync_tpu.models.base`).

All detector families share one event shape; `events_from_table` turns a
fixed-capacity `GateEvents` table (tensors or NumPy arrays) into host
dicts.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class DetectionEvent:
    peak_index: int
    peak_value: float
    gate_start: int
    gate_end: int
    closed: bool
    detected_start: int = 0
    cfo_hz: float = 0.0
    metric_at_peak: float = 0.0


@dataclass
class DetectionResult:
    events: list[DetectionEvent] = field(default_factory=list)
    gate_mask: np.ndarray | None = None

    @property
    def detected(self) -> bool:
        return len(self.events) > 0

    def best_by(self, key) -> DetectionEvent | None:
        return max(self.events, key=key) if self.events else None


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def events_from_table(table, n: int, *, gate_end_mode: str = "close") -> list[dict]:
    """Convert a single-stream `GateEvents` table into host dicts.

    gate_end_mode:
      'close'      -> gate_end = closing sample; unclosed gates end at n.
      'close_excl' -> gate_end = close + 1 (half-open [start, end) segments).
    """
    valid = _host(table.valid)
    closed_a = _host(table.closed)
    close_a = _host(table.gate_close)
    peak_idx = _host(table.peak_idx)
    peak_val = _host(table.peak_value)
    start = _host(table.gate_start)
    out = []
    for slot in np.flatnonzero(valid):
        closed = bool(closed_a[slot])
        close = int(close_a[slot])
        if not closed:
            gate_end = n
        elif gate_end_mode == "close_excl":
            gate_end = close + 1
        else:
            gate_end = close
        out.append(
            dict(
                peak_index=int(peak_idx[slot]),
                peak_value=float(peak_val[slot]),
                gate_start=int(start[slot]),
                gate_end=gate_end,
                closed=closed,
            )
        )
    return out
