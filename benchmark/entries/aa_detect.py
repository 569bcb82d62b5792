"""Entry: the [A][A] batch detector, kernel C in detect mode then kernel B
with peak capture (`kernels.aa_fused.aa_detect_fused`), one call a batch.
Each input's last event table's peak indices and valid slots, and the P and
M captured at those peaks, are kept (references, no copy) for the
comparison."""

from __future__ import annotations

from ofdm_sync_tpu_torch.kernels import aa_fused as AA

from benchmark.work.aa_counts import aa_detect_work


class Entry:
    stages = ("detect_call",)

    def __init__(self, config: dict, traffic: dict, device):
        det = config["detector"]
        self.kw = {k: det[k] for k in ("half_len", "threshold", "hysteresis", "max_events",
                                       "tie", "emit_unclosed")}
        self.C = 2 * config["input"]["branches"]
        self.kept = {}

    def call(self, i: int, x, span):
        with span("detect_call"):
            table, P, M = AA.aa_detect_fused(x, **self.kw)
        self.kept[i] = {"peak_idx": table.peak_idx, "valid": table.valid, "P": P, "M": M}
        return table

    def work(self, stage: str, x, gated: int) -> tuple[float, float]:
        _, batch, L = x.shape
        return aa_detect_work(batch, L, self.C, x.element_size(), gated,
                              E=self.kw["max_events"])
