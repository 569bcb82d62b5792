"""Entry: the Minn-RTL batch detector, kernels A + B
(`kernels.minn_rtl_fused.minn_rtl_detect_fused`), one call a batch."""

from __future__ import annotations

from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F

from benchmark.work import counts as W


class Entry:
    stages = ("detect_call",)

    def __init__(self, config: dict, traffic: dict, device):
        det = config["detector"]
        self.kw = {k: det[k] for k in ("quarter_len", "smooth_shift", "threshold_value",
                                       "threshold_frac_bits", "hysteresis", "max_events",
                                       "tie", "emit_unclosed")}
        self.C = 2 * config["input"]["branches"]

    def call(self, i: int, x, span):
        with span("detect_call"):
            return F.minn_rtl_detect_fused(x, **self.kw)

    def work(self, stage: str, x, gated: int) -> tuple[float, float]:
        """(bytes, flops) of one call of ``stage`` on x: the detection's
        function (codes in, table out), whatever kernels carry it."""
        _, batch, L = x.shape
        return W.minn_detect_work(batch, L, self.C, x.element_size(), gated,
                                  E=self.kw["max_events"])
