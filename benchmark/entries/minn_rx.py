"""Entry: the flagship Minn-RTL receiver on a batch, detection and then
every detected frame demodulated: kernels A + B
(`kernels.minn_rtl_fused.minn_rtl_detect_fused`) in the stage
``detect_call``, then the batched receive
(`pipelines.fused_rx.receive_minn_rtl_frames`: frame re-emission, CP CFO,
FFT, LS estimate, equalization, EVM) on the same codes and table in the
stage ``demod_call``.  The table the harness copies is enqueued after the
receive, so a batch counts only once its frames are demodulated.  Each
input's last slot outputs and the table's peak indices and valid slots are
kept (references, no copy) for the comparison."""

from __future__ import annotations

import torch

from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F
from ofdm_sync_tpu_torch.params import MinnRTLParams, SystemParams
from ofdm_sync_tpu_torch.pipelines.fused_rx import receive_minn_rtl_frames

from benchmark.preambles import minn_rtl_frame
from benchmark.work import counts as W
from benchmark.work.rx_counts import rx_demod_work


class Entry:
    stages = ("detect_call", "demod_call")

    def __init__(self, config: dict, traffic: dict, device):
        det, sys, rx = config["detector"], config["system"], config["receive"]
        self.kw = {k: det[k] for k in ("quarter_len", "smooth_shift", "threshold_value",
                                       "threshold_frac_bits", "hysteresis", "max_events",
                                       "tie", "emit_unclosed")}
        self.sys = SystemParams(n_fft=sys["n_fft"], num_active=sys["num_active"],
                                cp_len=sys["cp_len"], sample_rate_hz=sys["sample_rate_hz"])
        self.params = MinnRTLParams(
            quarter_len=det["quarter_len"], smooth_shift=det["smooth_shift"],
            threshold_frac_bits=det["threshold_frac_bits"],
            threshold_value=det["threshold_value"], hysteresis=det["hysteresis"],
            timing_offset=rx["timing_offset"])
        pilot, data = minn_rtl_frame.symbols(config)
        self.used = {k: torch.as_tensor(v, dtype=torch.complex64, device=device)
                     for k, v in (("pilot_used", pilot), ("data_used", data))}
        self.max_frames = rx["max_frames"]
        self.C = 2 * config["input"]["branches"]
        self.kept = {}

    def call(self, i: int, x, span):
        with span("detect_call"):
            table = F.minn_rtl_detect_fused(x, **self.kw)
        with span("demod_call"):
            slots = receive_minn_rtl_frames(x, table, sys=self.sys, params=self.params,
                                            max_frames=self.max_frames, **self.used)
        self.kept[i] = {"peak_idx": table.peak_idx, "table_valid": table.valid,
                        "count": table.count, **slots._asdict()}
        return table

    def work(self, stage: str, x, gated: int) -> tuple[float, float]:
        """(bytes, flops) of one call of ``stage`` on x: each stage's
        function, whatever kernels carry it."""
        _, batch, L = x.shape
        E = self.kw["max_events"]
        if stage == "detect_call":
            return W.minn_detect_work(batch, L, self.C, x.element_size(), gated, E=E)
        return rx_demod_work(batch, min(self.max_frames, E), self.C, x.element_size(),
                             self.sys.n_fft, self.sys.cp_len, self.sys.num_active, E)
