"""Entry: the Minn-RTL stream receiver, one step a block
(`kernels.streaming_chunked.minn_rtl_fused_stream_step`: kernel F)."""

from __future__ import annotations

from ofdm_sync_tpu_torch.kernels import streaming_chunked as ST

from benchmark.work import counts as W


class Entry:
    stages = ("step_call",)

    def __init__(self, config: dict, traffic: dict, device):
        det = config["detector"]
        self.params = ST.MinnRTLStreamParams(
            quarter_len=det["quarter_len"], smooth_shift=det["smooth_shift"],
            threshold_value=det["threshold_value"],
            threshold_frac_bits=det["threshold_frac_bits"], hysteresis=det["hysteresis"],
            max_events=det["max_events"], tie=det["tie"])
        self.branches = config["input"]["branches"]
        self.device = device

    def init(self, streams: int):
        return ST.minn_rtl_fused_stream_init(self.params, streams, self.branches,
                                             device=self.device)

    def step(self, state, chunk, span):
        with span("step_call"):
            return ST.minn_rtl_fused_stream_step(state, chunk, params=self.params)

    @staticmethod
    def state_host(state) -> dict:
        return {"hist": state.hist.cpu().numpy(), "carry": state.carry.cpu().numpy(),
                "gate": state.gate.cpu().numpy()}

    def work(self, stage: str, chunk, gated: float) -> tuple[float, float]:
        C, streams, L = chunk.shape
        return W.f_work(streams, L, C, chunk.element_size(), 3 * self.params.quarter_len,
                        gated, E=self.params.max_events)
