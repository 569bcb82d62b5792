"""Entry: the ZC-v2 detector from IQ, one call a batch: the matched filter
(kernel E, `kernels.matched_filter.matched_filter_ols`), then kernels D + B
(`kernels.zc_fused.zc_iq_cfar_detect`).  The last filter output of each
input is kept (a reference, no copy) for the comparison."""

from __future__ import annotations

import numpy as np

from ofdm_sync_tpu_torch.kernels import matched_filter as MF
from ofdm_sync_tpu_torch.kernels import zc_fused as ZF

from benchmark import stimulus
from benchmark.work import counts as W


class Entry:
    stages = ("mf_call", "detect_call")

    def __init__(self, config: dict, traffic: dict, device):
        det = config["detector"]
        ref = np.asarray(stimulus.template(config), np.complex64)
        #: the conjugate-reversed template, planar float32 (zc_v2.py:249)
        self.taps = np.stack([ref.real[::-1], -ref.imag[::-1]]).astype(np.float32)
        self.kw = dict(ref_len=ref.shape[-1], ref_norm=float(np.sqrt(np.sum(np.abs(ref) ** 2))),
                       **{k: det[k] for k in ("corr_window", "threshold_value",
                                              "threshold_frac_bits", "min_corr_mag",
                                              "hysteresis", "max_events")})
        self.C = 2 * config["input"]["branches"]
        self.kept = {}

    def call(self, i: int, x, span):
        with span("mf_call"):
            mf = MF.matched_filter_ols(x, self.taps)
        self.kept[i] = mf
        with span("detect_call"):
            return ZF.zc_iq_cfar_detect(mf, x, **self.kw)

    def work(self, stage: str, x, gated: int) -> tuple[float, float]:
        _, batch, L = x.shape
        T = self.kw["ref_len"]
        Lc = L + T - 1
        if stage == "mf_call":
            return W.e_work(self.C, batch, L, T, Lc)
        return W.zc_detect_work(batch, Lc, L, self.C, x.element_size(), gated,
                                E=self.kw["max_events"])
