"""The flagship Minn-RTL detector D3 (port of
`ofdm_sync_tpu.models.detectors.MinnRTLDetector`; reference minn_rtl.py +
ref/*.sv).

`MinnRTLDetector` is an `nn.Module` without parameters: its configuration
is the system and detector dataclasses.  It takes complex tensors on any
device; detection runs where the tensor lies (the CUDA kernels on a card,
their plain versions on the CPU).
"""

from __future__ import annotations

import torch
from torch import nn

from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import minn_rtl_detect_fused
from ofdm_sync_tpu_torch.models.base import DetectionEvent, DetectionResult, events_from_table
from ofdm_sync_tpu_torch.ops import metrics as M
from ofdm_sync_tpu_torch.ops.detect import extract_gate_events, gate_open_mask
from ofdm_sync_tpu_torch.ops.extract import extract_frames
from ofdm_sync_tpu_torch.params import MinnRTLParams, SYS_30M72, SystemParams


def _as_branches(rx: torch.Tensor) -> torch.Tensor:
    x = rx.unsqueeze(0) if rx.ndim == 1 else rx
    return x if x.is_complex() else x.to(torch.complex64)


def planar_rows(rx: torch.Tensor) -> torch.Tensor:
    """complex (branches, L) -> planar float32 (2*branches, L), rows
    [b0_re, b0_im, b1_re, b1_im, ...], on the same device."""
    x = _as_branches(rx).to(torch.complex64)
    return torch.view_as_real(x).permute(0, 2, 1).reshape(2 * x.shape[0], x.shape[-1])


class MinnRTLDetector(nn.Module):
    def __init__(self, sys: SystemParams = SYS_30M72,
                 params: MinnRTLParams = MinnRTLParams(), max_events: int = 8):
        super().__init__()
        self.sys = sys
        self.params = params
        self.max_events = max_events

    def _metric_kw(self) -> dict:
        p = self.params
        return dict(smooth_shift=p.smooth_shift, threshold_value=p.threshold_value,
                    threshold_frac_bits=p.threshold_frac_bits, quarter_len=p.quarter_len)

    def metric(self, rx: torch.Tensor) -> M.MinnRTLMetricState:
        return M.minn_rtl_metric(_as_branches(rx), **self._metric_kw())

    forward = metric

    def detect(self, rx: torch.Tensor) -> tuple[M.MinnRTLMetricState, DetectionResult]:
        """Metric + closed-form gate/peak extraction (peak-tracks
        corr_positive with the RTL's `>=` update, i.e. tie 'last')."""
        x = _as_branches(rx)
        p = self.params
        state = M.minn_rtl_metric(x, **self._metric_kw())
        vf = M.minn_rtl_valid_from(p.quarter_len)
        table = extract_gate_events(
            state.above_threshold, state.corr_positive, hysteresis=p.hysteresis,
            max_events=self.max_events, valid_from=vf, tie="last", emit_unclosed=False)
        gmask = gate_open_mask(state.above_threshold, p.hysteresis, vf)
        n = x.shape[-1]
        events = [DetectionEvent(detected_start=e["peak_index"] + p.timing_offset, **e)
                  for e in events_from_table(table, n, gate_end_mode="close_excl")]
        return state, DetectionResult(events=events, gate_mask=gmask.cpu().numpy())

    def detect_fused_frames(self, rx: torch.Tensor, *, frame_len: int, max_frames: int = 4):
        """Flagship receive-chain front half: fused detection, then aligned
        frame re-emission on the stream's device.

        rx: complex (branches, L) or (L,).  Windows open at the frame's S0
        start (peak + timing_offset - 6Q: the RTL peak sits at s0 + 6Q) and
        span ``frame_len`` samples.  Returns ``(result, frames, starts,
        valid)``: frames planar ``(max_frames, 2*branches, frame_len)``
        float32, starts int32 and valid bool ``(max_frames,)``, all on the
        input's device."""
        p = self.params
        planar = planar_rows(rx)           # (C, L)
        L = planar.shape[-1]
        table = minn_rtl_detect_fused(
            planar.unsqueeze(1).contiguous(),  # (C, batch=1, L)
            quarter_len=p.quarter_len, smooth_shift=p.smooth_shift,
            threshold_value=p.threshold_value,
            threshold_frac_bits=p.threshold_frac_bits, hysteresis=p.hysteresis,
            max_events=self.max_events, tie="last", emit_unclosed=False)
        table0 = table.select(0)
        frames, starts, valid = extract_frames(
            planar, table0, frame_len=frame_len,
            timing_offset=p.timing_offset - 6 * p.quarter_len, max_frames=max_frames)
        events = [DetectionEvent(detected_start=e["peak_index"] + p.timing_offset, **e)
                  for e in events_from_table(table0, L, gate_end_mode="close_excl")]
        return DetectionResult(events=events, gate_mask=None), frames, starts, valid
