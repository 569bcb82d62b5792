"""The flagship Minn-RTL detector D3 and the [A][A] detector D9 (port of
`ofdm_sync_tpu.models.detectors.MinnRTLDetector` and `AADetector`;
reference minn_rtl.py + ref/*.sv, sync_aa.py:421-571).

Both are `nn.Module`s without parameters: their configuration is the
system and detector dataclasses.  They take complex tensors on any device;
detection runs where the tensor lies (the CUDA kernels on a card, their
plain versions on the CPU).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ofdm_sync_tpu_torch.kernels.aa_fused import aa_detect_fused
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import minn_rtl_detect_fused
from ofdm_sync_tpu_torch.models.base import DetectionEvent, DetectionResult, events_from_table
from ofdm_sync_tpu_torch.ops import metrics as M
from ofdm_sync_tpu_torch.ops.detect import extract_gate_events, gate_open_mask
from ofdm_sync_tpu_torch.ops.extract import extract_frames
from ofdm_sync_tpu_torch.params import (
    AADetectorParams,
    MinnRTLParams,
    SYS_30M72,
    SYS_AA_10M,
    SystemParams,
)


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


class AADetector(nn.Module):
    """[A][A] grid-tested detector D9: gate at M >= threshold, peak on
    |P|^2, CFO = angle(P_peak) fs / (2 pi L), frame start = peak - 2L + 1
    (reference sync_aa.py:533-540)."""

    def __init__(self, sys: SystemParams = SYS_AA_10M,
                 params: AADetectorParams = AADetectorParams(), max_events: int = 8):
        super().__init__()
        self.sys = sys
        self.params = params
        self.max_events = max_events

    @property
    def L(self) -> int:
        return self.params.half_len

    def metric(self, rx: torch.Tensor) -> M.AAMetricState:
        return M.aa_metric(_as_branches(rx).to(torch.complex64), self.L)

    forward = metric

    def detect(self, rx: torch.Tensor) -> tuple[M.AAMetricState, DetectionResult]:
        """The reference metric + closed-form gate/peak extraction, peak on
        ``|P|^2`` of the complex P (the XLA path of the JAX package)."""
        x = _as_branches(rx).to(torch.complex64)
        state = M.aa_metric(x, self.L)
        above = state.valid & (state.M >= self.params.threshold)
        table = extract_gate_events(
            above, state.P.abs() ** 2, hysteresis=self.params.hysteresis,
            max_events=self.max_events, tie="first", emit_unclosed=True)
        P_pk = state.P[table.peak_idx.long()].cpu().numpy()
        M_pk = state.M[table.peak_idx.long()].cpu().numpy()
        return state, self._assemble_events(table, x.shape[-1], P_pk.real, P_pk.imag, M_pk)

    def _assemble_events(self, table, n, p_re, p_im, m_pk) -> DetectionResult:
        """Event list from a single-stream table and per-slot P (planar)
        and M at the peak; the CFO is taken in float64 on the host."""
        L, fs = self.L, self.sys.sample_rate_hz
        slots = torch.nonzero(table.valid).flatten().tolist()
        events = []
        for slot, e in zip(slots, events_from_table(table, n, gate_end_mode="close")):
            cfo = math.atan2(float(p_im[slot]), float(p_re[slot])) * fs / (2 * math.pi * L)
            events.append(DetectionEvent(detected_start=e["peak_index"] - 2 * L + 1,
                                         cfo_hz=cfo, metric_at_peak=float(m_pk[slot]), **e))
        return DetectionResult(events=events)

    def _detect_fused_planar(self, rx: torch.Tensor):
        """Planar rows (C, n) of the stream and the fused kernels' single-
        stream table, P_at_peak (2, E) and M_at_peak (E,) on the host."""
        planar = planar_rows(rx)
        table, P_pk, M_pk = aa_detect_fused(
            planar.unsqueeze(1).contiguous(), half_len=self.L,
            threshold=self.params.threshold, hysteresis=self.params.hysteresis,
            max_events=self.max_events)
        return planar, table.select(0), P_pk[0].cpu().numpy(), M_pk[0].cpu().numpy()

    def detect_fused(self, rx: torch.Tensor) -> DetectionResult:
        """The fused path (kernels C + B on a card): same events as `detect`
        from one pass over the stream, only the event table out."""
        planar, table, P_pk, M_pk = self._detect_fused_planar(rx)
        return self._assemble_events(table, planar.shape[-1], P_pk[0], P_pk[1], M_pk)

    def detect_fused_frames(self, rx: torch.Tensor, *, frame_len: int, max_frames: int = 4):
        """Fused detection, then aligned frame re-emission on the stream's
        device.  Windows open at the frame start ``peak - 2L + 1`` and span
        ``frame_len`` samples.  Returns ``(result, frames, starts, valid)``:
        frames planar ``(max_frames, 2*branches, frame_len)`` float32, starts
        int32 and valid bool ``(max_frames,)``, on the input's device."""
        planar, table, P_pk, M_pk = self._detect_fused_planar(rx)
        frames, starts, valid = extract_frames(
            planar, table, frame_len=frame_len, timing_offset=-(2 * self.L - 1),
            max_frames=max_frames)
        result = self._assemble_events(table, planar.shape[-1], P_pk[0], P_pk[1], M_pk)
        return result, frames, starts, valid

    @staticmethod
    def best(result: DetectionResult) -> DetectionEvent | None:
        """Strongest event by metric (reference sync_aa.py:742-743)."""
        return result.best_by(lambda e: e.metric_at_peak)
