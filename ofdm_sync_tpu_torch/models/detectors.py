"""Detector families of the port (port of `ofdm_sync_tpu.models.detectors`),
one class per reference detector:

  SCDetector              D1  reference sc.py
  MinnDetector            D2  reference minn.py
  MinnRTLDetector         D3  reference minn_rtl.py + ref/*.sv
  ParkDetector            D4  reference park.py
  ZCTimeDetector          D5  reference zc.py
  ZCFreqDetector          D6  reference zc_freq.py
  ZCStreamingDetector     D7  reference zc_v2.py
  CombinedSCMinnDetector  D8  reference combined_sc_min.py
  AADetector              D9  reference sync_aa.py:421-571

D1, D2, D4, D6 and D8 have no TPU kernel in the JAX package and are plain
PyTorch here too; their `detect` returns the JAX detector's dict keys.

All are `nn.Module`s without parameters: their configuration is the system
and detector dataclasses.  They take complex tensors on any device;
detection runs where the tensor lies (the CUDA kernels on a card, their
plain versions on the CPU).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ofdm_sync_tpu_torch.kernels.aa_fused import aa_detect_fused
from ofdm_sync_tpu_torch.kernels.matched_filter import matched_filter_ols
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import minn_rtl_detect_fused
from ofdm_sync_tpu_torch.kernels.streaming import cfar_gate
from ofdm_sync_tpu_torch.kernels.zc_fused import zc_cfar_detect, zc_iq_cfar_detect
from ofdm_sync_tpu_torch.models.base import DetectionEvent, DetectionResult, events_from_table
from ofdm_sync_tpu_torch.ops import metrics as M
from ofdm_sync_tpu_torch.ops.detect import extract_gate_events, gate_open_mask
from ofdm_sync_tpu_torch.ops.extract import extract_frames, extract_frames_planar
from ofdm_sync_tpu_torch.ops.waveforms import (
    build_pss_symbol,
    centered_subcarrier_indices,
    generate_zadoff_chu,
)
from ofdm_sync_tpu_torch.ops.windows import trailing_average
from ofdm_sync_tpu_torch.params import (
    AADetectorParams,
    MinnDetectorParams,
    MinnRTLParams,
    SCDetectorParams,
    SYS_30M72,
    SYS_AA_10M,
    SystemParams,
    ZCParams,
    ZCStreamingParams,
)


def _as_branches(rx: torch.Tensor) -> torch.Tensor:
    x = rx.unsqueeze(0) if rx.ndim == 1 else rx
    return x if x.is_complex() else x.to(torch.complex64)


def planar_rows(rx: torch.Tensor) -> torch.Tensor:
    """complex (branches, L) -> planar float32 (2*branches, L), rows
    [b0_re, b0_im, b1_re, b1_im, ...], on the same device."""
    x = _as_branches(rx).to(torch.complex64)
    return torch.view_as_real(x).permute(0, 2, 1).reshape(2 * x.shape[0], x.shape[-1])


def _c64(rx: torch.Tensor) -> torch.Tensor:
    return _as_branches(rx).to(torch.complex64)


class SCDetector(nn.Module):
    """D1: Schmidl & Cox, the plateau end of the S&C metric and the coarse
    start ``plateau_end - sc_delta`` (reference sc.py)."""

    def __init__(self, sys: SystemParams = SYS_30M72,
                 params: SCDetectorParams = SCDetectorParams()):
        super().__init__()
        self.sys = sys
        self.params = params

    def metric(self, rx: torch.Tensor):
        return M.sc_metric(_c64(rx), self.sys.n_fft)

    forward = metric

    def detect(self, rx: torch.Tensor) -> dict:
        Mm, P, R = M.sc_metric(_c64(rx), self.sys.n_fft)
        p = self.params
        plateau_end = M.find_plateau_end(
            Mm, self.sys.cp_len, lookahead=self.sys.cp_len // 4, smooth_win=p.smooth_win,
            plateau_frac=p.plateau_frac, run_threshold=p.run_threshold)
        return {"M": Mm, "P": P, "R": R, "plateau_end": plateau_end,
                "coarse_start": max(plateau_end - p.sc_delta, 0)}


class MinnDetector(nn.Module):
    """D2: standard Minn [A A -A -A], the peak of the smoothed metric within
    its largest gate segment (reference minn.py).  ``symbol_len`` overrides
    the symbol length for block-length sweeps (reference minn.py:656-751)."""

    def __init__(self, sys: SystemParams = SYS_30M72,
                 params: MinnDetectorParams = MinnDetectorParams(),
                 symbol_len: int | None = None):
        super().__init__()
        self.sys = sys
        self.params = params
        self.symbol_len = symbol_len

    @property
    def n(self) -> int:
        return self.symbol_len or self.sys.n_fft

    def metric(self, rx: torch.Tensor):
        return M.minn_metric(_c64(rx), self.n)

    forward = metric

    def detect(self, rx: torch.Tensor) -> dict:
        Mm, P, R = M.minn_metric(_c64(rx), self.n)
        peak, gate, Ms = M.find_minn_peak_standard(Mm, self.params.smooth_win,
                                                   self.params.gate_threshold)
        return {"M": Mm, "P": P, "R": R, "peak": int(peak),
                "gate_mask": gate.cpu().numpy(), "M_smooth": Ms}


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

    def detect_fused_table(self, rx: torch.Tensor):
        """Fused detection (kernels A + B on a card, their plain versions on
        the CPU) of one stream.  rx: complex (branches, L) or (L,).  Returns
        (planar ``(2*branches, 1, L)`` float32, the detectors' layout, and
        its event table, fields ``(1, max_events)``), on the input's
        device."""
        p = self.params
        x = planar_rows(rx).unsqueeze(1).contiguous()   # (C, batch=1, L)
        table = minn_rtl_detect_fused(
            x, quarter_len=p.quarter_len, smooth_shift=p.smooth_shift,
            threshold_value=p.threshold_value,
            threshold_frac_bits=p.threshold_frac_bits, hysteresis=p.hysteresis,
            max_events=self.max_events, tie="last", emit_unclosed=False)
        return x, table

    def events(self, table, L: int) -> list:
        """The events of a one-stream table ``(1, max_events)``."""
        return [DetectionEvent(detected_start=e["peak_index"] + self.params.timing_offset, **e)
                for e in events_from_table(table.select(0), L, gate_end_mode="close_excl")]

    def detect_fused_frames(self, rx: torch.Tensor, *, frame_len: int, max_frames: int = 4):
        """Flagship receive-chain front half: fused detection, then aligned
        frame re-emission on the stream's device.

        rx: complex (branches, L) or (L,).  Windows open at the frame's S0
        start (peak + timing_offset - 6Q: the RTL peak sits at s0 + 6Q) and
        span ``frame_len`` samples, read in place from the detector's planar
        layout (`extract_frames_planar`).  Returns ``(result, frames,
        starts, valid)``: frames planar ``(max_frames, 2*branches,
        frame_len)`` float32, starts int32 and valid bool ``(max_frames,)``,
        all on the input's device."""
        p = self.params
        x, table = self.detect_fused_table(rx)
        frames, starts, valid = extract_frames_planar(
            x, table, frame_len=frame_len,
            timing_offset=p.timing_offset - 6 * p.quarter_len, max_frames=max_frames)
        result = DetectionResult(events=self.events(table, x.shape[-1]), gate_mask=None)
        return result, frames[0], starts[0], valid[0]


class ParkDetector(nn.Module):
    """D4: Park [A B A* B*], the argmax of the centered-correlation metric;
    the symbol starts half a symbol before the center, its CP half the
    system's before that (reference park.py)."""

    def __init__(self, sys: SystemParams = SYS_30M72):
        super().__init__()
        self.sys = sys

    @property
    def cp_len(self) -> int:
        return self.sys.cp_len // 2  # reference park.py:29

    def metric(self, rx: torch.Tensor):
        return M.park_metric(_c64(rx), self.sys.n_fft)

    forward = metric

    def detect(self, rx: torch.Tensor) -> dict:
        ds, Mm, P, E = M.park_metric(_c64(rx), self.sys.n_fft)
        det_center = int(ds[torch.argmax(Mm)])
        det_symbol_start = max(det_center - self.sys.n_fft // 2, 0)
        return {"ds": ds, "M": Mm, "P": P, "E": E, "det_center": det_center,
                "det_symbol_start": det_symbol_start,
                "det_cp_start": max(det_symbol_start - self.cp_len, 0)}


class ZCTimeDetector(nn.Module):
    """D5: the normalized matched filter against the PSS symbol, peak =
    argmax of |corr| (reference zc.py:106-130)."""

    def __init__(self, sys: SystemParams = SYS_30M72, params: ZCParams = ZCParams()):
        super().__init__()
        self.sys = sys
        self.params = params

    def reference_waveform(self) -> np.ndarray:
        return build_pss_symbol(self.sys, self.params.pss_length, self.params.pss_root,
                                include_cp=False)

    def detect(self, rx: torch.Tensor) -> dict:
        corr, mag = M.zc_normalized_correlation(_as_branches(rx), self.reference_waveform())
        peak = int(torch.argmax(mag))
        return {
            "corr": corr,
            "corr_mag": mag,
            "peak_index": peak,
            "detected_start": max(peak - self.sys.n_fft + 1, 0),
        }


class ZCFreqDetector(nn.Module):
    """D6: the frequency-domain PSS search, the argmax of the template-bin
    metric over CP-start offsets (reference zc_freq.py).  ``form``: "fft",
    the reference's per-offset FFT in batches of ``chunk`` offsets, or
    "sliding", one modulate-and-window-sum pass per template bin (the same
    metric up to float32 rounding)."""

    def __init__(self, sys: SystemParams = SYS_30M72, params: ZCParams = ZCParams(),
                 chunk: int = 512, form: str = "fft"):
        super().__init__()
        if form not in ("fft", "sliding"):
            raise ValueError(f"form must be 'fft' or 'sliding', got {form!r}")
        self.sys = sys
        self.params = params
        self.chunk = chunk
        self.form = form

    def template(self) -> tuple[np.ndarray, np.ndarray]:
        return (centered_subcarrier_indices(self.params.pss_length),
                generate_zadoff_chu(self.params.pss_root, self.params.pss_length))

    def metric(self, rx: torch.Tensor) -> torch.Tensor:
        bins, tmpl = self.template()
        if self.form == "sliding":
            return M.zc_freq_metric_sliding(_c64(rx), tmpl, bins, self.sys.n_fft,
                                            self.sys.cp_len)
        return M.zc_freq_metric(_c64(rx), tmpl, bins, self.sys.n_fft, self.sys.cp_len,
                                chunk=self.chunk)

    forward = metric

    def detect(self, rx: torch.Tensor) -> dict:
        metric = self.metric(rx)
        return {"metric": metric, "detected_cp_start": int(torch.argmax(metric))}


class ZCStreamingDetector(nn.Module):
    """D7: the FPGA-style streaming CFAR detector (reference zc_v2.py):
    matched filter, per-branch normalization, branch sum, then
    ``|corr| * 2^frac >= W-window local sum * T`` with an absolute floor,
    gate/peak events (tie 'first', unclosed gates emitted) and the strongest
    event selected.  Event indices run over the correlation axis
    L + R - 1; ``detected_start = max(0, peak - n_fft + 1)``."""

    def __init__(self, sys: SystemParams = SYS_30M72, zc: ZCParams = ZCParams(),
                 params: ZCStreamingParams = ZCStreamingParams(), max_events: int = 16,
                 normalize: bool = True):
        super().__init__()
        self.sys = sys
        self.zc = zc
        self.params = params
        self.max_events = max_events
        self.normalize = normalize

    def reference_waveform(self) -> np.ndarray:
        return build_pss_symbol(self.sys, self.zc.pss_length, self.zc.pss_root,
                                include_cp=False)

    def _correlate(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Matched filter + (optional) per-branch normalization: the one
        definition shared by `detect` and `detect_fused`."""
        ref = self.reference_waveform()
        if self.normalize:
            corr = M.zc_normalized_correlation_per_branch(x, ref)
        else:
            corr = M.matched_filter(x, ref).sum(dim=0)
        return corr, corr.abs()

    def _cfar_kw(self) -> dict:
        p = self.params
        return dict(corr_window=p.corr_window, threshold_value=p.threshold_value,
                    threshold_frac_bits=p.threshold_frac_bits, min_corr_mag=p.min_corr_mag)

    def _result(self, table, n: int, **kw) -> DetectionResult:
        events = [DetectionEvent(detected_start=max(0, e["peak_index"] - self.sys.n_fft + 1), **e)
                  for e in events_from_table(table, n, gate_end_mode="close")]
        return DetectionResult(events=events, **kw)

    def detect(self, rx: torch.Tensor) -> DetectionResult:
        """The reference path in plain PyTorch: correlation, CFAR, closed-form
        gate/peak events.  ``result.state`` holds corr, corr_mag, local_sum,
        above and valid."""
        x = _as_branches(rx)
        p = self.params
        corr, corr_mag = self._correlate(x)
        above, local_sum = cfar_gate(corr_mag, **self._cfar_kw())
        table = extract_gate_events(above, corr_mag, hysteresis=p.hysteresis,
                                    max_events=self.max_events, tie="first", emit_unclosed=True)
        gmask = gate_open_mask(above, p.hysteresis)
        res = self._result(table, x.shape[-1] + self.sys.n_fft - 1,
                           gate_mask=gmask.cpu().numpy())
        res.state = {  # type: ignore[attr-defined]
            "corr": corr,
            "corr_mag": corr_mag,
            "local_sum": local_sum,
            "above": above,
            "valid": torch.arange(corr_mag.shape[-1], device=x.device) >= p.corr_window,
        }
        return res

    def detect_fused(self, rx: torch.Tensor) -> DetectionResult:
        """The plain correlation, then the fused CFAR/event detector (kernel
        D in magnitude mode + kernel B on a card).  Same events as
        `detect`."""
        _corr, corr_mag = self._correlate(_as_branches(rx))
        table = zc_cfar_detect(corr_mag, **self._cfar_kw(), hysteresis=self.params.hysteresis,
                               max_events=self.max_events)
        return self._result(table, corr_mag.shape[-1])

    def detect_fused_iq(self, rx: torch.Tensor) -> DetectionResult:
        """From-IQ fused path: the matched filter (kernel E on a card) on the
        planar IQ, then one pass of kernel D in IQ mode (per-branch window
        energy, normalization, branch sum, magnitude, CFAR) and kernel B.
        The template may have at most `kernels.matched_filter.MAX_TAPS`
        taps.  Needs ``normalize=True`` (the zc_v2 flavour, reference
        zc_v2.py:486-498); otherwise it is `detect_fused`.  Same events as
        `detect`."""
        if not self.normalize:
            return self.detect_fused(rx)
        ref = np.asarray(self.reference_waveform(), np.complex64)
        R = ref.shape[-1]
        ref_norm = float(np.sqrt(np.sum(np.abs(ref) ** 2)))
        # conjugate-reversed taps, planar float32 (reference zc_v2.py:249)
        taps = np.stack([ref.real[::-1], -ref.imag[::-1]]).astype(np.float32)
        iq = planar_rows(rx).unsqueeze(1).contiguous()  # (2*branches, 1, L)
        Lc = iq.shape[-1] + R - 1
        mf = matched_filter_ols(iq, taps)
        table = zc_iq_cfar_detect(mf, iq, ref_len=R, ref_norm=ref_norm, **self._cfar_kw(),
                                  hysteresis=self.params.hysteresis, max_events=self.max_events)
        return self._result(table.select(0), Lc)

    @staticmethod
    def strongest(result: DetectionResult) -> DetectionEvent | None:
        """The strongest event, not the first (reference zc_v2.py:567-576)."""
        return result.best_by(lambda e: e.peak_value)


class CombinedSCMinnDetector(nn.Module):
    """D8: an S&C gate at ``sc_gate_threshold`` x the peak of the
    both-halves S&C metric, seeded at its strongest sample where empty, and
    the peak of the trailing-averaged Minn metric within the gate's first
    segment, as a streaming detector would take it (reference
    combined_sc_min.py:183-259, 347-351)."""

    def __init__(self, sys: SystemParams = SYS_30M72, smooth_win: int = 16,
                 sc_gate_threshold: float = 0.6):
        super().__init__()
        self.sys = sys
        self.smooth_win = smooth_win
        self.sc_gate_threshold = sc_gate_threshold

    def detect(self, rx: torch.Tensor) -> dict:
        x = _c64(rx)
        Mm, _, _ = M.minn_metric(x, self.sys.n_fft)
        M_sc, _, _ = M.sc_generic_metric(x, self.sys.n_fft)
        max_sc = M_sc.max()
        sc_norm = torch.where(max_sc > 0, M_sc / max_sc, M_sc)
        gate = sc_norm >= self.sc_gate_threshold
        if not bool(gate.any()):
            gate = torch.zeros_like(gate)
            gate[torch.argmax(M_sc)] = True
        Ms = trailing_average(Mm.clamp_min(0.0), self.smooth_win)
        # the first gate segment: [first True, first False after it)
        n = gate.shape[-1]
        idx = torch.arange(n, device=x.device)
        first_start = torch.argmax(gate.to(torch.uint8))
        after_off = (idx >= first_start) & ~gate
        first_end = torch.where(after_off.any(), torch.argmax(after_off.to(torch.uint8)), n)
        in_first = gate & (idx >= first_start) & (idx < first_end)
        peak = int(torch.argmax(torch.where(in_first, Ms, -math.inf)))
        return {"M_minn": Mm, "M_sc": M_sc, "sc_norm": sc_norm,
                "sc_gate_mask": gate.cpu().numpy(), "M_smooth": Ms, "peak": peak}


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
