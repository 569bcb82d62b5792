"""[A][A] detector single tests and grid sweeps (port of
`ofdm_sync_tpu.pipelines.aa`; reference sync_aa.py:648-1123).

Two execution paths:

* `run_single_test` / `run_grid_test`: the serial harness (same seeds, same
  prints as the reference), detecting with `AADetector.detect`;
* `run_grid_test_fused`: the whole SNR x full-scale grid of one channel and
  preamble length as one planar batch, detected by ONE `aa_detect_fused`
  call (kernels C + B on a card).

The fused sweep's noise comes from a CPU `torch.Generator` seeded with
``seed`` and is moved to the device, so one seed gives the same grid on a
card and on the CPU.  The JAX package draws it from `jax.random` keys,
which the port cannot reproduce: the two grids agree in distribution, and
the tests hold the port's detection to JAX's on the same quantized batch.
The heatmap and preamble plots and ``main()`` are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.kernels.aa_fused import aa_detect_fused
from ofdm_sync_tpu_torch.models.detectors import AADetector
from ofdm_sync_tpu_torch.ops.channel import (
    apply_cfo,
    apply_channel_multi_antenna,
    apply_cir,
    awgn_noise_device,
    compute_channel_peak_offset,
    compute_clipping_stats,
    load_measured_cir,
    quantize_adc,
)
from ofdm_sync_tpu_torch.ops.waveforms import (
    AA_PREAMBLE_LENGTHS,
    assemble_frame,
    build_aa_preamble,
    build_aa_qpsk_symbol,
)
from ofdm_sync_tpu_torch.params import AADetectorParams, SYS_AA_10M
from ofdm_sync_tpu_torch.utils import report

SYS = SYS_AA_10M
#: threshold / hysteresis shared by all paths
_GRID_PARAMS = AADetectorParams()


@dataclass
class TestResult:
    """Per-config result (reference sync_aa.py:651-666)."""

    snr_db: float
    channel: str
    full_scale_ratio: float
    preamble_length: int
    timing_error: int
    cfo_applied_hz: float
    cfo_estimated_hz: float
    cfo_error_hz: float
    detected: bool
    num_events: int
    clipping_pct: float
    effective_bits: float
    metric_peak: float


def run_single_test(
    snr_db: float,
    channel_name: str | None,
    full_scale_ratio: float,
    preamble_length: int = 1024,
    cfo_hz: float = 500.0,
    seed: int = 42,
    device: torch.device | str | None = None,
) -> TestResult:
    """One sync test: frame -> channel -> CFO -> 12-bit ADC -> detect
    (reference sync_aa.py:669-823)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    channel_str = channel_name if channel_name else "awgn"

    preamble, _, _ = build_aa_preamble(preamble_length, SYS)
    pilot_symbol, _ = build_aa_qpsk_symbol(rng, SYS)
    data_symbol, _ = build_aa_qpsk_symbol(rng, SYS)
    tx = assemble_frame(preamble, pilot_symbol, data_symbol, pre_pad=SYS.tx_pre_pad,
                        post_pad=500)
    rx, _cir, channel_peak_offset = apply_channel_multi_antenna(
        tx, snr_db, rng, channel_name, num_rx_antennas=2, device=dev)
    true_preamble_start = SYS.tx_pre_pad + channel_peak_offset
    rx = apply_cfo(torch.as_tensor(rx, device=dev).to(torch.complex64), cfo_hz,
                   SYS.sample_rate_hz)

    # full scale and clipping from the complex64 samples on the host, as
    # the JAX harness takes them
    rx_host = rx.cpu().numpy()
    full_scale = np.sqrt(np.mean(np.abs(rx_host) ** 2)) * full_scale_ratio
    clip_stats = compute_clipping_stats(rx_host.flatten(), full_scale)
    rx_q = quantize_adc(rx, float(full_scale))

    det = AADetector(SYS, AADetectorParams(preamble_len=preamble_length))
    state, result = det.detect(rx_q)
    best = AADetector.best(result)
    if best is not None:
        detected = True
        timing_error = best.detected_start - true_preamble_start
        cfo_estimated = best.cfo_hz
        metric_peak = best.metric_at_peak
        num_events = len(result.events)
    else:
        detected = False
        timing_error = 0
        cfo_estimated = 0.0
        metric_peak = float(state.M.max()) if bool(state.valid.any()) else 0.0
        num_events = 0

    return TestResult(
        snr_db=snr_db,
        channel=channel_str,
        full_scale_ratio=full_scale_ratio,
        preamble_length=preamble_length,
        timing_error=timing_error,
        cfo_applied_hz=cfo_hz,
        cfo_estimated_hz=cfo_estimated,
        cfo_error_hz=cfo_estimated - cfo_hz if detected else cfo_hz,
        detected=detected,
        num_events=num_events,
        clipping_pct=clip_stats["total_clip_pct"],
        effective_bits=clip_stats["effective_bits"],
        metric_peak=metric_peak,
    )


def run_grid_test(
    snr_values=(-5, 0, 5, 10, 15),
    channels=(None, "cir1", "cir2"),
    full_scale_ratios=(0.25, 0.5, 1.0, 1.5, 2.0),
    preamble_lengths=AA_PREAMBLE_LENGTHS,
    cfo_hz: float = 500.0,
    device: torch.device | str | None = None,
) -> list[TestResult]:
    """Serial parity grid (reference sync_aa.py:829-899)."""
    results: list[TestResult] = []
    total = len(snr_values) * len(channels) * len(full_scale_ratios) * len(preamble_lengths)
    report.banner("[A][A] PREAMBLE SYNCHRONIZATION - GRID TEST")
    print(f"Total tests: {total}")
    test_num = 0
    for preamble_len in preamble_lengths:
        L = preamble_len // 2
        print(f"\n--- Preamble Length: {preamble_len} samples (L={L}) ---")
        for channel in channels:
            channel_str = channel if channel else "awgn"
            for snr_db in snr_values:
                for fs_ratio in full_scale_ratios:
                    test_num += 1
                    r = run_single_test(
                        snr_db=snr_db, channel_name=channel, full_scale_ratio=fs_ratio,
                        preamble_length=preamble_len, cfo_hz=cfo_hz, seed=42,
                        device=device)
                    results.append(r)
                    status = "OK " if r.detected else "MISS"
                    print(
                        f"[{test_num:3d}/{total}] L={L:3d} {channel_str:6s} "
                        f"SNR={snr_db:+3.0f}dB FS={fs_ratio:.2f}x -> {status} "
                        f"timing_err={r.timing_error:+4d} "
                        f"cfo_err={r.cfo_error_hz:+7.1f}Hz "
                        f"clip={r.clipping_pct:5.1f}%"
                    )
    return results


# ---------------------------------------------------------------------------
# The fused sweep: the whole grid in one detection call
# ---------------------------------------------------------------------------

def _grid_clean_stream(preamble_length: int, channel_name: str | None, seed: int, device):
    """Shared TX/channel synthesis of the grid sweep: returns (clean rx
    complex64 (2 antennas, n) on ``device``, true start, L)."""
    rng = np.random.default_rng(seed)
    L = preamble_length // 2
    preamble, _, _ = build_aa_preamble(preamble_length, SYS)
    pilot, _ = build_aa_qpsk_symbol(rng, SYS)
    data, _ = build_aa_qpsk_symbol(rng, SYS)
    tx = assemble_frame(preamble, pilot, data, pre_pad=SYS.tx_pre_pad, post_pad=500)
    if channel_name is None:
        rx_clean = torch.as_tensor(np.stack([tx, tx]), device=device).to(torch.complex64)
        peak_off = 0
    else:
        cir = load_measured_cir(channel_name)[:2]
        rx_clean = apply_cir(tx, cir, device)
        peak_off = compute_channel_peak_offset(cir)
    return rx_clean, SYS.tx_pre_pad + peak_off, L


def _grid_batch(x: torch.Tensor, snr_values, full_scale_ratios, cfo_hz: float,
                seed: int) -> torch.Tensor:
    """Every (snr, full-scale) config's quantized stream as one planar batch
    on x's device: on-device AWGN (from a CPU generator seeded with
    ``seed``), CFO, 12-bit ADC at ``rms * ratio`` (reference
    sync_aa.py:712-735).  Returns channel-leading float32
    (2 * antennas, n_snr * n_fs, n), configs in row-major (snr, fs) order."""
    dev = x.device
    snr = torch.as_tensor(snr_values, dtype=torch.float32, device=dev)
    fs = torch.as_tensor(full_scale_ratios, dtype=torch.float32, device=dev)
    snr_grid, fs_grid = torch.meshgrid(snr, fs, indexing="ij")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    noise = awgn_noise_device(x, snr_grid.reshape(-1), gen)   # (ncfg, BR, n)
    rx = apply_cfo(x + noise, cfo_hz, SYS.sample_rate_hz)
    rms = torch.sqrt((rx.abs() ** 2).mean(dim=(-2, -1), keepdim=True))
    rx_q = quantize_adc(rx, rms * fs_grid.reshape(-1, 1, 1))
    ncfg, br, n = rx_q.shape
    planar = torch.view_as_real(rx_q)                            # (ncfg, BR, n, 2)
    return planar.permute(1, 3, 0, 2).reshape(2 * br, ncfg, n).contiguous()


def _fused_detect(iq: torch.Tensor, L: int) -> dict[str, np.ndarray]:
    """ONE fused detection over the grid batch; per config the strongest
    event by M at its peak.  Returns host arrays of shape (ncfg,)."""
    fs_hz = SYS.sample_rate_hz
    table, P_pk, M_pk = aa_detect_fused(
        iq, half_len=L, threshold=_GRID_PARAMS.threshold,
        hysteresis=_GRID_PARAMS.hysteresis, max_events=8)
    score = torch.where(table.valid, M_pk, float("-inf"))
    best = torch.argmax(score, dim=-1, keepdim=True)
    take = lambda a: a.gather(-1, best)[:, 0].cpu().numpy()  # noqa: E731
    peak_idx = take(table.peak_idx)
    p_re = take(P_pk[:, 0]).astype(np.float64)
    p_im = take(P_pk[:, 1]).astype(np.float64)
    return {
        "detected": table.count.cpu().numpy() > 0,
        "frame_start": peak_idx - 2 * L + 1,
        "cfo_est": np.arctan2(p_im, p_re) * fs_hz / (2 * math.pi * L),
        "metric_peak": take(M_pk),
        "num_events": table.count.cpu().numpy(),
    }


def _grid_outputs(out, shape, true_start, cfo_hz, snr_values, full_scale_ratios):
    out = {k: np.asarray(v).reshape(shape) for k, v in out.items()}
    out["timing_error"] = out["frame_start"] - true_start
    out["cfo_error"] = out["cfo_est"] - cfo_hz
    out["snr_values"] = np.asarray(snr_values)
    out["full_scale_ratios"] = np.asarray(full_scale_ratios)
    return out


def run_grid_test_fused(
    preamble_length: int = 1024,
    channel_name: str | None = None,
    snr_values=(-5.0, 0.0, 5.0, 10.0, 15.0),
    full_scale_ratios=(0.25, 0.5, 1.0, 1.5, 2.0),
    cfo_hz: float = 500.0,
    seed: int = 42,
    device: torch.device | str | None = None,
) -> dict[str, np.ndarray]:
    """The production sweep: the entire (snr x full_scale) grid detected by
    ONE fused detection call.  Returns a dict of (n_snr, n_fs) arrays:
    detected, frame_start, cfo_est, metric_peak, num_events, timing_error,
    cfo_error (plus the swept values)."""
    dev = resolve_device(device)
    x, true_start, L = _grid_clean_stream(preamble_length, channel_name, seed, dev)
    iq = _grid_batch(x, snr_values, full_scale_ratios, cfo_hz, seed)
    out = _fused_detect(iq, L)
    return _grid_outputs(out, (len(snr_values), len(full_scale_ratios)), true_start,
                         cfo_hz, snr_values, full_scale_ratios)


# ---------------------------------------------------------------------------
# Reporting (reference sync_aa.py:902-1069)
# ---------------------------------------------------------------------------

def print_summary_table(results: list[TestResult]) -> None:
    report.banner("SUMMARY TABLE")
    preamble_lengths = sorted({r.preamble_length for r in results}, reverse=True)
    channels = sorted({r.channel for r in results})
    snr_values = sorted({r.snr_db for r in results})
    fs_ratios = sorted({r.full_scale_ratio for r in results})

    for plen in preamble_lengths:
        L = plen // 2
        report.banner(f"PREAMBLE LENGTH: {plen} samples (L={L})")
        for channel in channels:
            print(f"\n--- {channel.upper()} ---")
            print(f"{'SNR':>6s}", end="")
            for f in fs_ratios:
                print(f" | FS={f:.2f}", end="")
            print()
            print("-" * (8 + 10 * len(fs_ratios)))
            for snr in snr_values:
                print(f"{snr:+5.0f}dB", end="")
                for f in fs_ratios:
                    match = [
                        r for r in results
                        if r.channel == channel and r.snr_db == snr
                        and r.full_scale_ratio == f and r.preamble_length == plen
                    ]
                    if match:
                        r = match[0]
                        print(f" | {r.timing_error:+5d}" if r.detected else " |  MISS", end="")
                    else:
                        print(" |   N/A", end="")
                print()

    report.banner("DETECTION RATE BY PREAMBLE LENGTH AND CHANNEL")
    for plen in preamble_lengths:
        print(f"\nPreamble L={plen // 2}:")
        for channel in channels:
            rs = [r for r in results if r.channel == channel and r.preamble_length == plen]
            det = sum(1 for r in rs if r.detected)
            pct = 100 * det / len(rs) if rs else 0
            print(f"  {channel:6s}: {det}/{len(rs)} ({pct:.0f}%)")

    report.banner("TIMING ERROR STATISTICS BY PREAMBLE LENGTH (detected only)")
    for plen in preamble_lengths:
        rs = [r for r in results if r.detected and r.preamble_length == plen]
        if rs:
            errs = [r.timing_error for r in rs]
            print(f"\nPreamble L={plen // 2}:")
            print(f"  Mean:   {np.mean(errs):+.1f} samples")
            print(f"  Std:    {np.std(errs):.1f} samples")
            print(f"  Range:  [{np.min(errs):+d}, {np.max(errs):+d}]")
            within = sum(1 for e in errs if abs(e) <= SYS.cp_len)
            print(f"  Within CP ({SYS.cp_len}): {within}/{len(errs)}")

    report.banner("CFO ERROR STATISTICS BY PREAMBLE LENGTH (detected only)")
    for plen in preamble_lengths:
        rs = [r for r in results if r.detected and r.preamble_length == plen]
        if rs:
            errs = [r.cfo_error_hz for r in rs]
            print(f"\nPreamble L={plen // 2}:")
            print(f"  Mean:   {np.mean(errs):+.1f} Hz")
            print(f"  Std:    {np.std(errs):.1f} Hz")
            print(f"  Range:  [{np.min(errs):+.1f}, {np.max(errs):+.1f}] Hz")
