#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels of `ofdm_sync_tpu_torch/kernels/csrc/` from this
checkout, then, for each ported path:

* Minn-RTL: checks kernels A and B against their plain PyTorch versions on
  the card, drives the flagship receive chain (`run_fused_rx_minn_rtl`) on
  the card and on the CPU, and runs the fused detector at the headline size
  (512 streams x 262144 samples x 2 branches, Q = 512) in float32 and
  int16, timed against the plain version;
* [A][A]: checks kernel C (both modes) and kernel B with peak capture
  against their plain versions, drives the [A][A] receive chain
  (`run_fused_rx`) and the fused grid sweep (`run_grid_test_fused`) on the
  card and on the CPU, and runs the fused detector at bench.py's secondary
  size (512 x 262144 x 2 branches, L = 512, float32), timed against the
  plain version.

Each path is driven with the launch counts set to 0 just before and read
just after; a kernel of the path that was not launched fails the run.  Any
failed check raises, so the exit code is non-zero and no result line is
printed.  The last three lines of standard output are the kernels' JSON
summary, the card's name and power limit, and the result line.  Needs
CUDA; there is no CPU path.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from ofdm_sync_tpu_torch.kernels import aa_fused as AF  # noqa: E402
from ofdm_sync_tpu_torch.kernels import build  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import launch_counts, reset_launch_counts  # noqa: E402
from ofdm_sync_tpu_torch.kernels.streaming import (  # noqa: E402
    aa_detect_step,
    aa_metric_planar,
    minn_rtl_metric_planar,
)
from ofdm_sync_tpu_torch.ops.detect import (  # noqa: E402
    extract_gate_events,
    extract_gate_events_capture,
)
from ofdm_sync_tpu_torch.pipelines.aa import run_grid_test_fused  # noqa: E402
from ofdm_sync_tpu_torch.pipelines.fused_rx import (  # noqa: E402
    run_fused_rx,
    run_fused_rx_minn_rtl,
)
from ofdm_sync_tpu_torch.testing import aa_stimulus, assert_tables_equal  # noqa: E402

KW = dict(smooth_shift=3, threshold_value=int(0.10 * (1 << 15)), threshold_frac_bits=15)
HYST = 2
#: |kernel - plain| on corr_positive, relative to max(1, |plain|max): both
#: take the window sums from float64 prefix sums, so they differ by a few
#: float32 roundings at most
CORR_RTOL = 2e-5
#: an above bit may differ only where the plain threshold margin
#: |smooth*2^frac - energy*T| is within this fraction of energy*T (the two
#: smoothing scans round in another order)
KNIFE_RTOL = 1e-5
HEADLINE = dict(batch=512, L=1 << 18, Q=512)
#: bench.py's secondary workload (bench.py:459-476): the [A][A] detector
AA_HEADLINE = dict(batch=512, n=1 << 18, lag=512)
AA_THR, AA_HYST = 0.15, 128


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def minn_stimulus(batch: int, L: int, Q: int, device, seed: int = 0, events=None):
    """(4, batch, L) integer-valued float32 noise round(8*N(0,1)) from a
    seeded generator on `device`, with 5Q preambles [-A,+A,+A,-A,-A]
    (scaled to small integers, built in NumPy) added at known positions.
    Integer values keep every window sum exact in both versions."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(Q) + 1j * rng.standard_normal(Q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    planes = [3.0 * np.round(24.0 * pre.real), 3.0 * np.round(24.0 * pre.imag)]
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((4, batch, L), generator=g, device=device).mul_(8.0).round_()
    if events is None:
        events = [(0, 3 * Q), (min(1, batch - 1), L // 3),
                  (min(2, batch - 1), L // 2), (min(3, batch - 1), L - 7 * Q)]
    for b, pos in events:
        for c in range(4):
            x[c, b, pos: pos + 5 * Q] += torch.as_tensor(planes[c % 2], dtype=torch.float32,
                                                          device=device)
    return x, events


def plain_metric(x, Q):
    return minn_rtl_metric_planar(F._planar_view(x), quarter_len=Q, **KW)


def check_metric(x, Q, what: str) -> float:
    """Kernel A vs the plain metric on the card; returns max |corr err|."""
    corr, above = F.minn_rtl_metric(x, quarter_len=Q, **KW)
    st = plain_metric(x, Q)
    torch.cuda.synchronize()
    ref = st.corr_positive
    err = float((corr - ref).abs().max()) if ref.numel() else 0.0
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    if err > CORR_RTOL * scale:
        raise AssertionError(f"{what}: corr_positive err {err} > {CORR_RTOL} * {scale}")
    diff = above != st.above_threshold
    if diff.any():
        e_s = st.energy_total * float(KW["threshold_value"])
        margin = (st.smooth_metric * float(1 << KW["threshold_frac_bits"]) - e_s).abs()
        knife = margin <= KNIFE_RTOL * e_s.abs()
        if (diff & ~knife).any():
            raise AssertionError(f"{what}: above differs off the knife edge "
                                 f"at {diff.nonzero()[:5].tolist()}")
        log(f"  {what}: {int(diff.sum())} above bit(s) differ on the knife edge")
    return err


def check_events(above, track, what: str, **kw) -> None:
    """Kernel B vs plain extract_gate_events on the same arrays: exact."""
    out = F.gate_events(above, track, **kw)
    ref = extract_gate_events(above, track, **kw)
    torch.cuda.synchronize()
    assert_tables_equal(ref, out, what)


def phase_kernels(dev) -> dict:
    log("== phase 3: kernels vs plain PyTorch on the card")
    errs = []
    cases = [  # (Q, batch, L, dtype): batch 5/7/3 fit no tile; L no chunk multiple
        (16, 5, 10_000, torch.float32),
        (24, 7, 9_001, torch.float32),
        (64, 3, 12_345, torch.int16),
        (512, 5, 40_000 + 17, torch.float32),
        (512, 3, 3 * 4096 + 5, torch.int16),
    ]
    for Q, batch, L, dt in cases:
        x, events = minn_stimulus(batch, L, Q, dev, seed=Q + L)
        x = x.to(dt)
        what = f"Q={Q} batch={batch} L={L} {str(dt)[6:]}"
        errs.append(check_metric(x, Q, what))
        st = plain_metric(x, Q)
        above, track = st.above_threshold.contiguous(), st.corr_positive.contiguous()
        for tie, emit in (("last", False), ("last", True), ("first", False), ("first", True)):
            check_events(above, track, f"{what} tie={tie} emit={emit}", hysteresis=HYST,
                         max_events=8, valid_from=st.valid_from, tie=tie, emit_unclosed=emit)
        fused = F.minn_rtl_detect_fused(x, quarter_len=Q, **KW, hysteresis=HYST)
        ref = extract_gate_events(above, track, hysteresis=HYST, max_events=8,
                                  valid_from=st.valid_from, tie="last", emit_unclosed=False)
        assert_tables_equal(ref, fused, f"{what} fused")
        found = sum(int(fused.count[b]) for b in sorted({b for b, _ in events}))
        if found < len({b for b, _ in events}):
            raise AssertionError(f"{what}: injected preambles not found")
        log(f"  {what}: ok (corr err {errs[-1]:.3g}, {int(fused.count.sum())} events)")

    # zero signal: the threshold is met trivially -> one unclosed gate
    x = torch.zeros((4, 3, 20_000), device=dev)
    errs.append(check_metric(x, 64, "zero signal"))
    t = F.minn_rtl_detect_fused(x, quarter_len=64, **KW, hysteresis=1, max_events=3,
                                emit_unclosed=True)
    if t.count.tolist() != [1, 1, 1] or t.closed.any():
        raise AssertionError(f"zero signal: expected one unclosed gate, got {t.count.tolist()}")
    # a stream shorter than one window
    x, _ = minn_stimulus(2, 700, 512, dev, events=[])
    errs.append(check_metric(x, 512, "short stream"))
    t = F.minn_rtl_detect_fused(x, quarter_len=512, **KW, hysteresis=HYST)
    if int(t.count.sum()) != 0:
        raise AssertionError("short stream: events before the metric is valid")
    # dense random gates: overflow, capacity 128, tie rules, h = 0 and 7
    g = torch.Generator(device=dev).manual_seed(7)
    for h, E, density in ((0, 3, 0.01), (7, 128, 0.02), (2, 8, 0.3)):
        above = torch.rand((6, 30_000), generator=g, device=dev) < density
        # quantized track: many exact ties for the tie rules
        track = torch.randint(0, 50, (6, 30_000), generator=g, device=dev).float()
        for tie in ("first", "last"):
            for emit in (False, True):
                check_events(above, track, f"dense h={h} E={E} tie={tie} emit={emit}",
                             hysteresis=h, max_events=E, valid_from=100, tie=tie,
                             emit_unclosed=emit)
        out = F.gate_events(above, track, hysteresis=h, max_events=E)
        if E < 128 and not bool(out.overflow.all()):
            raise AssertionError("dense gates: overflow not reported")
    log(f"  edge cases: ok")
    return {"corr_err": max(errs)}


def phase_slice(dev) -> dict:
    log("== phase 4: the receive chain, card vs CPU")
    reset_launch_counts()
    runs = {}
    for label, kw in (("awgn", dict(snr_db=30.0)), ("cir1", dict(channel_name="cir1"))):
        runs[label] = run_fused_rx_minn_rtl(cfo_hz=1000.0, seed=0, device=dev, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    for label, kw in (("awgn", dict(snr_db=30.0)), ("cir1", dict(channel_name="cir1"))):
        cpu = run_fused_rx_minn_rtl(cfo_hz=1000.0, seed=0, device="cpu", **kw)
        gpu = runs[label]
        if not (gpu.detected and len(gpu.frames) == 2 and len(cpu.frames) == 2):
            raise AssertionError(f"{label}: both frames must be recovered")
        if gpu.starts != cpu.starts:
            raise AssertionError(f"{label}: starts {gpu.starts} != {cpu.starts}")
        for fg, fc in zip(gpu.frames, cpu.frames):
            if abs(fg.cfo_error_hz - fc.cfo_error_hz) > 0.5:
                raise AssertionError(f"{label}: CFO differs by more than 0.5 Hz")
            if abs(fg.evm_pct - fc.evm_pct) > 0.05:
                raise AssertionError(f"{label}: EVM differs by more than 0.05 points")
        log(f"  {label}: card == cpu (starts {gpu.starts})")
    if min(counts["minn_rtl_metric"], counts["gate_events"]) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")
    log(f"  launches during the chain: {counts}")
    return counts


def cuda_ms(fn, warmup: int = 1, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_headline(dev, card: str) -> dict:
    B, L, Q = HEADLINE["batch"], HEADLINE["L"], HEADLINE["Q"]
    log(f"== phase 5: headline size {B} x {L} x 2 branches, Q={Q}")
    det = dict(quarter_len=Q, **KW, hysteresis=HYST)
    res = {}
    x32, events = minn_stimulus(B, L, Q, dev)
    for name in ("f32", "i16"):
        x = x32 if name == "f32" else x32.to(torch.int16)
        fused = F.minn_rtl_detect_fused(x, **det)
        st = plain_metric(x, Q)
        ref = extract_gate_events(st.above_threshold, st.corr_positive, hysteresis=HYST,
                                  max_events=8, valid_from=st.valid_from, tie="last",
                                  emit_unclosed=False)
        assert_tables_equal(ref, fused, f"headline {name}")
        for b, pos in events:
            pk = fused.peak_idx[b][fused.valid[b]].tolist()
            if not any(5 * Q <= p - pos <= 7 * Q for p in pk):
                raise AssertionError(f"headline {name}: preamble at {b}:{pos} not found")
        quiet = torch.ones(B, dtype=torch.bool, device=dev)
        quiet[[b for b, _ in events]] = False
        if int(fused.count[quiet].sum()) != 0:
            raise AssertionError(f"headline {name}: events in noise-only streams")
        del st, ref
        corr, above = F.minn_rtl_metric(x, quarter_len=Q, **KW)
        t_fused = cuda_ms(lambda: F.minn_rtl_detect_fused(x, **det))
        t_a = cuda_ms(lambda: F.minn_rtl_metric(x, quarter_len=Q, **KW))
        t_b = cuda_ms(lambda: F.gate_events(above, corr, hysteresis=HYST, max_events=8,
                                            valid_from=3 * Q - 1, tie="last",
                                            emit_unclosed=False))
        t_pa = cuda_ms(lambda: plain_metric(x, Q), reps=5)
        st = plain_metric(x, Q)
        t_pb = cuda_ms(lambda: extract_gate_events(
            st.above_threshold, st.corr_positive, hysteresis=HYST, max_events=8,
            valid_from=st.valid_from, tie="last", emit_unclosed=False), reps=5)
        del st, corr, above
        torch.cuda.empty_cache()
        n = B * L
        res[name] = dict(fused_ms=t_fused, a_ms=t_a, b_ms=t_b, plain_a_ms=t_pa,
                         plain_b_ms=t_pb, plain_ms=t_pa + t_pb)
        log(f"  {name}: kernels A+B {t_fused:.3f} ms = {n / t_fused * 1e3:.4g} samples/s "
            f"(A {t_a:.3f} ms, B {t_b:.3f} ms); plain {t_pa + t_pb:.3f} ms = "
            f"{n / (t_pa + t_pb) * 1e3:.4g} samples/s (metric {t_pa:.3f}, events "
            f"{t_pb:.3f}); card {card}")
    return res


# ---------------------------------------------------------------------------
# [A][A]: kernel C (both modes) and kernel B with peak capture
# ---------------------------------------------------------------------------

def aa_plain(x, lag):
    """The plain version of kernel C in detect mode: (state, track, M,
    above)."""
    st = aa_metric_planar(F._planar_view(x), lag)
    track, M, above = aa_detect_step(st.P_re, st.P_im, st.R, lag, AA_THR)
    return st, track, M, above


def aa_plain_detect(x, lag, **kw):
    """The plain version of `aa_detect_fused`: (table, captured)."""
    st, track, M, above = aa_plain(x, lag)
    return extract_gate_events_capture(above, track, (st.P_re, st.P_im, M),
                                       hysteresis=AA_HYST, max_events=8, **kw)


def check_equal(out, ref, what: str) -> float:
    """Bitwise equality on integer stimulus; returns max |out - ref|."""
    if out.shape != ref.shape or not torch.equal(out, ref):
        bad = (out != ref).nonzero()[:5].tolist() if out.shape == ref.shape else "shape"
        raise AssertionError(f"{what}: kernel differs from the plain version at {bad}")
    return float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0


def check_aa_found(table, events, lag, what: str) -> None:
    """Every injected preamble is found at frame start peak - 2L + 1 = pos +- 2."""
    for b, pos in events:
        pk = table.peak_idx[b][table.valid[b]].tolist()
        if not any(abs(p - 2 * lag + 1 - pos) <= 2 for p in pk):
            raise AssertionError(f"{what}: preamble at {b}:{pos} not found (peaks {pk})")


def check_aa_detect(x, lag, what: str, **kw):
    """`aa_detect_fused` (kernels C + B) vs its plain version: table,
    P_at_peak and M_at_peak equal."""
    table, P, M = AF.aa_detect_fused(x, half_len=lag, threshold=AA_THR, hysteresis=AA_HYST,
                                     **kw)
    ref, cap = aa_plain_detect(x, lag, **kw)
    torch.cuda.synchronize()
    assert_tables_equal(ref, table, what)
    check_equal(P, cap[:, :2], f"{what} P_at_peak")
    check_equal(M, cap[:, 2], f"{what} M_at_peak")
    return table


def phase_aa_kernels(dev) -> dict:
    log("== phase 6: [A][A] kernels vs plain PyTorch on the card")
    errs = []
    cases = [  # (L, batch, n, dtype): batch 5/7/3/9 fit no tile; n no chunk multiple
        (128, 5, 10_000, torch.float32),
        (256, 7, 9_001, torch.int16),
        (512, 3, 3 * 4096 + 5, torch.float32),
        (512, 5, 40_000 + 17, torch.int16),
        (128, 9, 2 * 4096, torch.float32),
    ]
    for lag, batch, n, dt in cases:
        events = [(0, 2 * lag), (min(1, batch - 1), n // 3), (min(2, batch - 1), n // 2),
                  (batch - 1, n - 2 * lag - 300)]
        x = aa_stimulus(batch, n, lag, dev, seed=lag + n, events=events).to(dt)
        what = f"L={lag} batch={batch} n={n} {str(dt)[6:]}"
        st, track, M, above = aa_plain(x, lag)
        P_re, P_im, R = AF.aa_metric_planar(x, half_len=lag)
        errs += [check_equal(P_re, st.P_re, f"{what} P_re"),
                 check_equal(P_im, st.P_im, f"{what} P_im"),
                 check_equal(R, st.R, f"{what} R")]
        o = AF.aa_metric(x, half_len=lag, threshold=AA_THR)
        for name, out, ref in (("P_re", o.P_re, st.P_re), ("P_im", o.P_im, st.P_im),
                               ("track", o.track, track), ("M", o.M, M),
                               ("above", o.above, above)):
            errs.append(check_equal(out, ref, f"{what} detect-mode {name}"))
        extras = (st.P_re, st.P_im, M)
        for tie, emit in (("first", True), ("first", False), ("last", True), ("last", False)):
            kw = dict(hysteresis=AA_HYST, max_events=8, tie=tie, emit_unclosed=emit)
            table, cap = F.gate_events_capture(above, track, extras, **kw)
            ref, rcap = extract_gate_events_capture(above, track, extras, **kw)
            assert_tables_equal(ref, table, f"{what} capture tie={tie} emit={emit}")
            check_equal(cap, rcap, f"{what} captured tie={tie} emit={emit}")
        table = check_aa_detect(x, lag, f"{what} fused")
        check_aa_found(table, events[:3], lag, what)
        log(f"  {what}: ok (bit-equal, {int(table.count.sum())} events)")

    # zero signal: no event, finite M
    x = torch.zeros((4, 3, 20_000), device=dev)
    t = check_aa_detect(x, 512, "zero signal")
    o = AF.aa_metric(x, half_len=512, threshold=AA_THR)
    if int(t.count.sum()) != 0 or not bool(torch.isfinite(o.M).all()):
        raise AssertionError("zero signal: expected no event and a finite M")
    # a stream shorter than 2L
    x = aa_stimulus(2, 2 * 512 - 1, 512, dev, events=[])
    if int(check_aa_detect(x, 512, "short stream").count.sum()) != 0:
        raise AssertionError("short stream: events before the metric is valid")
    # kernel B's dense cases of phase 3, with capture on
    g = torch.Generator(device=dev).manual_seed(7)
    for h, E, density in ((0, 3, 0.01), (7, 128, 0.02), (2, 8, 0.3)):
        above = torch.rand((6, 30_000), generator=g, device=dev) < density
        track = torch.randint(0, 50, (6, 30_000), generator=g, device=dev).float()
        extras = tuple(torch.randn((6, 30_000), generator=g, device=dev) for _ in range(3))
        for tie in ("first", "last"):
            for emit in (False, True):
                kw = dict(hysteresis=h, max_events=E, valid_from=100, tie=tie,
                          emit_unclosed=emit)
                table, cap = F.gate_events_capture(above, track, extras, **kw)
                ref, rcap = extract_gate_events_capture(above, track, extras, **kw)
                assert_tables_equal(ref, table, f"dense capture h={h} E={E} tie={tie}")
                check_equal(cap, rcap, f"dense captured h={h} E={E} tie={tie} emit={emit}")
    log("  edge cases: ok")
    return {"max_err": max(errs)}


def quiet(fn, *args, **kw):
    """Call fn with its report prints swallowed."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


AA_CHAIN_CASES = (
    ("awgn", dict(snr_db=10.0)),
    ("awgn x2", dict(snr_db=10.0, num_frames=2)),
    ("cir1", dict(channel_name="cir1")),
    ("cir1 x2", dict(channel_name="cir1", num_frames=2)),
)


def phase_aa_chain(dev) -> dict:
    log("== phase 7: the [A][A] receive chain, card vs CPU")
    reset_launch_counts()
    runs = {label: quiet(run_fused_rx, device=dev, **kw) for label, kw in AA_CHAIN_CASES}
    torch.cuda.synchronize()
    counts = launch_counts()
    for label, kw in AA_CHAIN_CASES:
        cpu = quiet(run_fused_rx, device="cpu", **kw)
        gpu = runs[label]
        want = kw.get("num_frames", 1)
        if not (gpu.detected and len(gpu.frames) == want and len(cpu.frames) == want):
            raise AssertionError(f"{label}: all {want} frame(s) must be recovered")
        if gpu.starts != cpu.starts:
            raise AssertionError(f"{label}: starts {gpu.starts} != {cpu.starts}")
        for fg, fc in zip(gpu.frames, cpu.frames):
            if abs(fg.cfo_error_hz - fc.cfo_error_hz) > 0.5:
                raise AssertionError(f"{label}: CFO differs by more than 0.5 Hz")
            if abs(fg.evm_pct - fc.evm_pct) > 0.05:
                raise AssertionError(f"{label}: EVM differs by more than 0.05 points")
        log(f"  {label}: card == cpu (starts {gpu.starts}, CFO error "
            f"{[round(f.cfo_error_hz, 2) for f in gpu.frames]} Hz, EVM "
            f"{[round(f.evm_pct, 2) for f in gpu.frames]} %)")
    if min(counts["aa_metric"], counts["gate_events"]) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")
    log(f"  launches during the chain: {counts}")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        quiet(run_fused_rx, device=dev, snr_db=10.0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"  chain wall (awgn, 1 frame, card): median {np.median(walls):.3f} ms of {walls}")
    return {"counts": counts, "chain_ms": float(np.median(walls))}


def phase_aa_sweep(dev) -> dict:
    log("== phase 8: the fused grid sweep (5 SNR x 5 full scale), card vs CPU")
    reset_launch_counts()
    gpu = run_grid_test_fused(device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    cpu = run_grid_test_fused(device="cpu")
    for k in ("detected", "frame_start", "num_events"):
        if not np.array_equal(gpu[k], cpu[k]):
            raise AssertionError(f"sweep {k}: card {gpu[k].tolist()} != cpu {cpu[k].tolist()}")
    det = cpu["detected"]
    if np.abs(gpu["cfo_est"] - cpu["cfo_est"])[det].max(initial=0.0) > 0.5:
        raise AssertionError("sweep: CFO differs by more than 0.5 Hz")
    if np.abs(gpu["metric_peak"] - cpu["metric_peak"]).max() > 1e-4:
        raise AssertionError("sweep: metric at the peak differs by more than 1e-4")
    if not det[-1, -1]:
        raise AssertionError("sweep: the 15 dB, 2x full-scale config must detect")
    if min(counts["aa_metric"], counts["gate_events"]) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")
    log(f"  card == cpu: detected {int(det.sum())}/25, timing errors "
        f"{gpu['timing_error'][det].tolist()}; launches {counts}")
    return {"counts": counts}


def phase_aa_headline(dev, card: str) -> dict:
    B, n, lag = AA_HEADLINE["batch"], AA_HEADLINE["n"], AA_HEADLINE["lag"]
    log(f"== phase 9: [A][A] detector at {B} x {n} x 2 branches, L={lag}, f32")
    events = [(0, 3 * lag), (1, n // 3), (2, n // 2), (3, n - 2 * lag - 700)]
    x = aa_stimulus(B, n, lag, dev, events=events)
    table = check_aa_detect(x, lag, "aa headline")
    check_aa_found(table, events, lag, "aa headline")
    quiet_streams = torch.ones(B, dtype=torch.bool, device=dev)
    quiet_streams[[b for b, _ in events]] = False
    if int(table.count[quiet_streams].sum()) != 0:
        raise AssertionError("aa headline: events in noise-only streams")
    torch.cuda.empty_cache()
    t_fused = cuda_ms(lambda: AF.aa_detect_fused(x, half_len=lag))
    t_metric = cuda_ms(lambda: AF.aa_metric_planar(x, half_len=lag))
    t_c = cuda_ms(lambda: AF.aa_metric(x, half_len=lag, threshold=AA_THR))
    o = AF.aa_metric(x, half_len=lag, threshold=AA_THR)
    t_b = cuda_ms(lambda: F.gate_events_capture(o.above, o.track, (o.P_re, o.P_im, o.M),
                                                hysteresis=AA_HYST, max_events=8))
    del o
    torch.cuda.empty_cache()
    t_pc = cuda_ms(lambda: aa_plain(x, lag))
    st, track, M, above = aa_plain(x, lag)
    t_pb = cuda_ms(lambda: extract_gate_events_capture(
        above, track, (st.P_re, st.P_im, M), hysteresis=AA_HYST, max_events=8))
    del st, track, M, above
    torch.cuda.empty_cache()
    N = B * n
    res = dict(fused_ms=t_fused, c_ms=t_c, b_ms=t_b, metric_mode_ms=t_metric,
               plain_c_ms=t_pc, plain_b_ms=t_pb, plain_ms=t_pc + t_pb)
    log(f"  kernels C+B {t_fused:.3f} ms = {N / t_fused * 1e3:.4g} samples/s (C {t_c:.3f} ms, "
        f"B with capture {t_b:.3f} ms; C metric mode {t_metric:.3f} ms); plain "
        f"{t_pc + t_pb:.3f} ms = {N / (t_pc + t_pb) * 1e3:.4g} samples/s (metric {t_pc:.3f}, "
        f"events {t_pb:.3f}); card {card}")
    return res



def main() -> int:
    t_start = time.perf_counter()
    log("== phase 1: device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke run needs a GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    log("== phase 2: build")
    info = build.build()
    build.library()
    log(f"  built {info.path.name} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    if any(launch_counts().values()):
        raise AssertionError(f"launch counters do not start at 0: {launch_counts()}")

    k = phase_kernels(dev)
    counts = phase_slice(dev)
    head = phase_headline(dev, card)
    aa_k = phase_aa_kernels(dev)
    aa_chain = phase_aa_chain(dev)
    aa_sweep = phase_aa_sweep(dev)
    aa_head = phase_aa_headline(dev, card)
    h32 = head["f32"]
    aa_launches = {name: aa_chain["counts"][name] + aa_sweep["counts"][name]
                   for name in counts}
    kernels = [
        dict(name="minn_rtl_metric", route="cuda",
             source="ofdm_sync_tpu_torch/kernels/csrc/minn_rtl_metric.cu",
             replaces="ofdm_sync_tpu/kernels/pallas_minn_tm.py:60",
             launches=counts["minn_rtl_metric"], max_abs_err=k["corr_err"],
             ms=h32["a_ms"], plain_ms=h32["plain_a_ms"]),
        dict(name="gate_events", route="cuda",
             source="ofdm_sync_tpu_torch/kernels/csrc/gate_events.cu",
             replaces="ofdm_sync_tpu/kernels/pallas_minn_tm.py:60, "
                      "ofdm_sync_tpu/kernels/pallas_aa.py:221",
             launches=counts["gate_events"] + aa_launches["gate_events"], max_abs_err=0.0,
             ms=h32["b_ms"], plain_ms=h32["plain_b_ms"]),
        dict(name="aa_metric", route="cuda",
             source="ofdm_sync_tpu_torch/kernels/csrc/aa_metric.cu",
             replaces="ofdm_sync_tpu/kernels/pallas_aa.py:71, "
                      "ofdm_sync_tpu/kernels/pallas_aa.py:221",
             launches=aa_launches["aa_metric"], max_abs_err=aa_k["max_err"],
             ms=aa_head["c_ms"], plain_ms=aa_head["plain_c_ms"]),
    ]
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"headline": head, "aa_headline": aa_head,
                      "aa_chain_ms": aa_chain["chain_ms"]}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
