#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --timing [TREE]   # the timed phases only, on TREE's kernels

Builds the CUDA kernels of `ofdm_sync_tpu_torch/kernels/csrc/` from this
checkout, then, for each ported path:

* Minn-RTL: checks kernels A and B against their plain PyTorch versions on
  the card, drives the flagship receive chain (`run_fused_rx_minn_rtl`) on
  the card and on the CPU, runs the batched receive
  (`receive_minn_rtl_frames`: on the card kernels G and H around one FFT)
  on a small batch against the same call's plain body on the card and
  against its CPU run of the same codes and table, one launch of each
  kernel, and again under `torch.cuda.set_sync_debug_mode("error")` (phase
  4b: a host synchronisation inside the call fails it), holds the kernels
  to the plain body on the card at the frame cell's batch too (K = E = 16:
  one launch of each, the same limits) and times the receive, each kernel,
  the FFT and the host's enqueue of a batch there beside the plain body
  (phase 4c), and runs the fused detector at the headline size
  (512 streams x 262144 samples x 2 branches, Q = 512) in float32 and
  int16, timed against the plain version, and on one long stream (1 x 2^24
  x 2 branches), checked against the plain version and timed;
* [A][A]: checks kernel C (both modes) and kernel B with peak capture
  against their plain versions, drives the [A][A] receive chain
  (`run_fused_rx`) and the fused grid sweep (`run_grid_test_fused`) on the
  card and on the CPU, and runs the fused detector at bench.py's secondary
  size (512 x 262144 x 2 branches, L = 512) on float32 and on int16 codes
  (the route of kernel C on the gate input alone, B plain and the peak
  capture, each checked against its plain version), timed against the
  plain version;
* [A][A], phase 8b: the plain grid sweep (`run_grid_test_batched`) against
  the fused one on the card for AWGN, cir1 and cir2 (every config's
  outcome equal, CFO within 1e-3 Hz; a differing config logs its knife
  edge and fails), both timed; kernels C + B (float32 and int16 codes)
  against the C++ [A][A] model (`native.aa_detect_native`) on the golden
  int12 stimulus, with and without its CFO, and on `rtl_stimulus` at
  L = 64 and 512 (event counts and peaks equal, P at each peak the C++
  value rounded once to float32); the `aa` simulation (`aa.main` without
  plots, its 225-config serial grid) on the card against the CPU; and
  `utils.profiling.kernel_stats` of C + B at the headline beside `cuda_ms`;
* Zadoff-Chu: checks kernel D (CFAR gate input, magnitude and IQ modes, f32
  and int16 IQ) and kernel E (matched filter, against a complex128 FFT
  convolution) against their plain versions, kernel B at h = 256, drives
  `ZCStreamingDetector.detect_fused` / `detect_fused_iq` on the card
  against the CPU `detect` and the `zc` / `zc_v2` simulations, and times
  bench.py's ZC workloads (the CFAR and from-IQ detectors at 512 x 262144
  (x 2 branches), kernel E and E -> D -> B at 64 x 262144 x 2, T = 2048)
  against the plain versions and kernel E against one `conv1d` call; the
  from-IQ headline also runs in 4 shards, each primed from its left
  neighbour's halo (kernel D's primed IQ mode), against the one-shot run
  and the plain version;
* streaming (phases 13-15): kernel A's full-metric and corr/energy modes at
  the Minn headline size and the primed (carried-state) modes of kernels A,
  B, C and D against their plain versions, and kernel F (the Minn-RTL
  stream step in one launch) against its plain version from random states;
  the fused stream steps (`kernels.streaming_chunked`: Minn-RTL kernel F,
  [A][A] C + B, ZC CFAR D + B) over 64 streams x 2^20 samples in chunks of
  4096 and 65536, their stitched tables against the one-shot tables,
  against the same steps with the plain versions of their kernels on the
  card, and against the CPU, with F launched once a Minn step and A and B
  not at all, and F timed beside the step composed of A + B; the per-block
  latency at batch 1 (p50 of synchronized steps, the host's enqueue time,
  and the marginal cost between 128 and 1152 steps) of F, of the composed
  A + B step and of the plain step beside the 133.3 us a 30.72 Msps stream
  allows, and a profiler window over 100 batch-1 steps that must hold one
  device kernel a step, F; the headline stream in 16 fused steps against
  one-shot A + B (tables and final state), F and each primed kernel
  against its plain version at that step's shape;
* families and the integer oracle (phase 16): the parity simulations of
  the families without a TPU kernel and of Minn-RTL (sc, minn, minn_rtl,
  park, zc_freq, combined_sc_minn) on the card against the reference's
  recorded values and the CPU run's integers; kernel A's corr/energy mode
  on int16 codes against the C++ integer model's traces (exact), kernel B
  on the C++ model's own traces against its events, A + B against its
  frame starts (within 16 samples), the C++ model built with g++
  (`ofdm_sync_tpu_torch/native.py`); each family's detect timed on one
  2^24 x 2 stream;
* the sharded path (phase 17, `ofdm_sync_tpu_torch.parallel`): (a) four
  ranks sharing the card over gloo (started with `spawn`, each loading the
  kernels this script built) run the sharded Minn-RTL detect at the
  headline (f32 and int16, meshes (1, 4) and (2, 2)), on the long stream
  (the overlap split off and on) and its receive chain, the sharded ZC
  from-IQ detect at phase 12's headline and the sharded [A][A] detect at
  phase 9's, with preambles across seams, halos and the overlap split;
  every rank's merged table must equal the one-shot kernels' table (a
  Minn event may differ only where its gate holds a knife-edge sample, as
  in phase 14) and the frames the one-shot `extract_frames`; (b) mesh
  (1, 1) over NCCL in this process: the sharded Minn detect (overlap split
  on and off) timed against the one-shot A + B, and kernel A on a shard's
  interior view read in place (its strided mode) against `.contiguous()`
  of the view plus the kernel;
* the rest of the sharded layer (phase 18): (a) four gloo ranks on
  meshes (1, 4) and (2, 2) run the Minn-RTL metric with the blocked IIR
  (kernel A's full mode primed, then the carry fix-up), the [A][A] metric
  (kernel C's metric mode primed) and the Schmidl-Cox metric, each held in
  the rank to the one-shot kernels (or the plain S&C metric) on the same
  seeded stimulus; the Minn-RTL detect with the per-sample merge, the ZC
  CFAR detect (kernel D's magnitude mode primed, kernel B carried) and the
  ZC detect from IQ (kernel E, then kernel D's primed IQ mode; and with
  the FFT convolution put in E's place as a witness), every rank's
  table against the one-shot kernels' table (an event may differ only
  where its gate holds a knife-edge sample); then `dryrun_multichip(4)`;
  (b) mesh (1, 1) over NCCL: each of them timed against the one-shot
  kernels, with its halo, kernel, fix-up or priming and merge timed alone;
* the benches (phase 19): ``python -m ofdm_sync_tpu_torch bench`` and
  ``python -m ofdm_sync_tpu_torch.bench_scaling``, each in a process of
  its own, their lines (written to ``bench_out/bench_torch.json`` and
  ``bench_out/scaling_torch.json`` under this checkout) checked: every
  on-card check "ok", the card named, every figure, bound and share a
  positive number, the sharded tables equal, the collective counts as
  coded, the int16 wire bit-identical, the overlap split's order held.

Each path is driven with the launch counts set to 0 just before and read
just after; a kernel of the path that was not launched fails the run.  Any
failed check raises, so the exit code is non-zero and no result line is
printed.  The last three lines of standard output are the kernels' JSON
summary (with each kernel's bound: bytes over 3.35 TB/s or flops over 67
TFLOP/s, the larger, from the work counts of
`ofdm_sync_tpu_torch.utils.roofline`), the card's name and power limit,
and the result line.  Needs
CUDA; there is no CPU path.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
#: ``--timing [TREE]``: only the timed phases (4c, 5, 13, 15, and the kernel
#: C, D and E timings of 9 and 12), on the kernels of the checkout TREE (default:
#: this one), so that two trees are timed by the same script on the same card
TIMING = "--timing" in sys.argv[1:]
_AT = sys.argv.index("--timing") + 1 if TIMING else 0
TREE = os.path.abspath(sys.argv[_AT]) if TIMING and _AT < len(sys.argv) else ROOT
sys.path.insert(0, TREE)

from ofdm_sync_tpu_torch import bench as BENCH  # noqa: E402
from ofdm_sync_tpu_torch.bench import card_line  # noqa: E402
from ofdm_sync_tpu_torch.kernels import aa_fused as AF  # noqa: E402
from ofdm_sync_tpu_torch.kernels import build  # noqa: E402
from ofdm_sync_tpu_torch.kernels import matched_filter as MF  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels import streaming as SP  # noqa: E402
from ofdm_sync_tpu_torch.kernels import streaming_chunked as ST  # noqa: E402
from ofdm_sync_tpu_torch.kernels import zc_fused as ZF  # noqa: E402

try:  # kernels G and H; a tree timed by ``--timing`` may predate them
    from ofdm_sync_tpu_torch.kernels import minn_rx as RK  # noqa: E402
except ImportError:
    RK = None
from benchmark import harness as BH  # noqa: E402
from benchmark import stimulus as BS  # noqa: E402
from benchmark.preambles import minn_rtl_frame  # noqa: E402
from benchmark.reference import minn_rtl_rx as RXREF  # noqa: E402
from benchmark.work.rx_counts import rx_demod_work  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import (  # noqa: E402
    launch_counts,
    mode_launch_counts,
    reset_launch_counts,
)
from ofdm_sync_tpu_torch.kernels.streaming import (  # noqa: E402
    aa_detect_step,
    aa_metric_planar,
    aa_peak_capture_plain,
    minn_rtl_corr_energy_planar,
    minn_rtl_metric_planar,
    zc_cfar_planar,
    zc_iq_planar,
)
from ofdm_sync_tpu_torch.models import detectors as D  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import ZCStreamingDetector  # noqa: E402
from ofdm_sync_tpu_torch.native import minn_rtl_detect_native  # noqa: E402
from ofdm_sync_tpu_torch.ops.detect import (  # noqa: E402
    GateEvents,
    extract_gate_events,
    extract_gate_events_capture,
    extract_gate_events_carried,
)
from ofdm_sync_tpu_torch.ops import waveforms as WV  # noqa: E402
from ofdm_sync_tpu_torch.ops.extract import extract_frames  # noqa: E402
from ofdm_sync_tpu_torch.ops.metrics import sc_metric  # noqa: E402
from ofdm_sync_tpu_torch.ops.waveforms import build_pss_symbol  # noqa: E402
from ofdm_sync_tpu_torch.ops.windows import cumsum, running_sum_stream  # noqa: E402
from ofdm_sync_tpu_torch.params import SYS_30M72, MinnRTLParams, SystemParams  # noqa: E402
from ofdm_sync_tpu_torch.parallel import distributed as DI  # noqa: E402
from ofdm_sync_tpu_torch.parallel import dryrun as DR  # noqa: E402
from ofdm_sync_tpu_torch.parallel import shard as SH  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import (  # noqa: E402
    combined_sc_minn,
    minn,
    minn_rtl,
    park,
    sc,
    zc,
    zc_freq,
    zc_v2,
)
from ofdm_sync_tpu_torch.pipelines import aa  # noqa: E402
from ofdm_sync_tpu_torch.pipelines.aa import run_grid_test_fused  # noqa: E402
from ofdm_sync_tpu_torch.pipelines.common import build_setup  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import fused_rx as RXP  # noqa: E402
from ofdm_sync_tpu_torch.pipelines.fused_rx import (  # noqa: E402
    RxSlots,
    receive_minn_rtl_frames,
    run_fused_rx,
    run_fused_rx_minn_rtl,
)
from ofdm_sync_tpu_torch.native import aa_detect_native  # noqa: E402
from ofdm_sync_tpu_torch.testing import (  # noqa: E402
    aa_int12_stimulus,
    aa_stimulus,
    assert_tables_equal,
    event_tuples,
    mag_stimulus,
    mf_reference,
    minn_stimulus,
    native_events,
    rtl_channel_leading,
    rel_err,
    rtl_stimulus,
    table_arrays,
    zc_iq_stimulus,
)
from ofdm_sync_tpu_torch.utils import profiling  # noqa: E402
from ofdm_sync_tpu_torch.utils.profiling import (  # noqa: E402
    cuda_ms,
    device_ms,
    kernel_ms,
)
from ofdm_sync_tpu_torch.utils.roofline import (  # noqa: E402
    a_work,
    b_work,
    bound,
    bound_sum,
    c_work,
    cap_work,
    d_iq_work,
    d_mag_work,
    e_work,
    f_work,
    gated_samples,
)

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
#: one long capture: 1 x 2^24 x 2 branches f32 (256 MiB of IQ)
LONG = dict(L=1 << 24)
#: bench.py's secondary workload (bench.py:459-476): the [A][A] detector
AA_HEADLINE = dict(batch=512, n=1 << 18, lag=512)
AA_THR, AA_HYST = 0.15, 128


def log(msg: str) -> None:
    print(msg, flush=True)


def card_device() -> torch.device:
    return torch.device("cuda", 0)


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


#: the batched receive's small batch: streams, samples, frames a stream
RX_BATCH = dict(batch=16, L=1 << 16, frames=4)
#: card against CPU: CFO (Hz), EVM (relative), equalized bins (over max(1, |eq|))
RX_TOL = dict(cfo_hz=1e-2, evm=1e-4, eq=1e-4)
#: kernels G and H against the plain body (on the card and on the CPU):
#: PERF.md section 2's limits of the receive, the equalized bins judged
#: outside the weak bins of a float64 channel estimate, as the benchmark
#: judges them (`benchmark.reference.minn_rtl_rx`)
RX_KERNEL_TOL = dict(cfo_hz=RXREF.LIMITS["cfo_gap_hz"], evm=RXREF.LIMITS["evm_gap"],
                     eq=RXREF.LIMITS["eq_gap"])
#: the frame cell's configuration and its batch for phase 4c's timing
RX_CELL = "minn_rtl_rx.frames"
RX_SEED = 2**31 + 2424


def rx_frames_stimulus(batch: int, L: int, frames: int, seed: int = 0):
    """(int16 codes (4, batch, L), pilot and data values (complex64)): a
    Minn-RTL frame [5Q preamble | pilot | data] at a seeded position in
    each of ``frames`` segments of every stream, 2 branches (gains 1.0 and
    0.8, a random phase each), a CFO per stream within +-1 kHz, noise of 32
    codes, 12-bit codes."""
    rng = np.random.default_rng(seed)
    pre = WV.build_minn_rtl_preamble("qpsk_freq", rng, Q=512)
    pilot, pilot_used = WV.build_random_qpsk_symbol(rng)
    data, data_used = WV.build_random_qpsk_symbol(rng)
    frame = np.concatenate([pre, pilot, data])
    seg = L // frames
    x = 32.0 * rng.standard_normal((2, batch, L)) + 32j * rng.standard_normal((2, batch, L))
    n = np.arange(L)
    for b in range(batch):
        cfo, amp = rng.uniform(-1000.0, 1000.0), 32.0 * 10 ** (rng.uniform(0.0, 20.0) / 20)
        tone = np.exp(2j * np.pi * cfo / SYS_30M72.sample_rate_hz * n)
        for f in range(frames):
            at = f * seg + int(rng.integers(0, seg - frame.size))
            for br, gain in enumerate((1.0, 0.8)):
                rot = amp * gain * np.exp(2j * np.pi * rng.uniform())
                x[br, b, at: at + frame.size] += rot * frame * tone[at: at + frame.size]
    planes = np.stack([x[0].real, x[0].imag, x[1].real, x[1].imag])
    codes = torch.from_numpy(np.clip(np.round(planes), -2047, 2047).astype(np.int16))
    used = lambda v: torch.as_tensor(v).to(torch.complex64)  # noqa: E731
    return codes, used(pilot_used), used(data_used)


def rx_gaps(out: RxSlots, ref: RxSlots, weak=None) -> dict:
    """The largest CFO (Hz), relative EVM and equalized-bin differences at
    the valid slots, the bins where ``weak`` (batch, K, bins) is set left
    out; starts, valid and the empty slots' zeros exactly."""
    if not (torch.equal(out.valid, ref.valid) and torch.equal(out.starts, ref.starts)):
        raise AssertionError("the batched receive's slots differ from the CPU run's")
    v = ref.valid
    for f in RxSlots._fields:
        if bool(getattr(out, f)[~v].ne(0).any()):
            raise AssertionError(f"an empty slot's {f} is not zero")
    dq = (out.eq - ref.eq).abs() / ref.eq.abs().clamp_min(1.0)
    if weak is not None:
        dq = dq.masked_fill(weak, 0.0)
    return {"cfo_hz": float((out.cfo_hz - ref.cfo_hz)[v].abs().max()),
            "evm": float(((out.evm_rms - ref.evm_rms).abs() / ref.evm_rms)[v].max()),
            "eq": float(dq[v].max())}


def rx_config(K: int, sys_p: SystemParams = SYS_30M72, Q: int = 512) -> dict:
    """The numbers of `benchmark.reference.minn_rtl_rx.demod` for a Minn-RTL
    receiver of quarter Q on ``sys_p`` (by default the flagship: Q 512, N
    2048, CP 512, 1,200 used bins) at K slots."""
    return {"system": {"n_fft": sys_p.n_fft, "cp_len": sys_p.cp_len,
                       "num_active": sys_p.num_active, "sample_rate_hz": sys_p.sample_rate_hz},
            "detector": {"quarter_len": Q},
            "receive": {"timing_offset": 0, "pilot_cp_offset": 5 * Q, "max_frames": K}}


def rx_weak(x, starts, pilot, data, sys_p: SystemParams = SYS_30M72, Q: int = 512):
    """The weak bins of the slots at ``starts`` (batch, K): where a float64
    LS channel estimate of the slot's own window falls below `RXREF.WEAK`
    of its RMS, the rule by which the benchmark leaves bins out of
    ``eq_gap``; (batch, K, num_active) bool on x's device, computed in
    blocks of `RXREF.ROWS` streams."""
    c = lambda t: t.to(x.device, torch.complex128)  # noqa: E731
    cfg = rx_config(starts.shape[1], sys_p, Q)
    out = []
    for r in range(0, x.shape[1], RXREF.ROWS):
        h = RXREF.demod(x[:, r: r + RXREF.ROWS], starts[r: r + RXREF.ROWS].long(), cfg,
                        c(pilot), c(data))["h"].abs()
        out.append(h < RXREF.WEAK * h.square().mean(-1, keepdim=True).sqrt())
    return torch.cat(out)


def phase_receive(dev) -> dict:
    """The batched receive (`receive_minn_rtl_frames`: on the card kernels G
    and H around one FFT) against the same call's plain body on the card and
    against its CPU run on the same codes and table, and the plain body on
    the card against the CPU; then again under
    `torch.cuda.set_sync_debug_mode("error")`, so a host synchronisation
    inside the call fails the phase; its counters and launches."""
    log("== phase 4b: the batched receive, kernels G + H vs the plain body on the card and "
        "on the CPU, no host sync")
    x, pilot, data = rx_frames_stimulus(**RX_BATCH)
    kw = dict(max_frames=8)
    det = dict(quarter_len=512, **KW, hysteresis=HYST, max_events=8, tie="last",
               emit_unclosed=False)
    reset_launch_counts()
    xg = x.to(dev)
    table = F.minn_rtl_detect_fused(xg, **det)
    pg, dg = pilot.to(dev), data.to(dev)
    out = receive_minn_rtl_frames(xg, table, pilot_used=pg, data_used=dg, **kw)
    torch.cuda.synchronize()
    counts, modes = launch_counts(), mode_launch_counts()
    if min(counts["minn_rtl_metric"], counts["gate_events"]) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")
    if (counts["minn_rx_front"], counts["minn_rx_back"]) != (1, 1) or (
            modes.get("minn_rx_front/int16"), modes.get("minn_rx_back/int16")) != (1, 1):
        raise AssertionError(f"kernels G and H: {counts}, {modes}")
    calls, slots = receive_minn_rtl_frames.calls, receive_minn_rtl_frames.slots
    if (calls, slots) != (1, RX_BATCH["batch"] * kw["max_frames"]):
        raise AssertionError(f"receive counters {calls} calls, {slots} slots")
    plain = RXP.receive_minn_rtl_frames_plain(xg, table, pilot_used=pg, data_used=dg, **kw)
    host_table = table._replace(**{f: getattr(table, f).cpu() for f in table._fields})
    cpu = receive_minn_rtl_frames(x, host_table, pilot_used=pilot, data_used=data, **kw)
    valid = int(cpu.valid.sum())
    if valid < RX_BATCH["batch"] * RX_BATCH["frames"] - 2:
        raise AssertionError(f"only {valid} frames found")
    host = lambda o: RxSlots(*(t.cpu() for t in o))  # noqa: E731
    weak = rx_weak(x, cpu.starts, pilot, data)
    gaps = {"plain_vs_cpu": rx_gaps(host(plain), cpu),
            "kernels_vs_plain": rx_gaps(host(out), host(plain), weak),
            "kernels_vs_cpu": rx_gaps(host(out), cpu, weak)}
    for pair, tols in (("plain_vs_cpu", RX_TOL), ("kernels_vs_plain", RX_KERNEL_TOL),
                       ("kernels_vs_cpu", RX_KERNEL_TOL)):
        for k, tol in tols.items():
            if not gaps[pair][k] <= tol:
                raise AssertionError(f"{pair}: {k} gap {gaps[pair][k]} over {tol}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = receive_minn_rtl_frames(xg, table, pilot_used=pg, data_used=dg, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if any(not torch.equal(a, b) for a, b in zip(again, out)):
        raise AssertionError("the call under sync debug mode differs from the first")
    log(f"  {valid} frames, {int(weak[cpu.valid].sum())} weak bins left out of the kernels' "
        f"eq gaps: {gaps}; no host sync inside the call under set_sync_debug_mode('error')")
    return {"frames": valid, "gaps": gaps, "calls": receive_minn_rtl_frames.calls,
            "launches": {k: counts[k] for k in ("minn_rx_front", "minn_rx_back")}}


def rx_headline(dev):
    """The frame cell's batch (512 streams of 262,144 int16 codes x 2
    branches, 16 frames a stream) made on the card by the benchmark's
    generator, its detector's arguments and table from kernels A + B, and
    the receive's arguments."""
    cell = BH.Cell(BH.load_spec(Path(TREE)), RX_CELL, Path(TREE))
    cfg, tr = cell.config, cell.traffic
    x = BS.streams(cfg, tr, BS.seeded(RX_SEED, dev), tr["batch"], tr["samples"], dev)
    det = cfg["detector"]
    det_kw = {k: det[k] for k in ("quarter_len", "smooth_shift", "threshold_value",
                                  "threshold_frac_bits", "hysteresis", "max_events", "tie",
                                  "emit_unclosed")}
    table = F.minn_rtl_detect_fused(x, **det_kw)
    sys_c, rx = cfg["system"], cfg["receive"]
    sys_p = SystemParams(n_fft=sys_c["n_fft"], num_active=sys_c["num_active"],
                         cp_len=sys_c["cp_len"], sample_rate_hz=sys_c["sample_rate_hz"])
    pilot, data = (torch.as_tensor(v, dtype=torch.complex64, device=dev)
                   for v in minn_rtl_frame.symbols(cfg))
    kw = dict(sys=sys_p, params=MinnRTLParams(quarter_len=det["quarter_len"],
                                              timing_offset=rx["timing_offset"]),
              pilot_used=pilot, data_used=data, max_frames=rx["max_frames"])
    return det_kw, x, table, kw


def enqueue_ms(fn, reps: int = 20) -> float:
    """Median host time to enqueue one fn() (no profiler attached, no host
    sync between the calls, so the card runs behind the host)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def rx_kernel_work(batch: int, K: int, C: int, itemsize: int, n_fft: int, cp: int,
                   A: int) -> dict:
    """(bytes, flops) of kernels G and H alone, each input read once and each
    output written once: G reads the table and each slot's pilot CP, pilot
    and data symbol of every plane and writes 2 N complex64 and the slot's
    start, valid and CFO; H reads each slot's 2 A used bins and valid (the
    known values, shared, once) and writes A complex64, the EVM pair and
    the gain."""
    slots = batch * K
    g = (slots * (cp + 2 * n_fft) * C * itemsize + batch * K * 5 + batch * 4
         + slots * (2 * n_fft * 8 + 9))
    g_flops = slots * (8 * (C // 2) * cp + 8 * (C // 2) * 2 * n_fft)
    h = slots * (2 * A * 8 + 1 + A * 8 + 16) + 2 * A * 8
    h_flops = slots * A * (2 * 11 + 2 * 8 + 6 + 5)
    return {"front": (g, g_flops), "back": (h, h_flops)}


def timing_receive(dev, card: str) -> dict:
    """Phase 4c: the batched receive at the frame cell's batch.  Where the
    tree has kernels G and H: one call of the kernel path against the plain
    body on the card, under `RX_KERNEL_TOL` outside the weak bins, with one
    launch of each kernel in int16 mode.  Then timed: the whole call (a
    tree before the kernels runs its plain body there), the host's enqueue
    of a batch (detection and receive) against the card's time for it,
    each kernel and the FFT alone, and the plain body, the yardstick."""
    det_kw, x, table, kw = rx_headline(dev)
    B, L = x.shape[1], x.shape[2]
    log(f"== phase 4c: the batched receive at the frame cell's batch, {B} x {L} x 2 int16, "
        f"{kw['max_frames']} slots a stream")
    run = lambda: receive_minn_rtl_frames(x, table, **kw)  # noqa: E731
    plain = getattr(RXP, "receive_minn_rtl_frames_plain", RXP.receive_minn_rtl_frames)
    run_plain = lambda: plain(x, table, **kw)  # noqa: E731
    res = {}
    if RK is not None:
        # the kernel path against the plain body at this shape (K = E = 16),
        # one launch of each kernel in int16 mode
        reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        counts, modes = launch_counts(), mode_launch_counts()
        if (counts["minn_rx_front"], counts["minn_rx_back"]) != (1, 1) or (
                modes.get("minn_rx_front/int16"), modes.get("minn_rx_back/int16")) != (1, 1):
            raise AssertionError(f"kernels G and H at the frame cell's batch: {counts}, {modes}")
        ref = run_plain()
        weak = rx_weak(x, ref.starts, kw["pilot_used"], kw["data_used"], kw["sys"],
                       kw["params"].quarter_len)
        gaps = rx_gaps(out, ref, weak)
        for k, tol in RX_KERNEL_TOL.items():
            if not gaps[k] <= tol:
                raise AssertionError(f"kernels vs plain at the frame cell's batch: {k} gap "
                                     f"{gaps[k]} over {tol}")
        res.update(frames=int(ref.valid.sum()), weak_bins=int(weak[ref.valid].sum()),
                   gaps=gaps, launches={k: counts[k] for k in ("minn_rx_front", "minn_rx_back")})
        log(f"  kernels vs plain body on the card at this batch: {res['frames']} frames, "
            f"{res['weak_bins']} weak bins left out of eq: {gaps}")
        del out, ref, weak
    res.update(receive_ms=cuda_ms(run), receive_device_ms=device_ms(run),
               receive_kernel_ms=kernel_ms(run))
    # the host's share of a batch, untraced: the time to enqueue the
    # detection and the receive against the card's time for both
    detect = lambda: F.minn_rtl_detect_fused(x, **det_kw)  # noqa: E731
    step = lambda: receive_minn_rtl_frames(x, detect(), **kw)  # noqa: E731
    res.update(detect_enqueue_ms=enqueue_ms(detect), receive_enqueue_ms=enqueue_ms(run),
               step_enqueue_ms=enqueue_ms(step), step_device_ms=device_ms(step))
    res["plain_ms"], res["plain_kernel_ms"] = cuda_ms(run_plain, reps=3), kernel_ms(run_plain, 3)
    sysp, K = kw["sys"], min(kw["max_frames"], table.peak_idx.shape[1])
    n_fft, cp, A = sysp.n_fft, sysp.cp_len, sysp.num_active
    res["bound_ms"] = bound(*rx_demod_work(B, K, x.shape[0], x.element_size(), n_fft, cp, A,
                                           table.peak_idx.shape[1]))[0]
    if RK is not None:
        Q = kw["params"].quarter_len
        front = lambda: RK.minn_rx_front(  # noqa: E731
            x, table, n_fft=n_fft, cp_len=cp, pilot_cp=5 * Q,
            offset=kw["params"].timing_offset - 6 * Q, max_frames=kw["max_frames"],
            sample_rate_hz=sysp.sample_rate_hz)
        f = front()
        bins = torch.fft.fft(f.comb)
        back = lambda: RK.minn_rx_back(  # noqa: E731
            bins, f.valid, kw["pilot_used"], kw["data_used"], num_active=A,
            codes_dtype=x.dtype)
        work = rx_kernel_work(B, K, x.shape[0], x.element_size(), n_fft, cp, A)
        for name, fn in (("front", front), ("back", back)):
            res[f"{name}_ms"], res[f"{name}_kernel_ms"] = cuda_ms(fn), kernel_ms(fn)
            res[f"{name}_bound_ms"] = bound(*work[name])[0]
            res[f"{name}_work"] = work[name]
        res["fft_kernel_ms"] = kernel_ms(lambda: torch.fft.fft(f.comb))
        del f, bins
    torch.cuda.empty_cache()
    log(f"  receive {res['receive_ms']:.4f} ms a batch (back to back "
        f"{res['receive_device_ms']:.4f}; profiler {res['receive_kernel_ms']}) against its "
        f"{res['bound_ms']:.4f} ms bound; host enqueue of a batch (detect + receive) "
        f"{res['step_enqueue_ms']:.4f} ms against its {res['step_device_ms']:.4f} ms on the "
        f"card (detect {res['detect_enqueue_ms']:.4f}, receive "
        f"{res['receive_enqueue_ms']:.4f}); plain body {res['plain_ms']:.3f} ms (profiler "
        f"{res['plain_kernel_ms']}); " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.items() if k.startswith(("front", "back", "fft"))
            and isinstance(v, float)) + f"; card {card}")
    return res


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
        if name == "i16" and not TIMING:
            # int16 codes without a history: kernel A's exact integer path,
            # every tile of it on the integer route at these 12-bit codes
            fails = torch.zeros(1, dtype=torch.int32, device=dev)
            before = mode_launch_counts().get("minn_rtl_metric/exact_i16", 0)
            F._minn_metric(x, "corr_above", quarter_len=Q, **KW, failed_tiles=fails)
            exact = mode_launch_counts().get("minn_rtl_metric/exact_i16", 0) - before
            if exact != 1 or int(fails) != 0:
                raise AssertionError(f"headline i16: {exact} exact launches, {int(fails)} tiles "
                                     "on the float route")
        corr, above = F.minn_rtl_metric(x, quarter_len=Q, **KW)
        gated = gated_samples(above, HYST)
        t_fused = cuda_ms(lambda: F.minn_rtl_detect_fused(x, **det))
        t_a = cuda_ms(lambda: F.minn_rtl_metric(x, quarter_len=Q, **KW))
        run_b = lambda: F.gate_events(above, corr, hysteresis=HYST, max_events=8,  # noqa: E731
                                      valid_from=3 * Q - 1, tie="last", emit_unclosed=False)
        t_b, t_b_dev, t_b_kernel = cuda_ms(run_b), device_ms(run_b), kernel_ms(run_b)
        t_a_kernel = kernel_ms(lambda: F.minn_rtl_metric(x, quarter_len=Q, **KW))
        t_pa = cuda_ms(lambda: plain_metric(x, Q), reps=5)
        st = plain_metric(x, Q)
        t_pb = cuda_ms(lambda: extract_gate_events(
            st.above_threshold, st.corr_positive, hysteresis=HYST, max_events=8,
            valid_from=st.valid_from, tie="last", emit_unclosed=False), reps=5)
        del st, corr, above
        torch.cuda.empty_cache()
        n = B * L
        res[name] = dict(fused_ms=t_fused, a_ms=t_a, b_ms=t_b, b_device_ms=t_b_dev,
                         a_kernel_ms=t_a_kernel, b_kernel_ms=t_b_kernel, plain_a_ms=t_pa,
                         plain_b_ms=t_pb, plain_ms=t_pa + t_pb, b_gated=gated)
        log(f"  {name}: kernels A+B {t_fused:.3f} ms = {n / t_fused * 1e3:.4g} samples/s "
            f"(A {t_a:.3f} ms, B {t_b:.3f} ms, B back to back {t_b_dev:.4f} ms; profiler: A "
            f"{t_a_kernel} ms, B {t_b_kernel} ms); plain "
            f"{t_pa + t_pb:.3f} ms = "
            f"{n / (t_pa + t_pb) * 1e3:.4g} samples/s (metric {t_pa:.3f}, events "
            f"{t_pb:.3f}); card {card}")
    return res


def phase_long(dev, card: str) -> dict:
    """One long capture, f32: kernels A and B against their plain versions
    on the card (metric by the phase-3 rules, tables equal), then A, B and
    A + B timed."""
    L, Q = LONG["L"], HEADLINE["Q"]
    log(f"== phase 5, long stream: 1 x {L} x 2 branches f32, Q={Q} "
        f"({L / 30.72e6:.2f} s at 30.72 Msps)")
    # sixteen preambles, some across kernel A's and kernel B's span seams
    events = [(0, 3 * Q)] + [(0, k * (L // 16) + L // 1024 * (k % 3) - 2 * Q - 100 * k)
                             for k in range(1, 16)]
    x, _ = minn_stimulus(1, L, Q, dev, seed=5, events=events)
    det = dict(quarter_len=Q, **KW, hysteresis=HYST, max_events=32)
    err = check_metric(x, Q, "long stream")
    fused = F.minn_rtl_detect_fused(x, **det)
    st = plain_metric(x, Q)
    ref = extract_gate_events(st.above_threshold, st.corr_positive, hysteresis=HYST,
                              max_events=32, valid_from=st.valid_from, tie="last",
                              emit_unclosed=False)
    assert_tables_equal(ref, fused, "long stream")
    pk = fused.peak_idx[0][fused.valid[0]].tolist()
    missing = [pos for _, pos in events if not any(5 * Q <= p - pos <= 7 * Q for p in pk)]
    if missing:
        raise AssertionError(f"long stream: preambles at {missing} not found")
    del st, ref
    corr, above = F.minn_rtl_metric(x, quarter_len=Q, **KW)
    bkw = dict(hysteresis=HYST, max_events=32, valid_from=3 * Q - 1, tie="last",
               emit_unclosed=False)
    run_a = lambda: F.minn_rtl_metric(x, quarter_len=Q, **KW)  # noqa: E731
    run_b = lambda: F.gate_events(above, corr, **bkw)  # noqa: E731
    run_ab = lambda: F.minn_rtl_detect_fused(x, **det)  # noqa: E731
    gated = gated_samples(above, HYST)
    res = dict(corr_err=err, events=int(fused.count.sum()), gated=gated,
               a_bound_ms=bound(*a_work(1, L, 4, 4, 5))[0],
               b_bound_ms=bound(*b_work(above, gated, E=32))[0],
               a_ms=cuda_ms(run_a), b_ms=cuda_ms(run_b), fused_ms=cuda_ms(run_ab),
               a_device_ms=device_ms(run_a), b_device_ms=device_ms(run_b),
               fused_device_ms=device_ms(run_ab), a_kernel_ms=kernel_ms(run_a),
               b_kernel_ms=kernel_ms(run_b), fused_kernel_ms=kernel_ms(run_ab))
    del x, corr, above, fused
    torch.cuda.empty_cache()
    log(f"  A+B == plain ({res['events']} events); A {res['a_ms']:.4f} ms, B {res['b_ms']:.4f} ms, "
        f"A+B {res['fused_ms']:.4f} ms; back to back: A {res['a_device_ms']:.4f}, B "
        f"{res['b_device_ms']:.4f}, A+B {res['fused_device_ms']:.4f} ms; profiler: A "
        f"{res['a_kernel_ms']}, B {res['b_kernel_ms']}, A+B {res['fused_kernel_ms']} ms; "
        f"card {card}")
    return res


# ---------------------------------------------------------------------------
# [A][A]: kernel C (both modes), kernel B with peak capture, the peak capture
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


# ---------------------------------------------------------------------------
# phase 8b: the plain grid sweep against the fused one, kernels C + B against
# the C++ [A][A] model, the `aa` simulation, the profiling module
# ---------------------------------------------------------------------------

AA_GRID_CHANNELS = (None, "cir1", "cir2")
#: JAX's tolerance for its own batched / fused pair
#: (tests/test_pipeline_parity.py:196-212)
AA_GRID_CFO_TOL_HZ = 1e-3
#: `aa.main`'s serial grid: 5 SNR x 3 channels x 5 full scales x 3 lengths
AA_GRID_CONFIGS = 225


def aa_grid_knife(channel, cfg: int, what: str) -> None:
    """Log a differing grid config's |M - threshold| at every sample whose
    gate bit differs between the plain metric (`ops.metrics.aa_metric`) and
    kernel C, as a knife edge."""
    x, _, L = aa._grid_clean_stream(1024, channel, 42, card_device())
    iq = aa._grid_batch(x, (-5.0, 0.0, 5.0, 10.0, 15.0), (0.25, 0.5, 1.0, 1.5, 2.0), 500.0, 42)
    rows = iq[:, cfg: cfg + 1].contiguous()
    o = AF.aa_metric(rows, half_len=L, threshold=AA_THR)
    st = aa.aa_metric(torch.complex(rows[0::2, 0], rows[1::2, 0]), L)
    plain = st.valid & (st.M >= AA_THR)
    diff = (plain != o.above[0]).nonzero().flatten()
    margins = (st.M[diff] - AA_THR).abs().tolist()
    log(f"  {what}: config {cfg} differs; gate bits differ at {diff[:8].tolist()}, "
        f"|M - threshold| there {margins[:8]}")


def aa_grid_sweeps(dev, card: str) -> dict:
    """(a) `run_grid_test_batched` (plain PyTorch) and `run_grid_test_fused`
    (kernels C + B) on the card, for every channel of the grid: the same
    quantized batch, so every config's outcome must be equal and its CFO
    within 1e-3 Hz.  Times both sweeps, and their detection alone."""
    reset_launch_counts()
    runs = {ch: (aa.run_grid_test_batched(channel_name=ch, device=dev),
                 run_grid_test_fused(channel_name=ch, device=dev)) for ch in AA_GRID_CHANNELS}
    torch.cuda.synchronize()
    counts = launch_counts()
    if min(counts["aa_metric"], counts["gate_events"]) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")
    res = {"counts": counts}
    for ch, (b, f) in runs.items():
        what = f"sweep {ch or 'awgn'}"
        bad = np.zeros(b["detected"].shape, bool)
        for k in ("detected", "frame_start", "num_events", "timing_error"):
            bad |= b[k] != f[k]
        bad |= np.abs(b["cfo_error"] - f["cfo_error"]) > AA_GRID_CFO_TOL_HZ
        if bad.any():
            for cfg in np.flatnonzero(bad.reshape(-1)):
                aa_grid_knife(ch, int(cfg), what)
            raise AssertionError(f"{what}: batched != fused at configs "
                                 f"{np.flatnonzero(bad.reshape(-1)).tolist()}")
        cfo_diff = float(np.abs(b["cfo_error"] - f["cfo_error"]).max())
        res[what] = dict(detected=int(b["detected"].sum()), max_cfo_diff_hz=cfo_diff)
        log(f"  (a) {what}: batched == fused, {int(b['detected'].sum())}/25 detected, "
            f"timing errors {b['timing_error'][b['detected']].tolist()}, CFO within "
            f"{cfo_diff:.3g} Hz")
    x, _, L = aa._grid_clean_stream(1024, "cir1", 42, dev)
    iq = aa._grid_batch(x, (-5.0, 0.0, 5.0, 10.0, 15.0), (0.25, 0.5, 1.0, 1.5, 2.0), 500.0, 42)
    res.update(
        batched_sweep_ms=cuda_ms(lambda: aa.run_grid_test_batched(channel_name="cir1",
                                                                  device=dev)),
        fused_sweep_ms=cuda_ms(lambda: run_grid_test_fused(channel_name="cir1", device=dev)),
        batched_detect_ms=cuda_ms(lambda: aa._batched_detect(iq, L)),
        fused_detect_ms=cuda_ms(lambda: aa._fused_detect(iq, L)))
    log(f"  (a) cir1 sweep: batched {res['batched_sweep_ms']:.3f} ms, fused "
        f"{res['fused_sweep_ms']:.3f} ms; detection alone on the 4 x 25 x {iq.shape[-1]} "
        f"batch: batched {res['batched_detect_ms']:.3f} ms, fused "
        f"{res['fused_detect_ms']:.3f} ms; card {card}")
    return res


def aa_oracle_cases() -> list[tuple]:
    """(label, planar int16 codes (branches, 2, n), L): the golden int12
    stimulus with and without its 500 Hz CFO, and `rtl_stimulus` at L = 64
    and 512."""
    cases = [("golden", aa_int12_stimulus(0.0), 512),
             ("golden 500 Hz", aa_int12_stimulus(500.0), 512)]
    cases += [(f"rtl L={L}", rtl_stimulus(np.random.default_rng(0), L,
                                          L=max(4000, 900 + 12 * L)), L) for L in (64, 512)]
    return cases


def aa_oracle(dev) -> dict:
    """(b) kernels C + B (`aa_detect_fused` on the card, float32 and int16
    codes) against the C++ [A][A] model: event counts and peak indices
    equal, P at each peak the C++ integer P rounded once to float32."""
    reset_launch_counts()
    res = {}
    for label, iq, L in aa_oracle_cases():
        det = aa_detect_native(iq, half_len=L, max_events=8)
        if det.overflow or not det.count:
            raise AssertionError(f"{label}: the C++ model found {det.total} events")
        want_P = np.stack([det.p_at_peak.real, det.p_at_peak.imag]).astype(np.float32)
        for dt in (torch.float32, torch.int16):
            table, P, _ = AF.aa_detect_fused(rtl_channel_leading(iq, dev, dt), half_len=L,
                                             threshold=AA_THR, hysteresis=AA_HYST)
            valid = table.valid[0].cpu().numpy()
            peaks = table.peak_idx[0].cpu().numpy()[valid].tolist()
            what = f"{label} {str(dt)[6:]}"
            if int(table.count[0]) != det.count or peaks != [int(p) for p in det.peak_idx]:
                raise AssertionError(f"{what}: C + B peaks {peaks} != the C++ model's "
                                     f"{det.peak_idx.tolist()}")
            got_P = P[0].cpu().numpy()[:, valid]
            if not np.array_equal(got_P, want_P):
                raise AssertionError(f"{what}: P at the peaks {got_P.tolist()} != the C++ "
                                     f"P rounded to float32 {want_P.tolist()}")
        res[label] = dict(events=det.count, peaks=[int(p) for p in det.peak_idx])
    torch.cuda.synchronize()
    res["counts"] = launch_counts()
    if min(res["counts"]["aa_metric"], res["counts"]["gate_events"]) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {res['counts']}")
    log(f"  (b) C + B == the C++ [A][A] model on {len(res) - 1} stimuli x (f32, int16): "
        + "; ".join(f"{k} peaks {v['peaks']}" for k, v in res.items() if k != "counts"))
    return res


def aa_simulation(dev, card: str) -> dict:
    """(c) `aa.main(plots=False)` (the PAPR report, the serial grid of
    AA_GRID_CONFIGS configs, the summary) on the card and on the CPU: every config's
    detection, timing error and event count equal, and the printed report
    equal with its decimal numbers left out."""
    def run(device):
        results = []
        grid = aa.run_grid_test

        def keep(*args, **kw):
            results.extend(grid(*args, **kw))
            return results

        t0 = time.perf_counter()
        with mock.patch.object(aa, "run_grid_test", keep):
            _, out = run_printed(aa.main, device=device, plots=False)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ints = [(r.detected, r.timing_error, r.num_events) for r in results]
        return ints, re.sub(r"-?\d+\.\d+", "#", out).splitlines(), wall

    card_ints, card_lines, card_s = run(dev)
    cpu_ints, cpu_lines, cpu_s = run("cpu")
    if len(card_ints) != AA_GRID_CONFIGS or card_ints != cpu_ints:
        bad = [i for i, (a, b) in enumerate(zip(card_ints, cpu_ints)) if a != b]
        raise AssertionError(f"aa simulation: card != cpu at configs {bad[:10]}")
    if card_lines != cpu_lines:
        bad = [(a, b) for a, b in zip(card_lines, cpu_lines) if a != b]
        raise AssertionError(f"aa simulation: printed integers differ: {bad[:5]}")
    detected = sum(d for d, _, _ in card_ints)
    log(f"  (c) aa simulation, {AA_GRID_CONFIGS} configs: card == cpu ({detected} detected); wall card "
        f"{card_s:.3f} s, cpu {cpu_s:.3f} s; card {card}")
    return dict(detected=detected, card_s=card_s, cpu_s=cpu_s)


def aa_profiling(dev, card: str) -> dict:
    """(d) `utils.profiling.kernel_stats` on the [A][A] headline's C + B,
    beside `cuda_ms` of the same call."""
    B, n, lag = AA_HEADLINE["batch"], AA_HEADLINE["n"], AA_HEADLINE["lag"]
    x = aa_stimulus(B, n, lag, dev, events=[(0, 3 * lag), (1, n // 3)])
    fn = lambda v: AF.aa_detect_fused(v, half_len=lag)  # noqa: E731
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats = profiling.kernel_stats(fn, x, samples_per_call=B * n, iters=10,
                                       label="aa_detect_fused C + B")
    line = buf.getvalue().strip()
    ms = cuda_ms(lambda: fn(x))
    del x
    torch.cuda.empty_cache()
    log(f"  (d) {line}; cuda_ms of the same call {ms:.3f} ms; card {card}")
    return dict(kernel_stats_ms=stats["wall_s"] * 1e3 / stats["iters"],
                samples_per_sec=stats["samples_per_sec"], cuda_ms=ms)


def phase_aa_grid(dev, card: str) -> dict:
    log("== phase 8b: batched vs fused grid sweep, C + B vs the C++ [A][A] model, the aa "
        "simulation, profiling")
    t0 = time.perf_counter()
    res = {"sweeps": aa_grid_sweeps(dev, card), "oracle": aa_oracle(dev),
           "simulation": aa_simulation(dev, card), "profiling": aa_profiling(dev, card)}
    res["counts"] = {k: res["sweeps"]["counts"][k] + res["oracle"]["counts"][k]
                     for k in res["sweeps"]["counts"]}
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 8b: {res['seconds']:.1f} s; launches {res['counts']}")
    return res


def phase_aa_headline(dev, card: str) -> dict:
    B, n, lag = AA_HEADLINE["batch"], AA_HEADLINE["n"], AA_HEADLINE["lag"]
    log(f"== phase 9: [A][A] detector at {B} x {n} x 2 branches, L={lag}, f32 and int16")
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
    tc = aa_timings(x, lag, card)
    o = AF.aa_metric(x, half_len=lag, threshold=AA_THR)
    b_work_capture = b_work(o.above, gated_samples(o.above, AA_HYST), n_extra=3)
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
    res = dict(fused_ms=t_fused, b_ms=t_b, plain_c_ms=t_pc, plain_b_ms=t_pb,
               plain_ms=t_pc + t_pb, b_capture_work=b_work_capture, **tc)
    log(f"  kernels C+B {t_fused:.3f} ms = {N / t_fused * 1e3:.4g} samples/s (C "
        f"{tc['c_ms']:.3f} ms, B with capture {t_b:.3f} ms); plain "
        f"{t_pc + t_pb:.3f} ms = {N / (t_pc + t_pb) * 1e3:.4g} samples/s (metric {t_pc:.3f}, "
        f"events {t_pb:.3f}); card {card}")
    res["lean"] = aa_lean_headline(x, lag, events, card)
    return res


def aa_lean_headline(x, lag: int, events, card: str) -> dict:
    """Phase 9 on int16 codes, the route `aa_detect_fused` takes for them:
    the whole call (kernel C on the gate input alone, on its exact path; B
    plain; the peak capture) against its plain version, C's track and above
    on its exact path (no tile off the exact route on these 12-bit codes)
    and on its float path against the plain metric's, and the peak capture
    alone against `aa_peak_capture_plain` on the same codes and table; their
    times."""
    x16 = x.to(torch.int16)
    reset_launch_counts()
    table = check_aa_detect(x16, lag, "aa headline int16")
    counts, modes = launch_counts(), mode_launch_counts()
    if (modes.get("aa_metric/gate_input") != 1 or counts["aa_peak_capture"] != 1
            or "gate_events/capture" in modes):
        raise AssertionError(f"aa headline int16: not the lean route: {counts} {modes}")
    if modes.get("aa_metric/exact_i16") != 1:
        raise AssertionError(f"aa headline int16: C not on its exact path: {modes}")
    check_aa_found(table, events, lag, "aa headline int16")
    fails = torch.zeros(1, dtype=torch.int32, device=x16.device)
    gate_input = lambda: AF._aa_metric(x16, half_len=lag, threshold=AA_THR,  # noqa: E731
                                       base_index=0, hist_init=None, gate_input=True,
                                       failed_tiles=fails)
    # the float path on the same codes: a zero history keeps C off the exact path
    zero_hist = torch.zeros((x16.shape[0], x16.shape[1], 1), device=x16.device)
    gate_input_float = lambda: AF._aa_metric(  # noqa: E731
        x16, half_len=lag, threshold=AA_THR, base_index=0, hist_init=zero_hist,
        gate_input=True)
    o = gate_input()
    failed_tiles = int(fails)
    if failed_tiles:
        raise AssertionError(f"aa headline int16: {failed_tiles} tiles off the exact route "
                             f"on 12-bit codes")
    st, track, M, above = aa_plain(x16, lag)
    c_err = check_equal(o.track, track, "aa headline int16 C track")
    check_equal(o.above, above, "aa headline int16 C above")
    del o
    before = mode_launch_counts()
    o = gate_input_float()
    after = mode_launch_counts()
    float_launches = (after.get("aa_metric/gate_input", 0)
                      - before.get("aa_metric/gate_input", 0))
    if float_launches != 1 or (after.get("aa_metric/exact_i16", 0)
                               != before.get("aa_metric/exact_i16", 0)):
        raise AssertionError(f"aa headline int16: C's float path not taken once: {after}")
    c_float_err = check_equal(o.track, track, "aa headline int16 C float path track")
    check_equal(o.above, above, "aa headline int16 C float path above")
    del o, st, track, M, above
    torch.cuda.empty_cache()
    pidx = table.peak_idx
    capture = lambda: AF.aa_peak_capture(x16, pidx, half_len=lag)  # noqa: E731
    plain_capture = lambda: aa_peak_capture_plain(F._planar_view(x16), pidx, lag)  # noqa: E731
    cap_err = check_equal(capture(), plain_capture(), "aa headline peak capture")
    res = dict(float_launches=float_launches,
               exact_launches=modes["aa_metric/exact_i16"], failed_tiles=failed_tiles,
               capture_launches=counts["aa_peak_capture"], c_err=c_err, cap_err=cap_err,
               c_float_err=c_float_err,
               fused_ms=cuda_ms(lambda: AF.aa_detect_fused(x16, half_len=lag)),
               c_ms=cuda_ms(gate_input), c_kernel_ms=kernel_ms(gate_input),
               c_float_ms=cuda_ms(gate_input_float),
               c_float_kernel_ms=kernel_ms(gate_input_float),
               plain_c_ms=cuda_ms(lambda: aa_plain(x16, lag)),
               cap_ms=cuda_ms(capture), cap_kernel_ms=kernel_ms(capture),
               plain_cap_ms=cuda_ms(plain_capture), valid_slots=int(table.valid.sum()),
               cap_work=cap_work(table.valid.numel(), int(table.valid.sum()), lag,
                                 x16.shape[0]))
    del x16
    torch.cuda.empty_cache()
    log(f"  int16 codes, the lean route: C+B+capture {res['fused_ms']:.3f} ms; C on the gate "
        f"input, exact path {res['c_ms']:.3f} ms (profiler {res['c_kernel_ms']}, "
        f"{failed_tiles} tiles off the exact route), float path {res['c_float_ms']:.3f} ms "
        f"(profiler {res['c_float_kernel_ms']}), plain metric "
        f"{res['plain_c_ms']:.3f}; the peak capture {res['cap_ms']:.4f} ms (profiler "
        f"{res['cap_kernel_ms']}) over {res['valid_slots']} valid slots, plain "
        f"{res['plain_cap_ms']:.3f}; equal to the plain versions; card {card}")
    return res


def aa_timings(x, lag: int, card: str) -> dict:
    """Kernel C at the [A][A] headline: detect mode on float32 and on int16
    codes (its exact path), metric mode on float32; CUDA events (one call)
    and the profiler's device time (the kernel alone)."""
    x16 = x.to(torch.int16)
    runs = (("c", lambda: AF.aa_metric(x, half_len=lag, threshold=AA_THR)),
            ("c_i16", lambda: AF.aa_metric(x16, half_len=lag, threshold=AA_THR)),
            ("metric_mode", lambda: AF.aa_metric_planar(x, half_len=lag)))
    res = {}
    for name, fn in runs:
        res[f"{name}_ms"], res[f"{name}_kernel_ms"] = cuda_ms(fn), kernel_ms(fn)
    del x16
    torch.cuda.empty_cache()
    log(f"  kernel C: detect f32 {res['c_ms']:.3f} ms (profiler {res['c_kernel_ms']}), int16 "
        f"(exact path) "
        f"{res['c_i16_ms']:.3f} ({res['c_i16_kernel_ms']}), metric mode "
        f"{res['metric_mode_ms']:.3f} ({res['metric_mode_kernel_ms']}); card {card}")
    return res


def timing_aa(dev, card: str) -> dict:
    """The timed part of phase 9 alone (``--timing``)."""
    B, n, lag = AA_HEADLINE["batch"], AA_HEADLINE["n"], AA_HEADLINE["lag"]
    log(f"== [A][A] headline timing, {B} x {n} x 2 branches, L={lag}")
    x = aa_stimulus(B, n, lag, dev, events=[(0, 3 * lag), (1, n // 3)])
    res = aa_timings(x, lag, card)
    del x
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Zadoff-Chu: kernel D (both modes), kernel E, and kernel B at h = 256
# ---------------------------------------------------------------------------

#: the ZC streaming CFAR defaults (params.ZCStreamingParams)
ZC_CFAR = dict(corr_window=2048, threshold_value=64, threshold_frac_bits=15, min_corr_mag=0.3)
ZC_EVENTS = dict(hysteresis=256, max_events=16, valid_from=2048, tie="first", emit_unclosed=True)
#: an above bit of kernel D may differ from the plain version only where
#: |mag*2^frac - local*T| is within this fraction of local*T: both take the
#: W-window local sums of the (non-integer) magnitude from float64 prefixes,
#: but from prefixes that start at other samples
ZC_KNIFE_RTOL = 1e-6
#: kernel E against a complex128 FFT convolution, relative to the output peak
MF_RTOL = 1e-5
#: the matched filter's last outputs where a noise-only stream may hold an
#: event: their normalizing IQ window holds at most this many samples
ZC_TAIL = 16
#: bench.py's ZC workloads (bench.py:478-613): the CFAR and from-IQ
#: detectors at 512 x 262144 (x 2 branches), the matched filter and the
#: from-IQ composition at 64 x 262144 x 2, all with the 2048-tap template
ZC_HEADLINE = dict(batch=512, n=1 << 18, mf_batch=64)


def pss_template(n_fft: int):
    """The PSS symbol of an n_fft-point system as complex64, its planar
    conjugate-reversed taps (2, n_fft) and its norm, as
    `ZCStreamingDetector.detect_fused_iq` builds them."""
    sys_p = SYS_30M72 if n_fft == 2048 else SystemParams(n_fft=n_fft, num_active=144, cp_len=64)
    ref = np.asarray(build_pss_symbol(sys_p), np.complex64)
    taps = np.stack([ref.real[::-1], -ref.imag[::-1]]).astype(np.float32)
    return ref, taps, float(np.sqrt(np.sum(np.abs(ref) ** 2)))


def check_mf(x, taps, what: str, rtol: float = MF_RTOL, **kw) -> float:
    """Kernel E vs complex128 within rtol of the output peak; returns
    max |err|."""
    y = MF.matched_filter_ols(x, taps, **kw)
    ref = mf_reference(x, taps)
    torch.cuda.synchronize()
    if y.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(y.shape)} != {tuple(ref.shape)}")
    err, peak = float((y.double() - ref).abs().max()), float(ref.abs().max())
    if err > rtol * peak:
        raise AssertionError(f"{what}: kernel E err {err} > {rtol} * peak {peak}")
    log(f"  kernel {what}: max |err| {err:.3g} = {err / peak:.3g} of the peak")
    return err


def zc_knife_bits(above, ref_above, mag, what: str) -> int:
    """Above bits where kernel D and the plain version differ; raises if
    one lies off the knife edge.  ``mag``: the plain magnitudes of the
    compared samples, optionally with the magnitudes before them (the
    window's history) in front."""
    diff = above != ref_above
    if not bool(diff.any()):
        return 0
    n = above.shape[-1]
    e_s = (running_sum_stream(mag, ZC_CFAR["corr_window"])[..., -n:]
           * float(ZC_CFAR["threshold_value"]))
    margin = (mag[..., -n:] * float(1 << ZC_CFAR["threshold_frac_bits"]) - e_s).abs()
    if (diff & ~(margin <= ZC_KNIFE_RTOL * e_s.abs())).any():
        raise AssertionError(f"{what}: above differs off the knife edge at "
                             f"{diff.nonzero()[:5].tolist()}")
    n = int(diff.sum())
    log(f"  {what}: {n} above bit(s) differ on the knife edge")
    return n


def check_zc_table(table, above, ref_above, ref_mag, what: str) -> None:
    """A D+B table vs the plain table; where knife-edge bits differ, vs
    plain events on kernel D's own gate input instead."""
    knife = zc_knife_bits(above, ref_above, ref_mag, what)
    ref = extract_gate_events(above if knife else ref_above, ref_mag, **ZC_EVENTS)
    assert_tables_equal(ref, table, what)


def check_zc_iq(mf, iq, R, ref_norm, what: str):
    """Kernel D in IQ mode and D + B vs the plain versions: mag bit-equal,
    above off the knife edge equal, tables equal.  Returns (table, max
    |mag err|)."""
    kw = dict(ref_len=R, ref_norm=ref_norm, **ZC_CFAR)
    o = ZF.zc_metric(mf, iq, **kw)
    mag_p, above_p = zc_iq_planar(mf, iq, **kw)
    table = ZF.zc_iq_cfar_detect(mf, iq, **kw, hysteresis=256)
    torch.cuda.synchronize()
    err = check_equal(o.mag, mag_p, f"{what} mag")
    if not bool(torch.isfinite(o.mag).all()):
        raise AssertionError(f"{what}: non-finite magnitude")
    check_zc_table(table, o.above, above_p, mag_p, what)
    return table, err


def check_zc_found(table, events, R, what: str) -> None:
    """Every injected template is found at peak = position + R - 1 (+-2)."""
    for b, pos in events:
        pk = table.peak_idx[b][table.valid[b]].tolist()
        if not any(abs(p - (pos + R - 1)) <= 2 for p in pk):
            raise AssertionError(f"{what}: template at {b}:{pos} not found (peaks {pk})")


def tail_witness(x, taps, table, streams, kw: dict) -> dict:
    """The events of noise-only ``streams`` on the card (kernel E, D, B)
    beside those of the plain D + B on the CPU, fed by the CPU's plain
    matched filter (a complex64 FFT convolution) and by a complex128
    convolution rounded to float32: whether a float32 FFT convolution's
    roundoff makes them.  Peak indices a stream; logged, not checked."""
    xs = x[:, streams].cpu()
    mfs = {"cpu_c64": MF.matched_filter_ols(xs, taps), "c128": mf_reference(xs, taps).float()}
    out = {"card": [table.peak_idx[b][table.valid[b]].tolist() for b in streams]}
    for name, mf in mfs.items():
        mag, above = zc_iq_planar(mf, xs, **kw)
        t = extract_gate_events(above, mag, **ZC_EVENTS)
        out[name] = [t.peak_idx[i][t.valid[i]].tolist() for i in range(len(streams))]
    log(f"  noise-only streams {streams}, event peaks: " + "; ".join(
        f"{k} {v}" for k, v in out.items()))
    return out


def phase_zc_kernels(dev) -> dict:
    log("== phase 10: kernels D and E vs plain PyTorch on the card")
    g = torch.Generator(device=dev).manual_seed(11)
    mf_errs = []
    # kernel E: taps 1 .. 2049, lengths off its 6144-output blocks and across
    # the TPU kernel's 14336-sample block seams, a stream shorter than one
    # block, each CTA walking 1 to 4 blocks
    for T, batch, n, nb in ((1, 3, 5000, 1), (62, 5, 14335, 2), (200, 7, 14336, 1),
                            (2048, 3, 6143, 3), (2048, 3, 14337, 4), (2049, 5, 2 * 14336 + 37, 2),
                            (2049, 2, 100, 1)):
        x = torch.randn((4, batch, n), generator=g, device=dev)
        taps = torch.randn((2, T), generator=g, device=dev)
        mf_errs.append(check_mf(x, taps, f"E T={T} batch={batch} n={n} nb={nb}", nb=nb))
    # every precision and nb gives the same bits; 'highest' within the TPU
    # mode's 2e-6 of the peak (tests/test_pallas_mf.py:74)
    x = torch.randn((4, 3, 20_000), generator=g, device=dev)
    taps = torch.randn((2, 2048), generator=g, device=dev)
    mf_errs.append(check_mf(x, taps, "E highest", rtol=2e-6, precision="highest"))
    y = MF.matched_filter_ols(x, taps)
    for kw in [dict(precision=p) for p in MF.PRECISIONS] + [dict(nb=nb) for nb in (1, 2, 4)]:
        check_equal(MF.matched_filter_ols(x, taps, **kw), y, f"E {kw}")
    x = torch.randn((2, 2, 9000), generator=g, device=dev)
    taps = torch.randn((2, 300), generator=g, device=dev)
    y = MF.matched_filter_ols(x, taps, out_len=9500 + 6144)
    check_equal(y[..., :9299], MF.matched_filter_ols(x, taps)[..., :9299], "E out_len")
    check_equal(y[..., :4000], MF.matched_filter_ols(x, taps, out_len=4000), "E short out_len")
    if float(y[..., 9299:].abs().max()) != 0.0:
        raise AssertionError("E out_len: nonzero output past L + T - 1")

    # kernel D, IQ mode (f32 and int16 ADC codes), then D + B
    errs = []
    for R, batch, n, dt in ((256, 3, 14335, torch.float32), (2048, 5, 14337, torch.int16),
                            (256, 7, 2 * 14336 + 37, torch.int16),
                            (2048, 3, 5000, torch.float32), (2048, 7, 40_017, torch.float32)):
        ref, taps, ref_norm = pss_template(R)
        events = [(0, 2300), (min(1, batch - 1), n // 2), (batch - 1, n - R - 40)]
        x = zc_iq_stimulus(batch, n, ref, dev, seed=R + n, events=events)
        mf = MF.matched_filter_ols(x, taps)
        what = f"D R={R} batch={batch} n={n} {str(dt)[6:]}"
        table, err = check_zc_iq(mf, x.to(dt), R, ref_norm, what)
        check_zc_found(table, events, R, what)
        errs.append(err)
        log(f"  {what}: ok (mag bit-equal, {int(table.count.sum())} events)")

    # kernel D, magnitude mode, then D + B
    for batch, n in ((3, 14335), (5, 2 * 14336 + 37), (7, 5000)):
        events = [(0, 2100), (batch - 1, n - 300), (batch // 2, n // 2 + 2048)]
        events = [(b, p) for b, p in events if p < n]
        mag = mag_stimulus(batch, n, dev, seed=n, events=events)
        o = ZF.zc_metric(mag, **ZC_CFAR)
        table = ZF.zc_cfar_detect(mag, **ZC_CFAR)
        what = f"D magnitude batch={batch} n={n}"
        check_zc_table(table, o.above, zc_cfar_planar(mag, **ZC_CFAR), mag, what)
        for b, pos in events:
            if pos not in table.peak_idx[b][table.valid[b]].tolist():
                raise AssertionError(f"{what}: peak at {b}:{pos} not found")
        log(f"  {what}: ok ({int(table.count.sum())} events)")

    # zero signal: finite mag, no event; a stream shorter than W: no event
    ref, taps, ref_norm = pss_template(256)
    for dt in (torch.float32, torch.int16):
        x = torch.zeros((4, 3, 20_000), dtype=dt, device=dev)
        mf = MF.matched_filter_ols(x.float(), taps)
        t, err = check_zc_iq(mf, x, 256, ref_norm, f"zero signal {str(dt)[6:]}")
        errs.append(err)
        if int(t.count.sum()) != 0:
            raise AssertionError("zero signal: events")
    x = zc_iq_stimulus(2, 1000, ref, dev, events=[(0, 300)])
    t, _ = check_zc_iq(MF.matched_filter_ols(x, taps), x, 256, ref_norm, "short stream")
    t2 = ZF.zc_cfar_detect(mag_stimulus(2, 1500, dev, seed=1, events=[(0, 700)]), **ZC_CFAR)
    if int(t.count.sum()) + int(t2.count.sum()) != 0:
        raise AssertionError("short stream: events before the CFAR is valid")
    # kernel B's dense gates at the ZC hysteresis, capacities 16 and 128
    for E, density in ((16, 0.002), (128, 0.01)):
        above = torch.rand((5, 300_000), generator=g, device=dev) < density
        track = torch.randint(0, 50, (5, 300_000), generator=g, device=dev).float()
        for tie in ("first", "last"):
            for emit in (False, True):
                kw = dict(hysteresis=256, max_events=E, valid_from=2048, tie=tie,
                          emit_unclosed=emit)
                check_events(above, track, f"dense h=256 E={E} tie={tie} emit={emit}", **kw)
    log("  edge cases: ok")
    return {"mf_err": max(mf_errs), "mag_err": max(errs)}


ZC_CHAIN_CASES = (("awgn", None, 3384), ("cir1", "cir1", 3549))


def phase_zc_chain(dev) -> dict:
    log("== phase 11: the ZC paths, card vs CPU")
    det = ZCStreamingDetector()
    setups = {}
    for label, channel, _ in ZC_CHAIN_CASES:
        setups[label] = build_setup(build_pss_symbol(SYS_30M72), np.random.default_rng(0),
                                    channel_name=channel, cir_mode="two", snr_db=10.0,
                                    cfo_hz=1000.0, device="cpu")
    reset_launch_counts()
    runs = {label: (det.detect_fused(s.rx.to(dev)), det.detect_fused_iq(s.rx.to(dev)))
            for label, s in setups.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    for label, channel, want_peak in ZC_CHAIN_CASES:
        cpu = det.detect(setups[label].rx)
        v2 = quiet(zc_v2.run_simulation, channel, device=dev)
        t = quiet(zc.run_simulation, channel, device=dev)
        for name, res in zip(("detect_fused", "detect_fused_iq"), runs[label]):
            got = [(e.peak_index, e.detected_start) for e in res.events]
            if got != [(e.peak_index, e.detected_start) for e in cpu.events]:
                raise AssertionError(f"{label} {name}: card events {got} != cpu")
            if ZCStreamingDetector.strongest(res).peak_index != want_peak:
                raise AssertionError(f"{label} {name}: strongest peak is not {want_peak}")
        if (v2["peak_index"], v2["num_events"]) != (want_peak, len(cpu.events)):
            raise AssertionError(f"{label}: zc_v2 run {v2}")
        log(f"  {label}: card == cpu ({len(cpu.events)} events, strongest peak {want_peak}, "
            f"detected start {v2['detected_start']}); zc_v2 CFO {v2['cfo_est_hz']:.2f} Hz, EVM "
            f"{100 * v2['evm_rms']:.2f} %; zc peak {t['peak_index']}, CFO "
            f"{t['cfo_est_hz']:.2f} Hz, EVM {100 * t['evm_rms']:.2f} %")
    if min(counts["zc_metric"], counts["matched_filter_ols"], counts["gate_events"]) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")
    log(f"  launches during the card paths: {counts}")
    return {"counts": counts}


def phase_zc_headline(dev, card: str) -> dict:
    B, n, Bm = ZC_HEADLINE["batch"], ZC_HEADLINE["n"], ZC_HEADLINE["mf_batch"]
    ref, taps, ref_norm = pss_template(2048)
    R = len(ref)
    log(f"== phase 12: ZC headline, {B} x {n} x 2 branches, R = W = {R}")
    events = [(0, 3000), (1, n // 3), (2, n // 2), (3, n - R - 500)]
    x = zc_iq_stimulus(B, n, ref, dev, events=events)
    quiet_streams = torch.ones(B, dtype=torch.bool, device=dev)
    quiet_streams[[b for b, _ in events]] = False
    res = {}

    def check_found(table, what) -> list[int]:
        # a noise-only stream may hold an event only at the matched filter's
        # last ZC_TAIL outputs: there the IQ window that normalizes it holds
        # at most ZC_TAIL samples, and an FFT convolution's roundoff (kernel
        # E's and cuFFT's alike, ~1e-7 of the peak), divided by a vanishing
        # energy, can cross the threshold
        check_zc_found(table, events, R, what)
        quiet = quiet_streams[: table.count.shape[0]]
        body = (table.valid & (table.peak_idx < n + R - 1 - ZC_TAIL)).any(dim=-1)
        extra = (quiet & body).nonzero().flatten().tolist()
        if extra:
            raise AssertionError(f"{what}: events in noise-only streams {extra}")
        tail = (quiet & (table.count > 0)).nonzero().flatten().tolist()
        log(f"  {what}: noise-only streams with an event in the last {ZC_TAIL} outputs: {tail}")
        return tail

    # the from-IQ detector (#8/#9): mf from kernel E, IQ as f32 and int16;
    # kernel E against the plain (cuFFT) matched filter on every stream
    mf = MF.matched_filter_ols(x, taps)
    kw = dict(ref_len=R, ref_norm=ref_norm, **ZC_CFAR)
    mfp = MF.matched_filter_plain(x, MF.planar_taps(taps, dev), n + R - 1)
    res["e_vs_plain_headline"] = float((mf - mfp).abs().max()) / float(mfp.abs().max())
    del mfp
    torch.cuda.empty_cache()
    if res["e_vs_plain_headline"] > MF_RTOL:
        raise AssertionError(f"kernel E vs plain: {res['e_vs_plain_headline']} of the peak")
    log(f"  kernel E vs the plain matched filter on all {B} streams: "
        f"{res['e_vs_plain_headline']:.3g} of the peak")
    x16 = x.to(torch.int16)
    for name, iq in (("f32", x), ("i16", x16)):
        table, _ = check_zc_iq(mf, iq, R, ref_norm, f"zc_iq headline {name}")
        tail = check_found(table, f"zc_iq headline {name}")
        if name == "f32" and tail:
            res["tail_witness"] = tail_witness(x, taps, table, tail, kw)
        res[f"iq_{name}_ms"] = cuda_ms(lambda: ZF.zc_iq_cfar_detect(mf, iq, **kw))
    del x16
    o = ZF.zc_metric(mf, x, **kw)
    res.update(zc_timings(mf, x, o.mag[:, :n].contiguous(), kw, card))
    res.update(zc_shards(mf, x, o, kw, card))
    res["b_ms"] = cuda_ms(lambda: F.gate_events(o.above, o.mag, **ZC_EVENTS))
    res["plain_d_iq_ms"] = cuda_ms(lambda: zc_iq_planar(mf, x, **kw))
    mag_p, above_p = zc_iq_planar(mf, x, **kw)
    res["plain_b_ms"] = cuda_ms(lambda: extract_gate_events(above_p, mag_p, **ZC_EVENTS))
    del mag_p, above_p
    torch.cuda.empty_cache()
    res["plain_iq_ms"] = res["plain_d_iq_ms"] + res["plain_b_ms"]
    log(f"  from-IQ D+B: f32 {res['iq_f32_ms']:.3f} ms = {B * n / res['iq_f32_ms'] * 1e3:.4g} "
        f"samples/s (D {res['d_iq_f32_ms']:.3f} ms, B {res['b_ms']:.3f} ms), int16 "
        f"{res['iq_i16_ms']:.3f} ms (D {res['d_iq_i16_ms']:.3f} ms); plain "
        f"{res['plain_iq_ms']:.3f} ms (D {res['plain_d_iq_ms']:.3f}, B {res['plain_b_ms']:.3f});"
        f" card {card}")

    # the CFAR detector (#7) on the kernel's own magnitudes, first n samples
    mag = o.mag[:, :n].contiguous()
    del o, mf
    torch.cuda.empty_cache()
    table = ZF.zc_cfar_detect(mag, **ZC_CFAR)
    check_zc_table(table, ZF.zc_metric(mag, **ZC_CFAR).above, zc_cfar_planar(mag, **ZC_CFAR), mag,
                   "zc_cfar headline")
    check_found(table, "zc_cfar headline")
    res["cfar_ms"] = cuda_ms(lambda: ZF.zc_cfar_detect(mag, **ZC_CFAR))
    res["plain_cfar_ms"] = cuda_ms(lambda: extract_gate_events(
        zc_cfar_planar(mag, **ZC_CFAR), mag, **ZC_EVENTS))
    del mag
    torch.cuda.empty_cache()
    log(f"  CFAR D+B: {res['cfar_ms']:.3f} ms = {B * n / res['cfar_ms'] * 1e3:.4g} samples/s "
        f"(D {res['d_mag_ms']:.3f} ms); plain {res['plain_cfar_ms']:.3f} ms; card {card}")

    # kernel E and E -> D -> B at bench.py's matched-filter shape
    xm = x[:, :Bm].contiguous()
    del x
    torch.cuda.empty_cache()
    hm = MF.planar_taps(taps, dev)
    y = MF.matched_filter_ols(xm, taps)
    res["e_headline_err"] = check_mf(xm, taps, f"E at {Bm} x {n} x 2") / float(y.abs().max())
    res["plain_e_ms"] = cuda_ms(lambda: MF.matched_filter_plain(xm, hm, n + R - 1))
    res["library_e_ms"], res["library_e_err"] = library_conv_ms(xm, hm, y)
    del y
    if res["library_e_err"] > MF_RTOL:
        raise AssertionError(f"conv1d vs kernel E: {res['library_e_err']} of the peak")
    res["e_work"] = e_work(xm, R, n + R - 1)
    torch.cuda.empty_cache()

    def e2e_plain():
        mfp = MF.matched_filter_plain(xm, hm, n + R - 1)
        mag_p, above_p = zc_iq_planar(mfp, xm, **kw)
        return extract_gate_events(above_p, mag_p, **ZC_EVENTS)

    table = ZF.zc_iq_cfar_detect(MF.matched_filter_ols(xm, taps), xm, **kw)
    assert_tables_equal(e2e_plain(), table, "E->D->B", peak_rtol=1e-4)
    check_found(table, "E->D->B")
    res.update(e_timings(xm, taps, kw, card))
    res["plain_e2e_ms"] = cuda_ms(e2e_plain)
    log(f"  plain: FFT {res['plain_e_ms']:.3f} ms, E->D->B {res['plain_e2e_ms']:.3f} ms; one "
        f"conv1d call (cuDNN, TF32 off) {res['library_e_ms']:.3f} ms; card {card}")
    return res


def e_timings(x, taps, kw: dict, card: str) -> dict:
    """Kernel E and E -> D -> B at bench.py's matched-filter shape, CUDA
    events (one call) and the profiler's device time, both called as
    ``(x, taps)`` so that a parent tree's wrappers run them too."""
    e = lambda: MF.matched_filter_ols(x, taps)  # noqa: E731
    e2e = lambda: ZF.zc_iq_cfar_detect(MF.matched_filter_ols(x, taps), x, **kw)  # noqa: E731
    res = {"e_ms": cuda_ms(e), "e_kernel_ms": kernel_ms(e), "e2e_ms": cuda_ms(e2e),
           "e2e_kernel_ms": kernel_ms(e2e)}
    N = x.shape[1] * x.shape[2]
    log(f"  kernel E {res['e_ms']:.3f} ms = {N / res['e_ms'] * 1e3:.4g} samples/s (profiler "
        f"{res['e_kernel_ms']}); E->D->B {res['e2e_ms']:.3f} ms = {N / res['e2e_ms'] * 1e3:.4g}"
        f" samples/s (profiler {res['e2e_kernel_ms']}) ({x.shape[1]} x {x.shape[2]} x 2 "
        f"branches, T = {taps.shape[-1]}); card {card}")
    return res


def timing_e(dev, card: str) -> dict:
    """The kernel-E part of phase 12 alone (``--timing``)."""
    n, Bm = ZC_HEADLINE["n"], ZC_HEADLINE["mf_batch"]
    ref, taps, ref_norm = pss_template(2048)
    log(f"== matched-filter timing, {Bm} x {n} x 2 branches, T = {len(ref)}")
    x = zc_iq_stimulus(Bm, n, ref, dev, events=[(0, 3000), (1, n // 3)])
    res = e_timings(x, taps, dict(ref_len=len(ref), ref_norm=ref_norm, **ZC_CFAR), card)
    del x
    torch.cuda.empty_cache()
    return res


def zc_timings(mf, x, mag, kw: dict, card: str) -> dict:
    """Kernel D at the ZC headline: IQ mode on float32 and on int16 IQ, and
    magnitude mode on the CFAR cell's magnitudes; CUDA events (one call)
    and the profiler's device time (the kernel alone)."""
    x16 = x.to(torch.int16)
    runs = (("d_iq_f32", lambda: ZF.zc_metric(mf, x, **kw)),
            ("d_iq_i16", lambda: ZF.zc_metric(mf, x16, **kw)),
            ("d_mag", lambda: ZF.zc_metric(mag, **ZC_CFAR)))
    res = {}
    for name, fn in runs:
        res[f"{name}_ms"], res[f"{name}_kernel_ms"] = cuda_ms(fn), kernel_ms(fn)
    del x16
    torch.cuda.empty_cache()
    log(f"  kernel D: IQ f32 {res['d_iq_f32_ms']:.3f} ms (profiler {res['d_iq_f32_kernel_ms']}), "
        f"int16 {res['d_iq_i16_ms']:.3f} ({res['d_iq_i16_kernel_ms']}), magnitude "
        f"{res['d_mag_ms']:.3f} ({res['d_mag_kernel_ms']}); card {card}")
    return res


def timing_zc(dev, card: str) -> dict:
    """The timed kernel-D part of phase 12 alone (``--timing``)."""
    B, n = ZC_HEADLINE["batch"], ZC_HEADLINE["n"]
    ref, taps, ref_norm = pss_template(2048)
    log(f"== ZC headline timing, {B} x {n} x 2 branches, R = W = {len(ref)}")
    x = zc_iq_stimulus(B, n, ref, dev, events=[(0, 3000), (1, n // 3)])
    mf = MF.matched_filter_ols(x, taps)
    kw = dict(ref_len=len(ref), ref_norm=ref_norm, **ZC_CFAR)
    mag = ZF.zc_metric(mf, x, **kw).mag[:, :n].contiguous()
    res = zc_timings(mf, x, mag, kw, card)
    del x, mf, mag
    torch.cuda.empty_cache()
    return res


#: the ZC from-IQ headline cut into this many shards on the one card
ZC_SHARDS = 4


def zc_shards(mf, x, one, kw: dict, card: str) -> dict:
    """The from-IQ headline in ZC_SHARDS shards of the correlation axis on
    the one card, each primed from its left neighbour's mf and IQ halos
    (#9's shard mode; zeros for shard 0): the launch counts of the shard
    mode, then per shard mag bit-equal to the one-shot run ``one`` over the
    same global range, above off the knife edge equal to it, and the gate
    carry and D + B table equal to the plain version over [halo; shard];
    one shard's kernel D timed."""
    C, B, Lc = mf.shape
    n, R, W, h = x.shape[-1], kw["ref_len"], kw["corr_window"], ZC_EVENTS["hysteresis"]
    Wh = ZF.zc_tm_halo_rows(R, W, h)
    block = -(-Lc // ZC_SHARDS)
    log(f"  {ZC_SHARDS} shards of {block} correlation outputs, halo {Wh}")

    def iq_cols(lo, hi):  # the IQ zero-padded to Lc, columns lo .. hi
        out = torch.zeros((C, B, hi - lo), device=x.device)
        if lo < n:
            out[..., : min(hi, n) - lo] = x[..., lo: min(hi, n)]
        return out

    shards, zeros = [], torch.zeros((C, B, Wh), device=mf.device)
    for s in range(ZC_SHARDS):
        lo, hi = s * block, min((s + 1) * block, Lc)
        halo = (mf[..., lo - Wh: lo].contiguous(), iq_cols(lo - Wh, lo)) if s else (zeros, zeros)
        shards.append((lo, hi, mf[..., lo:hi].contiguous(), x[..., lo: min(hi, n)].contiguous(),
                       halo))
    ev = {k: v for k, v in ZC_EVENTS.items() if k != "valid_from"}
    reset_launch_counts()
    tables = [ZF.zc_iq_cfar_detect(mf_s, iq_s, **kw, **ev, base_index=lo, stream_len_global=Lc,
                                   shard_init=halo) for lo, _, mf_s, iq_s, halo in shards]
    torch.cuda.synchronize()
    modes = mode_launch_counts()
    if min(modes.get("zc_metric/primed_iq", 0), modes.get("gate_events/primed", 0)) < ZC_SHARDS:
        raise AssertionError(f"the {ZC_SHARDS} shards launched {modes}")
    res = {"shard_launches": modes["zc_metric/primed_iq"], "shard_knife_bits": 0,
           "shard_events": 0, "shard_mag_err": 0.0}
    for (lo, hi, mf_s, iq_s, halo), table in zip(shards, tables):
        what = f"shard at {lo}"
        o = ZF.zc_metric(mf_s, iq_s, **kw, base_index=lo, hist_init=halo, hysteresis=h)
        mag_p, above_p, gate_p = SP.zc_iq_planar_primed(mf_s, iq_s, *halo, **kw, base_index=lo,
                                                     hysteresis=h)
        torch.cuda.synchronize()
        res["shard_mag_err"] = max(res["shard_mag_err"],
                                   check_equal(o.mag, one.mag[:, lo:hi], f"{what} mag vs one-shot"),
                                   check_equal(o.mag, mag_p, f"{what} mag vs plain"))
        hist_mag = one.mag[:, max(lo - W, 0): hi]
        res["shard_knife_bits"] += zc_knife_bits(o.above, one.above[:, lo:hi], hist_mag,
                                                 f"{what} vs one-shot")
        knife = zc_knife_bits(o.above, above_p, hist_mag, f"{what} vs plain")
        check_equal(o.gate_init, gate_p, f"{what} gate_init")
        rt, _, _ = extract_gate_events_carried(o.above if knife else above_p, mag_p, (), **ev,
                                               valid_from=W, base_index=lo,
                                               stream_len_global=Lc, gate_init=gate_p)
        assert_tables_equal(rt, table, f"{what} D + B")
        res["shard_events"] += int(table.count.sum())
        del o, mag_p, above_p
    lo, hi, mf_s, iq_s, halo = shards[1]
    run = lambda: ZF.zc_metric(mf_s, iq_s, **kw, base_index=lo, hist_init=halo,  # noqa: E731
                               hysteresis=h)
    res["shard_d_ms"], res["shard_d_device_ms"] = cuda_ms(run), device_ms(run)
    res["shard_d_kernel_ms"] = kernel_ms(run)
    res["plain_shard_d_ms"] = cuda_ms(lambda: SP.zc_iq_planar_primed(
        mf_s, iq_s, *halo, **kw, base_index=lo, hysteresis=h))
    res["shard_work"] = d_iq_work(B, hi - lo, iq_s.shape[-1], C, 4, hist_len=Wh)
    del shards, tables
    torch.cuda.empty_cache()
    log(f"  shards: mag == one-shot and == plain, tables == plain over [halo; shard] "
        f"({res['shard_events']} events, {res['shard_knife_bits']} knife-edge bits vs one-shot); "
        f"primed D per shard {res['shard_d_ms']:.3f} ms (back to back "
        f"{res['shard_d_device_ms']:.4f}, profiler {res['shard_d_kernel_ms']}), plain "
        f"{res['plain_shard_d_ms']:.3f}; card {card}")
    return res


# ---------------------------------------------------------------------------
# Streaming: the carried-state modes of kernels A-D (phases 13-15)
# ---------------------------------------------------------------------------

#: kernel A's smoothing register and smooth output vs the plain version,
#: relative to max(1, |plain|max): the chunk-parallel scan (truncated below
#: 2^-45, reassociated) and the plain recurrence round in another order
SMOOTH_RTOL = 1e-5
#: the emitted register vs the one-shot smooth[:, -1] or the plain version,
#: relative to max(1, |ref|) (a register that decayed toward zero differs in
#: its denormals)
CARRY_RTOL = 1e-5
#: the streaming cells: 64 streams x 2^20 samples x 2 branches (1 GiB f32)
STREAM = dict(batch=64, n=1 << 20, chunks=(4096, 65536))
MINN_PARAMS = dict(quarter_len=512, **KW, hysteresis=HYST, max_events=8, tie="last")


def check_knife(above, ref, smooth, energy, what: str) -> int:
    """Above bits that differ from the plain ones must lie on the threshold's
    knife edge (the plain margin within KNIFE_RTOL of energy*T)."""
    diff = above != ref
    if not bool(diff.any()):
        return 0
    e_s = energy * float(KW["threshold_value"])
    margin = (smooth * float(1 << KW["threshold_frac_bits"]) - e_s).abs()
    if (diff & ~(margin <= KNIFE_RTOL * e_s.abs())).any():
        raise AssertionError(f"{what}: above differs off the knife edge at "
                             f"{diff.nonzero()[:5].tolist()}")
    log(f"  {what}: {int(diff.sum())} above bit(s) differ on the knife edge")
    return int(diff.sum())


def gate_carry(batch: int, base: int, g: torch.Generator, dev, h: int):
    """Random gate_init rows: a gate continuing into the chunk ([base - k,
    1], k <= h) or none ([-1, 0])."""
    la = base - torch.randint(1, h + 1, (batch,), generator=g, device=dev)
    flag = torch.randint(0, 2, (batch,), generator=g, device=dev)
    return torch.stack([torch.where(flag > 0, la, -1), flag], dim=1).to(torch.int32)


def phase_stream_kernels(dev, card: str) -> dict:
    B, L, Q = HEADLINE["batch"], HEADLINE["L"], HEADLINE["Q"]
    log(f"== phase 13: kernel A's full-metric and corr/energy modes at {B} x {L} x 2, Q={Q}; "
        "the primed modes of A, B, C, D and kernel F vs plain")
    res, errs = {}, {"full": 0.0, "corr_energy": 0.0, "primed_a": 0.0, "primed_c": 0.0,
                     "primed_d": 0.0, "step": 0.0}
    x32, _ = minn_stimulus(B, L, Q, dev)
    for name in ("f32", "i16"):
        x = x32 if name == "f32" else x32.to(torch.int16)
        st = F.minn_rtl_metric_planar_fused(x, quarter_len=Q, **KW)
        ref = plain_metric(x, Q)
        torch.cuda.synchronize()
        errs["full"] = max(errs["full"], rel_err(st.corr_positive, ref.corr_positive))
        if errs["full"] > CORR_RTOL:
            raise AssertionError(f"full {name}: corr err {errs['full']} > {CORR_RTOL}")
        check_equal(st.energy_total, ref.energy_total, f"full {name} energy")
        if rel_err(st.smooth_metric, ref.smooth_metric) > SMOOTH_RTOL:
            raise AssertionError(f"full {name}: smooth differs by more than {SMOOTH_RTOL}")
        check_knife(st.above_threshold, ref.above_threshold, ref.smooth_metric,
                    ref.energy_total, f"full {name}")
        corr, energy = F.minn_rtl_corr_energy_planar_fused(x, quarter_len=Q)
        errs["corr_energy"] = max(errs["corr_energy"], rel_err(corr, ref.corr_positive))
        if errs["corr_energy"] > CORR_RTOL:
            raise AssertionError(f"corr/energy {name}: corr err {errs['corr_energy']}")
        check_equal(energy, ref.energy_total, f"corr/energy {name} energy")
        del st, ref, corr, energy
        torch.cuda.empty_cache()
        res[f"full_{name}_ms"] = cuda_ms(lambda: F.minn_rtl_metric_planar_fused(
            x, quarter_len=Q, **KW))
        res[f"corr_energy_{name}_ms"] = cuda_ms(lambda: F.minn_rtl_corr_energy_planar_fused(
            x, quarter_len=Q))
        torch.cuda.empty_cache()
    xp = F._planar_view(x32)
    res["plain_full_ms"] = cuda_ms(lambda: minn_rtl_metric_planar(xp, quarter_len=Q, **KW))
    res["plain_corr_energy_ms"] = cuda_ms(lambda: minn_rtl_corr_energy_planar(xp, quarter_len=Q))
    del x32, xp
    torch.cuda.empty_cache()
    log(f"  full metric f32 {res['full_f32_ms']:.3f} ms, int16 {res['full_i16_ms']:.3f} ms "
        f"(plain {res['plain_full_ms']:.3f}); corr/energy f32 {res['corr_energy_f32_ms']:.3f} "
        f"ms, int16 {res['corr_energy_i16_ms']:.3f} ms (plain {res['plain_corr_energy_ms']:.3f});"
        f" card {card}")

    # primed modes at small shapes: random base, history, register, gate carry
    g = torch.Generator(device=dev).manual_seed(13)
    for Qs, batch, n, dt in ((64, 5, 10_000, torch.float32), (512, 3, 3 * 4096 + 5, torch.int16),
                             (512, 4, 2 * 4096, torch.float32)):
        base = int(torch.randint(0, 1 << 30, (1,), generator=g, device=dev))
        x, _ = minn_stimulus(batch, n, Qs, dev, seed=n, events=[(0, 300), (batch - 1, n // 2)])
        x = x.to(dt)
        hist, _ = minn_stimulus(batch, 1536, Qs, dev, seed=n + 1, events=[])
        carry = torch.rand(batch, generator=g, device=dev) * 1e4
        kw = dict(quarter_len=Qs, **KW, base_index=base, hist_init=hist, carry_init=carry)
        corr, above, carry_out = F.minn_rtl_metric(x, **kw, emit_state=True)
        full = F.minn_rtl_metric_planar_fused(x, **kw)
        ref = minn_rtl_metric_planar(F._planar_view(x), quarter_len=Qs, **KW, base_index=base,
                                     hist_init=F._planar_view(hist), carry_init=carry)
        what = f"primed A Q={Qs} batch={batch} n={n} {str(dt)[6:]} base={base}"
        torch.cuda.synchronize()
        errs["primed_a"] = max(errs["primed_a"], rel_err(corr, ref.corr_positive))
        if (errs["primed_a"] > CORR_RTOL
                or rel_err(full.smooth_metric, ref.smooth_metric) > SMOOTH_RTOL):
            raise AssertionError(f"{what}: corr or smooth differs")
        check_equal(full.energy_total, ref.energy_total, f"{what} energy")
        check_knife(above, ref.above_threshold, ref.smooth_metric, ref.energy_total, what)
        if not torch.allclose(carry_out, ref.smooth_metric[:, -1], rtol=CARRY_RTOL,
                              atol=CARRY_RTOL):
            raise AssertionError(f"{what}: carry_out {carry_out.tolist()} != "
                                 f"{ref.smooth_metric[:, -1].tolist()}")
        c, e = F.minn_rtl_corr_energy_planar_fused(x, quarter_len=Qs, hist_init=hist)
        check_equal(e, ref.energy_total, f"{what} corr/energy energy")
        if rel_err(c, ref.corr_positive) > CORR_RTOL:
            raise AssertionError(f"{what}: corr/energy corr differs")
        # kernel B carried, with and without capture, on the plain gate input
        h = HYST if Qs == 64 else 40
        gi = gate_carry(batch, base, g, dev, h)
        for tie, emit, Lg in (("last", True, base + n - 100), ("first", False, base + n + 500)):
            bkw = dict(hysteresis=h, max_events=8, valid_from=3 * Qs - 1, tie=tie,
                       emit_unclosed=emit, base_index=base, stream_len_global=Lg, gate_init=gi)
            above_p, track = ref.above_threshold.contiguous(), ref.corr_positive.contiguous()
            table, gate_out = F.gate_events(above_p, track, **bkw, emit_state=True)
            rt, _, rg = extract_gate_events_carried(above_p, track, (), **bkw)
            assert_tables_equal(rt, table, f"{what} B carried tie={tie}")
            check_equal(gate_out, rg, f"{what} B gate_out")
            extras = (track, ref.smooth_metric.contiguous(), ref.energy_total.contiguous())
            table, cap, gate_out = F.gate_events_capture(above_p, track, extras, **bkw,
                                                         emit_state=True)
            rt, rcap, rg = extract_gate_events_carried(above_p, track, extras, **bkw)
            assert_tables_equal(rt, table, f"{what} B carried capture tie={tie}")
            check_equal(cap, rcap, f"{what} B captured")
            check_equal(gate_out, rg, f"{what} B capture gate_out")
        log(f"  {what}: ok")

    # kernel F, the stream step, from random states: a global base, a
    # history, a register and gate carries that continue into the chunk
    # or not (gaps 1 .. 2h + 1), f32 chunks read as a strided view
    for Qs, batch, n, dt, tie in ((64, 5, 10_000, torch.float32, "first"),
                                  (512, 3, 3 * 4096 + 5, torch.int16, "last"),
                                  (512, 4, 2 * 4096, torch.float32, "last")):
        base = int(torch.randint(0, 1 << 30, (1,), generator=g, device=dev))
        xx, _ = minn_stimulus(batch, n + 64, Qs, dev, seed=n + 7,
                              events=[(0, 364), (batch - 1, n // 2)])
        x = xx[..., 64:].to(dt)
        H = ST._hist_width(3 * Qs)
        hist, _ = minn_stimulus(batch, H, Qs, dev, seed=n + 8, events=[])
        carry = torch.rand(batch, generator=g, device=dev) * 1e4
        h = HYST if Qs == 64 else 40
        la = base - torch.randint(1, 2 * h + 2, (batch,), generator=g, device=dev)
        gate = torch.stack([la, torch.randint(0, 4, (batch,), generator=g, device=dev)],
                           dim=1).to(torch.int32)
        gate[0, 0] = -1
        mp = ST.MinnRTLStreamParams(Qs, **KW, hysteresis=h, max_events=8, tie=tie)
        kw = ST.minn_step_kwargs(mp, base)
        out = F.minn_rtl_step(x, hist, carry, gate, **kw)
        what = f"F Q={Qs} batch={batch} n={n} {str(dt)[6:]} tie={tie} base={base}"
        excused, err = check_step(out, plain_step(x, hist, carry, gate, kw),
                                  step_knife(x, hist, carry, base, Qs), what)
        errs["step"] = max(errs["step"], err)
        log(f"  {what}: ok ({int(out[0].count.sum())} events, register rel err {err:.2e}"
            f"{f', {excused} knife-edge streams' if excused else ''})")

    # kernel C primed (bit-equal on integer stimulus) and D primed magnitude
    for lag, batch, n, dt in ((128, 5, 10_000, torch.float32),
                              (512, 3, 3 * 4096 + 5, torch.int16)):
        base = int(torch.randint(0, 1 << 30, (1,), generator=g, device=dev))
        x = aa_stimulus(batch, n, lag, dev, seed=lag + n, events=[(0, 100), (batch - 1, n // 2)])
        hist = aa_stimulus(batch, 2 * lag + 128, lag, dev, seed=n, events=[(0, 200)])
        o = AF.aa_metric(x.to(dt), half_len=lag, threshold=AA_THR, base_index=base,
                         hist_init=hist)
        m = AF.aa_metric(x.to(dt), half_len=lag, base_index=base, hist_init=hist)
        st = aa_metric_planar(F._planar_view(x), lag, base_index=base, hist=F._planar_view(hist))
        track, M, above = aa_detect_step(st.P_re, st.P_im, st.R, lag, AA_THR, base)
        what = f"primed C L={lag} batch={batch} n={n} {str(dt)[6:]} base={base}"
        for name, out, ref in (("P_re", o.P_re, st.P_re), ("P_im", o.P_im, st.P_im),
                               ("track", o.track, track), ("M", o.M, M), ("above", o.above, above),
                               ("metric R", m.R, st.R)):
            errs["primed_c"] = max(errs["primed_c"], check_equal(out, ref, f"{what} {name}"))
        gi = gate_carry(batch, base, g, dev, AA_HYST)
        kw = dict(half_len=lag, threshold=AA_THR, hysteresis=AA_HYST, emit_unclosed=True,
                  base_index=base, stream_len_global=base + n)
        table, P, Mpk, gate_out = AF.aa_detect_fused(x.to(dt), **kw, emit_state=True,
                                                     shard_init=(hist, gi))
        rt, rcap, rg = extract_gate_events_carried(
            above, track, (st.P_re, st.P_im, M), hysteresis=AA_HYST, max_events=8, tie="first",
            emit_unclosed=True, base_index=base, stream_len_global=base + n, gate_init=gi)
        assert_tables_equal(rt, table, f"{what} C + B")
        check_equal(P, rcap[:, :2], f"{what} P_at_peak")
        check_equal(Mpk, rcap[:, 2], f"{what} M_at_peak")
        check_equal(gate_out, rg, f"{what} gate_out")
        log(f"  {what}: ok (bit-equal)")
    for batch, n in ((3, 14_335), (5, 2 * 16_384 + 37)):
        base = int(torch.randint(0, 1 << 30, (1,), generator=g, device=dev))
        mag = dyadic(mag_stimulus(batch, n, dev, seed=n, events=[(0, 700), (batch - 1, n - 300)]))
        hist = dyadic(mag_stimulus(batch, 2048, dev, seed=n + 1, events=[(0, 2040)]))
        o = ZF.zc_metric(mag, **ZC_CFAR, base_index=base, hist_init=hist)
        ref = zc_cfar_planar(mag, **ZC_CFAR, base_index=base, hist=hist)
        what = f"primed D batch={batch} n={n} base={base}"
        check_equal(o.above, ref, f"{what} above")
        gi = gate_carry(batch, base, g, dev, 256)
        table, gate_out = ZF.zc_cfar_detect(mag, **ZC_CFAR, base_index=base,
                                            stream_len_global=base + n - 7,
                                            shard_init=(hist, gi), emit_state=True)
        rt, _, rg = extract_gate_events_carried(ref, mag, (), **ZC_EVENTS, base_index=base,
                                                stream_len_global=base + n - 7, gate_init=gi)
        assert_tables_equal(rt, table, f"{what} D + B")
        check_equal(gate_out, rg, f"{what} gate_out")
        log(f"  {what}: ok ({int(table.count.sum())} events)")
    return {"res": res, "errs": errs}


def dyadic(x, scale: float = 1024.0):
    """x rounded to multiples of 1/scale: every window sum of it is exact."""
    return (x * scale).round_().div_(scale)


def cpu_table(t):
    """A table with its fields on the host (one copy per field)."""
    return type(t)(*(f.cpu() for f in t))


def run_stream(step, state, x, chunk: int, **kw):
    """Drive a fused step over x in chunks; returns (state, host tables,
    per-chunk extras on the host)."""
    tables, extras = [], []
    for o in range(0, x.shape[-1], chunk):
        state, out = step(state, x[..., o: o + chunk].contiguous(), **kw)
        if not isinstance(out, GateEvents):
            out, P, M = out
            extras.append((P.cpu(), M.cpu()))
        tables.append(cpu_table(out))
    return state, tables, extras


def stitched(tables, extras, b: int, n: int, h: int, tie_last: bool) -> list[tuple]:
    """Stream b's chunk tables stitched into one event list of (start,
    close, peak index, peak value, closed, captured P_re, P_im, M) tuples."""
    ex = [{"p_re": P[b, 0], "p_im": P[b, 1], "m": M[b]} for P, M in extras] if extras else None
    got = ST.stitch_chunk_tables([t.select(b) for t in tables], hysteresis=h, stream_end=n,
                                 emit_unclosed=True, tie_last=tie_last, extras_list=ex)
    return [(e["start"], e["close"], e["pidx"], e["pval"], e["closed"],
             None if ex is None else tuple(float(e["extras"][k]) for k in ("p_re", "p_im", "m")))
            for e in got]


def table_events(ref, b: int, ref_cap=None) -> list[tuple]:
    """Stream b of a one-shot host table (and its captures) as `stitched`'s
    tuples."""
    return [(int(ref.gate_start[b, e]), int(ref.gate_close[b, e]), int(ref.peak_idx[b, e]),
             float(ref.peak_value[b, e]), bool(ref.closed[b, e]),
             None if ref_cap is None else tuple(float(ref_cap[b, i, e]) for i in range(3)))
            for e in range(int(ref.count[b]))]


def compare_events(have: list, want: list, h: int, what: str, knife=None) -> list[int]:
    """Per stream, the event lists must be equal.  An event that differs
    passes only where its gate span (start - h .. close) holds a sample of
    its stream on the threshold's knife edge (`knife`: stream -> sorted
    sample indices); returns the streams so excused."""
    excused = []
    none = np.empty(0, np.int64)
    for b, (hv, wt) in enumerate(zip(have, want)):
        if hv == wt:
            continue
        edges = none if knife is None else knife.get(b, none)
        for ev in sorted(set(hv) ^ set(wt)) or [None]:
            i = 0 if ev is None else int(np.searchsorted(edges, ev[0] - h))
            if ev is None or i >= len(edges) or edges[i] > ev[1]:
                raise AssertionError(f"{what}: stream {b} {hv[:4]} != {wt[:4]}: event {ev} "
                                     "has no knife-edge sample in its gate span")
        excused.append(b)
    if excused:
        log(f"  {what}: streams {excused} differ only in gates that hold a knife-edge sample")
    return excused


def minn_knife(st, valid_from: int) -> dict:
    """Stream -> sorted indices (from valid_from on) of a full metric's
    samples on the threshold's knife edge (the margin within KNIFE_RTOL of
    energy*T)."""
    e_s = st.energy_total * float(KW["threshold_value"])
    margin = (st.smooth_metric * float(1 << KW["threshold_frac_bits"]) - e_s).abs()
    edge = (margin <= KNIFE_RTOL * e_s.abs()) & (st.energy_total > 0)
    edge[:, :valid_from] = False
    b, idx = (t.cpu().numpy() for t in edge.nonzero(as_tuple=True))
    return {int(s): idx[b == s] for s in np.unique(b)}


@contextlib.contextmanager
def plain_kernels():
    """Inside, the kernel wrappers run their plain versions on the card's
    tensors as they do on the CPU's, so a stream step runs unchanged with no
    kernel; a launch counted inside fails the run."""
    before = launch_counts()
    with contextlib.ExitStack() as stack:
        for mod in (F, AF, ZF):
            stack.enter_context(mock.patch.object(mod, "check_kernel_device", lambda *t: "cpu"))
        yield
    torch.cuda.synchronize()
    if launch_counts() != before:
        raise AssertionError(f"a kernel ran in a plain run: {before} -> {launch_counts()}")


def check_stream(name, step, init, x, ref, h: int, kw: dict, *, tie_last=True, ref_cap=None,
                 knife=None):
    """Drive a fused step over x in each chunk size of STREAM: per stream,
    the stitched tables equal the one-shot `ref` (and its captures).  At the
    largest chunk the same step with the plain versions of its kernels, on
    the card, gives the same stitched tables, the same gate carry and (Minn)
    the smoothing register within CARRY_RTOL.  Returns (the kernel runs'
    final states by chunk size, a summary)."""
    n, B = x.shape[-1], ref.count.shape[0]
    ref, ref_cap = cpu_table(ref), None if ref_cap is None else ref_cap.cpu()
    want = [table_events(ref, b, ref_cap) for b in range(B)]
    states, out = {}, {}
    for chunk in STREAM["chunks"]:
        state, tables, extras = run_stream(step, init(), x, chunk, **kw)
        have = [stitched(tables, extras, b, n, h, tie_last) for b in range(B)]
        excused = compare_events(have, want, h, f"{name} chunks of {chunk} vs one-shot", knife)
        out[f"{name}_knife_streams_{chunk}"] = len(excused)
        states[chunk] = state
        log(f"  {name}, chunks of {chunk}: stitched == one-shot for {B - len(excused)} of {B} "
            f"streams ({sum(map(len, want))} events{'' if ref_cap is None else ', P and M'})")
    with plain_kernels():
        plain, ptables, pextras = run_stream(step, init(), x, chunk, **kw)
    hp = [stitched(ptables, pextras, b, n, h, tie_last) for b in range(B)]
    excused = compare_events(have, hp, h, f"{name} chunks of {chunk} vs the plain chain", knife)
    keep = torch.ones(B, dtype=torch.bool)
    keep[excused] = False
    check_equal(state.gate.cpu()[keep], plain.gate.cpu()[keep], f"{name} gate vs the plain chain")
    if hasattr(state, "carry"):
        err = float(((state.carry - plain.carry).abs() / plain.carry.abs().clamp_min(1.0)).max())
        if err > CARRY_RTOL:
            raise AssertionError(f"{name}: carry vs the plain chain, rel err {err}")
        out[f"{name}_carry_rel_err_plain"] = err
    out[f"{name}_knife_streams_plain"] = len(excused)
    log(f"  {name}, chunks of {chunk}: kernels == the plain chain on the card for "
        f"{B - len(excused)} of {B} streams (tables and gate carry)")
    return states, out


def plain_step(x, hist, carry, gate, kw: dict):
    """Kernel F's plain version on the card's tensors: no kernel runs."""
    with plain_kernels():
        return F.minn_rtl_step_plain(x, hist, carry, gate, **kw)


def step_knife(x, hist, carry, base: int, Q: int) -> dict:
    """`minn_knife` of the plain full metric over [hist | x] from the
    register ``carry`` (samples from the metric's first valid one)."""
    st = minn_rtl_metric_planar(F._planar_view(x), quarter_len=Q, **KW, base_index=base,
                                hist_init=F._planar_view(hist), carry_init=carry)
    return minn_knife(st, max(0, 3 * Q - 1 - base))


def check_step(out, ref, knife: dict, what: str) -> tuple[int, float]:
    """Kernel F's (table, carry, gate, history) against the plain step's:
    the history equal; per stream the table and the gate carry equal, or
    the stream holds a knife-edge sample (`knife`); the register within
    CARRY_RTOL of max(1, |plain|).  Returns (streams excused, register rel
    err)."""
    table, carry, gate, hist = cpu_table(out[0]), *(t.cpu() for t in out[1:])
    rt, rc, rg, rh = cpu_table(ref[0]), *(t.cpu() for t in ref[1:])
    check_equal(hist, rh, f"{what} history")
    excused = 0
    for b in range(gate.shape[0]):
        try:
            assert_tables_equal(rt.select(b), table.select(b), f"{what} stream {b}")
            check_equal(gate[b], rg[b], f"{what} stream {b} gate")
        except AssertionError:
            if b not in knife:
                raise
            excused += 1
    err = float(((carry - rc).abs() / rc.abs().clamp_min(1.0)).max())
    if err > CARRY_RTOL:
        raise AssertionError(f"{what}: register rel err {err} > {CARRY_RTOL}")
    return excused, err


def step_timings(x, state, mp, card: str, what: str) -> dict:
    """One Minn stream step on chunk x from ``state``: kernel F
    (`minn_rtl_fused_stream_step`) and the composed A + B step
    (`bench.composed_step`), each one call between CUDA events (median of
    5), back to back (`device_ms`) and by the profiler; F's bound
    (`f_work`) and the composed kernels' bound (A primed + B carried)."""
    C, B, Lc = x.shape
    H = state.hist.shape[-1]
    base = int(state.base)
    _, above = F.minn_rtl_metric(x, quarter_len=mp.quarter_len, **KW, base_index=base,
                                 hist_init=state.hist, carry_init=state.carry)
    gated = gated_samples(above, mp.hysteresis)
    f_step = lambda: ST.minn_rtl_fused_stream_step(state, x, params=mp)  # noqa: E731
    composed = lambda: BENCH.composed_step(state, x, mp)  # noqa: E731
    res = {"shape": [C, B, Lc], "f_ms": cuda_ms(f_step), "f_device_ms": device_ms(f_step),
           "f_kernel_ms": kernel_ms(f_step), "composed_ms": cuda_ms(composed),
           "composed_device_ms": device_ms(composed), "composed_kernel_ms": kernel_ms(composed),
           "work": f_work(B, Lc, C, x.element_size(), H, gated)}
    res["bound_ms"], res["bound_by"] = bound(*res["work"])
    res["composed_bound_ms"] = bound_sum((a_work(B, Lc, C, x.element_size(), 5, hist_len=H),
                                          b_work(above, gated)))[0]
    log(f"  {what}: kernel F {res['f_ms']:.4f} ms (back to back {res['f_device_ms']:.4f}, "
        f"profiler {res['f_kernel_ms']}) vs the composed A + B step {res['composed_ms']:.4f} "
        f"(back to back {res['composed_device_ms']:.4f}, profiler {res['composed_kernel_ms']}); "
        f"F's bound {res['bound_ms']:.5f} ms ({res['bound_by']}), A + B's "
        f"{res['composed_bound_ms']:.5f}; F {'slower' if res['f_ms'] > res['composed_ms'] else 'faster'}"
        f" than the composition by events; card {card}")
    return res


def step_profile(dev, mp, steps: int = 100) -> dict:
    """torch.profiler over ``steps`` batch-1 Minn steps of 4096 samples
    (`utils.profiling.device_window`): exactly one device kernel a step,
    all of them kernel F, and one kernel launch a step by the host, or the
    run fails."""
    x, _ = minn_stimulus(1, 8 * 4096, mp.quarter_len, dev, seed=150, events=[(0, 5000)])
    chunks = [c.contiguous() for c in x.split(4096, dim=-1)]
    st = {"state": ST.minn_rtl_fused_stream_init(mp, 1, device=dev), "i": 0}

    def step():
        st["state"], _ = ST.minn_rtl_fused_stream_step(st["state"], chunks[st["i"] % 8],
                                                       params=mp)
        st["i"] += 1

    w = profiling.device_window(step, steps, launches_per_call=1)
    by = w["by_kernel"]
    ok = (isinstance(by, dict) and w["device_events"] == w["host_launches"] == steps
          and len(by) == 1 and "minn_rtl_step_kernel" in next(iter(by))
          and next(iter(by.values()))["count"] == steps)
    if not ok:
        raise AssertionError(f"profiler over {steps} steps: {w['device_events']} device "
                             f"events, {w['host_launches']} kernel launches by the host, "
                             f"kernels {by}")
    return w


def phase_streams(dev, card: str) -> dict:
    B, n = STREAM["batch"], STREAM["n"]
    Q = MINN_PARAMS["quarter_len"]
    log(f"== phase 14: fused streams, {B} x {n} x 2 branches in chunks of "
        f"{' and '.join(map(str, STREAM['chunks']))}, card vs one-shot, the plain chain and CPU")
    mp = ST.MinnRTLStreamParams(**MINN_PARAMS)
    # preambles inside chunks and across 4096- and 65536-sample seams
    minn_ev = [(b, p) for b in range(0, B, 3) for p in (4096 * (7 + b) - 2 * Q, 65536 * 3 - Q,
                                                         n // 2 + 1000 * b) if p + 5 * Q <= n]
    aa_ev = [(b, p) for b in range(1, B, 4) for p in (4096 * (9 + b) - 512, 65536 * 5 - 300)
             if p + 1024 <= n]
    zc_ev = [(b, p) for b in range(2, B, 5) for p in (4096 * (11 + b) - 3, 65536 * 7 + 1)
             if p + 5 <= n]
    out = {}
    steps = sum(n // chunk for chunk in STREAM["chunks"])  # a path's steps
    counts, modes = collections.Counter(), collections.Counter()

    def path_counts(name: str) -> dict:
        c = launch_counts()
        counts.update(c)
        modes.update(mode_launch_counts())
        log(f"  {name} step path: launches {c}")
        return c

    # Minn-RTL: kernel F, against the one-shot full metric + B
    x, _ = minn_stimulus(B, n, Q, dev, seed=14, events=minn_ev)
    st, ref = F.minn_rtl_detect_planar_fused(x, quarter_len=Q, **KW, hysteresis=HYST)
    ref_u = F.minn_rtl_detect_fused(x, quarter_len=Q, **KW, hysteresis=HYST, emit_unclosed=True)
    c, e = F.minn_rtl_corr_energy_planar_fused(x, quarter_len=Q)
    check_equal(e, st.energy_total, "stream corr/energy energy")
    if rel_err(c, st.corr_positive) > CORR_RTOL:
        raise AssertionError("stream corr/energy: corr differs from the full metric")
    del c, e
    reset_launch_counts()
    states, o = check_stream(
        "minn", ST.minn_rtl_fused_stream_step,
        lambda: ST.minn_rtl_fused_stream_init(mp, B, device=dev), x, ref_u, HYST,
        dict(params=mp), knife=minn_knife(st, 3 * Q - 1))
    out.update(o)
    c = path_counts("minn")
    if c["minn_rtl_step"] != steps or c["minn_rtl_metric"] or c["gate_events"]:
        raise AssertionError(f"the {steps} Minn steps launched {c}: kernel F once a step, "
                             "A and B never")
    out["minn_step_launches"] = c["minn_rtl_step"]
    for chunk, state in states.items():
        cerr = float(((state.carry - st.smooth_metric[:, -1]).abs()
                      / st.smooth_metric[:, -1].abs().clamp_min(1.0)).max())
        if cerr > CARRY_RTOL:
            raise AssertionError(f"minn chunks of {chunk}: carry rel err {cerr} > {CARRY_RTOL}")
        out[f"minn_carry_rel_err_{chunk}"] = cerr
    log(f"  minn: {int(ref_u.count.sum())} events ({int(ref.count.sum())} closed); carry vs "
        f"one-shot smooth[:, -1], rel err {[out[f'minn_carry_rel_err_{c}'] for c in states]}")
    del st, ref, ref_u
    for chunk, state in states.items():
        out[f"minn_step_{chunk}"] = step_timings(x[..., :chunk].contiguous(), state, mp, card,
                                                 f"minn step at {B} x {chunk}")
    del states
    minn_small = x[:, :2, : 1 << 16].contiguous()
    del x
    torch.cuda.empty_cache()

    # [A][A]: kernels C + B-capture primed, bit-equal to the one-shot C + B
    lag = AA_HEADLINE["lag"]
    x = aa_stimulus(B, n, lag, dev, seed=15, events=aa_ev)
    rt, rP, rM = AF.aa_detect_fused(x, half_len=lag, emit_unclosed=True)
    reset_launch_counts()
    _, o = check_stream("aa", ST.aa_fused_stream_step,
                        lambda: ST.aa_fused_stream_init(lag, B, device=dev), x, rt, AA_HYST,
                        dict(half_len=lag), tie_last=False,
                        ref_cap=torch.cat([rP, rM[:, None]], dim=1))
    out.update(o)
    c = path_counts("aa")
    if c["aa_metric"] < steps or c["gate_events"] < steps:
        raise AssertionError(f"fewer kernel launches than the {steps} [A][A] steps: {c}")
    aa_small = x[:, :2, : 1 << 16].contiguous()
    del x, rt, rP, rM
    torch.cuda.empty_cache()

    # ZC CFAR: kernels D (magnitude) + B primed on dyadic magnitudes
    W = ZC_CFAR["corr_window"]
    mag = dyadic(mag_stimulus(B, n, dev, seed=16, events=zc_ev))
    ref_zc = ZF.zc_cfar_detect(mag, **ZC_CFAR)
    reset_launch_counts()
    _, o = check_stream("zc", ST.zc_cfar_fused_stream_step,
                        lambda: ST.zc_cfar_fused_stream_init(W, B, device=dev), mag,
                        ref_zc, 256, ZC_CFAR, tie_last=False)
    out.update(o)
    c = path_counts("zc")
    if c["zc_metric"] < steps or c["gate_events"] < steps:
        raise AssertionError(f"fewer kernel launches than the {steps} ZC CFAR steps: {c}")
    zc_small = mag[:2, : 1 << 16].contiguous()
    del mag
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts, modes = dict(counts), dict(modes)
    log(f"  launches on the three step paths: {counts}; modes {modes}")
    if min(modes.get("gate_events/primed", 0), modes.get("aa_metric/primed", 0),
           modes.get("zc_metric/primed", 0)) < 1:
        raise AssertionError(f"a primed kernel of the streams was not launched: {modes}")

    # the same streams at 2 x 2^16 on the CPU equal the card, chunk by chunk
    cases = (("minn", ST.minn_rtl_fused_stream_step,
              lambda d: ST.minn_rtl_fused_stream_init(mp, 2, device=d), minn_small,
              dict(params=mp)),
             ("aa", ST.aa_fused_stream_step, lambda d: ST.aa_fused_stream_init(lag, 2, device=d),
              aa_small, dict(half_len=lag)),
             ("zc", ST.zc_cfar_fused_stream_step,
              lambda d: ST.zc_cfar_fused_stream_init(W, 2, device=d), zc_small, ZC_CFAR))
    for name, step, init, xs, kw in cases:
        sg, tg, eg = run_stream(step, init(dev), xs, 4096, **kw)
        sc, tc, ec = run_stream(step, init("cpu"), xs.cpu(), 4096, **kw)
        for i, (a, b) in enumerate(zip(tg, tc)):
            assert_tables_equal(b, a, f"{name} card vs cpu, chunk {i}")
        for (Pa, Ma), (Pb, Mb) in zip(eg, ec):
            check_equal(Pa, Pb, f"{name} P card vs cpu")
            check_equal(Ma, Mb, f"{name} M card vs cpu")
        check_equal(sg.gate.cpu(), sc.gate, f"{name} gate carry card vs cpu")
        if name == "minn" and not torch.allclose(sg.carry.cpu(), sc.carry, rtol=CARRY_RTOL,
                                                 atol=CARRY_RTOL):
            raise AssertionError("minn: carry card vs cpu")
        log(f"  {name} at 2 x {1 << 16}: card == cpu over {len(tg)} chunks")
    return {"counts": counts, "modes": modes, "steps": 3 * steps, **out}


def phase_latency(dev, card: str) -> dict:
    log(f"== phase 15: per-block latency at batch 1 (2 branches, 4096-sample blocks, budget "
        f"{BENCH.BLOCK_BUDGET_US:.1f} us at 30.72 Msps) and streaming throughput")
    Q = MINN_PARAMS["quarter_len"]
    mp = ST.MinnRTLStreamParams(**MINN_PARAMS)
    lat = BENCH.block_latency(dev, seed=15)
    res = {}
    for name in ("fused", "composed", "plain"):
        for key in ("p50_us", "p90_us", "marginal_us", "enqueue_p50_us", "enqueue_p90_us"):
            res[f"{name}_{key}"] = lat[name][key]
        bound_us = lat[name].get("bound_us")
        log(f"  {name} step: p50 {res[f'{name}_p50_us']:.1f} us (p90 "
            f"{res[f'{name}_p90_us']:.1f}) per block with a sync after each, host enqueue p50 "
            f"{res[f'{name}_enqueue_p50_us']:.1f} us, marginal "
            f"{res[f'{name}_marginal_us']:.1f} us per block; launches "
            f"{lat[name]['launches']}; bound "
            f"{'-' if bound_us is None else f'{bound_us:.4f} us'}; budget "
            f"{BENCH.BLOCK_BUDGET_US:.1f} us; card {card}")
    res["fused_bound_us"], res["composed_bound_us"] = (lat["fused"]["bound_us"],
                                                        lat["composed"]["bound_us"])
    res["block_launches"] = lat["fused"]["launches"]
    prof = step_profile(dev, mp)
    res["profile"] = {k: prof[k] for k in ("calls", "window_ms", "bare_ms", "device_events",
                                           "host_launches", "busy_ms", "idle_share")}
    (name, k), = prof["by_kernel"].items()
    res["profile"]["f_kernel_us"] = k["ms"] / k["count"] * 1e3
    log(f"  profiler over {prof['calls']} batch-1 steps: {prof['device_events']} device "
        f"kernels, all kernel F ({name[:60]}), {res['profile']['f_kernel_us']:.2f} us a step on "
        f"the card, idle share {prof['idle_share']:.3f} of a {prof['window_ms']:.2f} ms window; "
        f"card {card}")

    # throughput: the headline stream in 16 fused steps vs one-shot A + B;
    # the streamed run's tables and final state against the one-shot run's
    B, L = HEADLINE["batch"], HEADLINE["L"]
    chunk = 16_384
    whole, _ = minn_stimulus(B, L, Q, dev)
    pieces = [whole[..., o: o + chunk].contiguous() for o in range(0, L, chunk)]
    ref, (carry1, gate1) = F.minn_rtl_detect_fused(whole, quarter_len=Q, **KW, hysteresis=HYST,
                                                   emit_unclosed=True, emit_state=True)
    knife = minn_knife(F.minn_rtl_metric_planar_fused(whole, quarter_len=Q, **KW), 3 * Q - 1)

    def streamed(tables=None):
        s = ST.minn_rtl_fused_stream_init(mp, B, device=dev)
        for p in pieces:
            s, t = ST.minn_rtl_fused_stream_step(s, p, params=mp)
            if tables is not None:
                tables.append(cpu_table(t))
        return s

    reset_launch_counts()
    tables = []
    s = streamed(tables)
    torch.cuda.synchronize()
    res["stream16_launches"], res["stream16_modes"] = launch_counts(), mode_launch_counts()
    c = res["stream16_launches"]
    if c["minn_rtl_step"] != len(pieces) or c["minn_rtl_metric"] or c["gate_events"]:
        raise AssertionError(f"the {len(pieces)} steps launched {c}: kernel F once a step, "
                             "A and B never")
    ref_h = cpu_table(ref)
    excused = compare_events([stitched(tables, None, b, L, HYST, True) for b in range(B)],
                             [table_events(ref_h, b) for b in range(B)], HYST,
                             f"{len(pieces)} steps vs one-shot", knife)
    res["stream16_knife_streams"] = len(excused)
    res["stream16_carry_rel_err"] = float(((s.carry - carry1).abs()
                                           / carry1.abs().clamp_min(1.0)).max())
    if res["stream16_carry_rel_err"] > CARRY_RTOL:
        raise AssertionError(f"streamed carry vs one-shot: {res['stream16_carry_rel_err']}")
    # the last above sample carries into the final state iff it lies in the
    # last chunk or within h of its start (the gate continued into it)
    la = gate1[:, 0]
    want_la = torch.where(la >= L - chunk - HYST, la, torch.full_like(la, -1)).cpu()
    keep = torch.ones(B, dtype=torch.bool)
    keep[excused] = False
    check_equal(s.gate[:, 0].cpu()[keep], want_la[keep], "streamed last-above vs one-shot")
    del s, ref, ref_h, carry1, gate1, knife, tables
    res["stream16_ms"] = cuda_ms(streamed)
    res["oneshot_ms"] = cuda_ms(lambda: F.minn_rtl_detect_fused(whole, quarter_len=Q, **KW,
                                                                 hysteresis=HYST))
    del whole
    torch.cuda.empty_cache()
    log(f"  {B} x {L} x 2 in {L // chunk} fused steps of {chunk}: tables and final state == "
        f"one-shot (launches {res['stream16_launches']}); {res['stream16_ms']:.3f} ms "
        f"= {B * L / res['stream16_ms'] * 1e3:.4g} samples/s vs one-shot A + B "
        f"{res['oneshot_ms']:.3f} ms ({res['stream16_ms'] / res['oneshot_ms']:.2f}x); card {card}")

    # kernel F and each primed kernel alone at the 512 x 16384 step shape,
    # against its plain version on the same inputs (the phase-13 rules),
    # then timed
    base = 3 * chunk
    p = pieces[3]
    hist = pieces[2][..., -1536:].contiguous()
    carry = torch.rand(B, device=dev) * 1e4
    gate = gate_carry(B, base, torch.Generator(device=dev).manual_seed(16), dev, HYST)
    kw = ST.minn_step_kwargs(mp, base)
    what = f"F at {B} x {chunk}"
    excused, res["f_err"] = check_step(F.minn_rtl_step(p, hist, carry, gate, **kw),
                                       plain_step(p, hist, carry, gate, kw),
                                       step_knife(p, hist, carry, base, Q), what)
    log(f"  {what} == plain ({excused} knife-edge streams), register rel err {res['f_err']:.2e}")
    state = ST.MinnRTLFusedStreamState(hist=hist, carry=carry, gate=gate,
                                       base=torch.tensor(base, dtype=torch.int32))
    res["f_step"] = step_timings(p, state, mp, card, what)
    res["plain_f_ms"] = cuda_ms(lambda: plain_step(p, hist, carry, gate, kw))
    log(f"  {what}: the plain step on the card {res['plain_f_ms']:.3f} ms")
    akw = dict(quarter_len=Q, **KW, base_index=base, hist_init=hist, carry_init=carry)
    plain_a = lambda: minn_rtl_metric_planar(  # noqa: E731
        F._planar_view(p), quarter_len=Q, **KW, base_index=base,
        hist_init=F._planar_view(hist), carry_init=carry)
    corr, above, carry_out = F.minn_rtl_metric(p, **akw, emit_state=True)
    full = F.minn_rtl_metric_planar_fused(p, **akw)
    st = plain_a()
    what = f"primed A at {B} x {chunk}"
    res["a_primed_err"] = rel_err(corr, st.corr_positive)
    if max(res["a_primed_err"], rel_err(full.corr_positive, st.corr_positive)) > CORR_RTOL:
        raise AssertionError(f"{what}: corr err {res['a_primed_err']} > {CORR_RTOL}")
    check_equal(full.energy_total, st.energy_total, f"{what} energy")
    if rel_err(full.smooth_metric, st.smooth_metric) > SMOOTH_RTOL:
        raise AssertionError(f"{what}: smooth differs by more than {SMOOTH_RTOL}")
    check_knife(above, st.above_threshold, st.smooth_metric, st.energy_total, what)
    check_knife(full.above_threshold, st.above_threshold, st.smooth_metric, st.energy_total,
                f"{what} full")
    if rel_err(carry_out, st.smooth_metric[:, -1]) > CARRY_RTOL:
        raise AssertionError(f"{what}: carry_out differs by more than {CARRY_RTOL}")
    del full, st
    run_a = lambda: F.minn_rtl_metric(p, **akw, emit_state=True)  # noqa: E731
    res["a_primed_ms"], res["a_primed_device_ms"] = cuda_ms(run_a), device_ms(run_a)
    res["a_primed_kernel_ms"] = kernel_ms(run_a)
    res["plain_a_primed_ms"] = cuda_ms(plain_a)
    gi = gate_carry(B, base, torch.Generator(device=dev).manual_seed(15), dev, HYST)
    bkw = dict(hysteresis=HYST, max_events=8, valid_from=3 * Q - 1, tie="last",
               emit_unclosed=True, base_index=base, stream_len_global=ST.EPOCH_HORIZON,
               gate_init=gi)
    table, gate_out = F.gate_events(above, corr, **bkw, emit_state=True)
    rt, _, rg = extract_gate_events_carried(above, corr, (), **bkw)
    assert_tables_equal(rt, table, f"primed B at {B} x {chunk}")
    check_equal(gate_out, rg, f"primed B at {B} x {chunk} gate_out")
    run_b = lambda: F.gate_events(above, corr, **bkw, emit_state=True)  # noqa: E731
    res["b_primed_ms"], res["b_primed_device_ms"] = cuda_ms(run_b), device_ms(run_b)
    res["b_primed_kernel_ms"] = kernel_ms(run_b)
    res["plain_b_primed_ms"] = cuda_ms(lambda: extract_gate_events_carried(above, corr, (),
                                                                           **bkw))
    res["a_primed_work"] = a_work(B, chunk, 4, 4, 5, hist_len=1536)
    res["b_primed_work"] = b_work(above, gated_samples(above, HYST))
    del corr, above, pieces, table, rt
    torch.cuda.empty_cache()
    lag = AA_HEADLINE["lag"]
    xa = aa_stimulus(B, 2 * chunk, lag, dev, seed=16, events=[(0, chunk + 100)])
    pa, ha = xa[..., chunk:].contiguous(), xa[..., chunk - 1024: chunk].contiguous()

    def plain_c():
        st = aa_metric_planar(F._planar_view(pa), lag, base_index=chunk, hist=F._planar_view(ha))
        return (st.P_re, st.P_im, *aa_detect_step(st.P_re, st.P_im, st.R, lag, AA_THR, chunk))

    o = AF.aa_metric(pa, half_len=lag, threshold=AA_THR, base_index=chunk, hist_init=ha)
    for name, out, want in zip(("P_re", "P_im", "track", "M", "above"),
                               (o.P_re, o.P_im, o.track, o.M, o.above), plain_c()):
        check_equal(out, want, f"primed C at {B} x {chunk} {name}")
    run_c = lambda: AF.aa_metric(pa, half_len=lag, threshold=AA_THR,  # noqa: E731
                                 base_index=chunk, hist_init=ha)
    res["c_primed_ms"], res["c_primed_device_ms"] = cuda_ms(run_c), device_ms(run_c)
    res["c_primed_kernel_ms"] = kernel_ms(run_c)
    res["plain_c_primed_ms"] = cuda_ms(plain_c)
    res["c_primed_work"] = c_work(B, chunk, 4, 4, 17, hist_len=1024)
    del xa, pa, ha, o
    mag = dyadic(mag_stimulus(B, 2 * chunk, dev, seed=17, events=[(0, chunk + 50)]))
    pm, hm = mag[:, chunk:].contiguous(), mag[:, chunk - 2048: chunk].contiguous()
    check_equal(ZF.zc_metric(pm, **ZC_CFAR, base_index=chunk, hist_init=hm).above,
                zc_cfar_planar(pm, **ZC_CFAR, base_index=chunk, hist=hm),
                f"primed D at {B} x {chunk} above")
    run_d = lambda: ZF.zc_metric(pm, **ZC_CFAR, base_index=chunk, hist_init=hm)  # noqa: E731
    res["d_primed_ms"], res["d_primed_device_ms"] = cuda_ms(run_d), device_ms(run_d)
    res["d_primed_kernel_ms"] = kernel_ms(run_d)
    res["plain_d_primed_ms"] = cuda_ms(lambda: zc_cfar_planar(pm, **ZC_CFAR, base_index=chunk,
                                                              hist=hm))
    res["d_primed_work"] = d_mag_work(B, chunk, hist_len=2048)
    del mag, pm, hm
    torch.cuda.empty_cache()
    log(f"  primed kernels at {B} x {chunk}, each == plain (the phase-13 rules): A "
        f"{res['a_primed_ms']:.3f} ms (plain {res['plain_a_primed_ms']:.3f}), B "
        f"{res['b_primed_ms']:.3f} (plain {res['plain_b_primed_ms']:.3f}), C "
        f"{res['c_primed_ms']:.3f} (plain {res['plain_c_primed_ms']:.3f}), D "
        f"{res['d_primed_ms']:.3f} (plain {res['plain_d_primed_ms']:.3f}); back to back: A "
        f"{res['a_primed_device_ms']:.4f}, B {res['b_primed_device_ms']:.4f}, C "
        f"{res['c_primed_device_ms']:.4f}, D {res['d_primed_device_ms']:.4f} ms; profiler: A "
        f"{res['a_primed_kernel_ms']}, B {res['b_primed_kernel_ms']}, C "
        f"{res['c_primed_kernel_ms']}, D {res['d_primed_kernel_ms']} ms; card {card}")
    return res


# ---------------------------------------------------------------------------
# phase 16: the families without a TPU kernel, and the C++ integer oracle
# ---------------------------------------------------------------------------

FAMILY_PIPELINES = {"sc": sc, "minn": minn, "minn_rtl": minn_rtl, "park": park,
                    "zc_freq": zc_freq, "combined_sc_minn": combined_sc_minn}
#: tests/test_pipeline_parity.py:20-156, the reference's printed results
#: (seed 0); a float is (value, tolerance), evm_pct is 100 x evm_rms
FAMILY_REFERENCE = {
    ("sc", "cir1"): dict(plateau_end=2063, coarse_start=2047, timing_error=540,
                         cfo_est_hz=(933.82, 0.05), evm_pct=(73.12, 0.15)),
    ("sc", None): dict(plateau_end=1861, coarse_start=1845, cfo_est_hz=(1027.74, 0.05),
                       evm_pct=(32.96, 0.15)),
    ("minn", "cir1"): dict(peak=2065, timing_error=116, cfo_est_hz=(1111.81, 0.05),
                           evm_pct=(96.45, 0.2)),
    ("minn", None): dict(peak=1856, timing_error=7, cfo_est_hz=(833.24, 0.05)),
    ("minn_rtl", "cir1"): dict(events=[(4593, 4593), (19951, 19951)],
                               per_event_errors=[84, 82], cfo_est_hz=(1069.26, 0.05)),
    ("minn_rtl", None): dict(events=[(4408, 4408), (19768, 19768)],
                             per_event_errors=[-1, -1], cfo_est_hz=(967.90, 0.05)),
    ("park", "cir1"): dict(det_center=8619, det_symbol_start=7595,  # the reference's mis-lock
                           cfo_est_hz=(1883.81, 0.05)),
    ("park", None): dict(det_center=2616, det_symbol_start=1592, timing_error=-1,
                         cfo_est_hz=(980.18, 0.05), evm_pct=(30.96, 0.15)),
    ("zc_freq", "cir1"): dict(detected_cp_start=1501, cfo_est_hz=(77.71, 0.1),
                              evm_pct=(70.47, 0.2)),
    ("zc_freq", None): {},
    ("combined_sc_minn", "cir1"): dict(peak=2064, timing_error=115,
                                       cfo_est_hz=(1082.82, 0.05), evm_pct=(66.73, 0.15)),
    ("combined_sc_minn", None): {},
}
#: the oracle's stimulus (tests/test_native_rtl.py:_stimulus) at two Q, and
#: one long stream whose preambles straddle kernel A's span seams (spans
#: of 16 tiles of 1024 samples at batch 1 and this length)
ORACLE_Q = (64, 512)
ORACLE_LONG = dict(L=1 << 20, Q=512, seam=16 * 1024)
RTL_TOL = 16  # the reference's RTL frame-start tolerance (ref/test_minn_preamble_detector.py)
#: phase 16's timings: one 0.55 s capture at 30.72 Msps, 2 branches
#: complex64 (256 MiB); the ZC FFT form at 2^20 samples in chunks of
#: ZC_FFT_CHUNK offsets (its 2^20 x 2 x 2048-point FFTs take 34 GB as one)
FAMILY_L = 1 << 24
ZC_FFT_L, ZC_FFT_CHUNK = 1 << 20, 8192


def check_recorded(r: dict, ref: dict, what: str) -> None:
    for key, want in ref.items():
        got = 100 * r["evm_rms"] if key == "evm_pct" else r[key]
        ok = abs(got - want[0]) < want[1] if isinstance(want, tuple) else got == want
        if not ok:
            raise AssertionError(f"{what}: {key} = {got}, the reference recorded {want}")


def integer_outputs(r: dict, out: str) -> tuple:
    """A run's integer results (the int and list fields of its dict) and
    its printed timing block (indices, events, gate segments)."""
    lines = out.splitlines()
    at = next(i for i, line in enumerate(lines) if line.startswith("Timing Detection"))
    block = []
    for line in lines[at:]:
        if not line.strip():
            break
        block.append(line)
    ints = {k: v for k, v in r.items() if isinstance(v, (int, list)) and not isinstance(v, bool)}
    return ints, block


def run_printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = fn(*args, **kw)
    return r, buf.getvalue()


def family_simulations(dev) -> dict:
    """(a): every simulation of the slice on the card against the recorded
    values and against the CPU run's integers; the Minn-RTL sweeps' integers
    against the CPU's."""
    res = {}
    for (name, channel), ref in FAMILY_REFERENCE.items():
        mod = FAMILY_PIPELINES[name]
        what = f"{name} {channel or 'awgn'}"
        card_r, card_out = run_printed(mod.run_simulation, channel, device=dev)
        cpu_r, cpu_out = run_printed(mod.run_simulation, channel, device="cpu")
        check_recorded(card_r, ref, what + " (card)")
        if integer_outputs(card_r, card_out) != integer_outputs(cpu_r, cpu_out):
            raise AssertionError(f"{what}: card integers {integer_outputs(card_r, card_out)} != "
                                 f"cpu {integer_outputs(cpu_r, cpu_out)}")
        res[what] = dict(cfo_est_hz=card_r["cfo_est_hz"], evm_pct=100 * card_r["evm_rms"])
    seq_card, _ = run_printed(minn_rtl.run_sequence_comparison, None, device=dev)
    seq_cpu, _ = run_printed(minn_rtl.run_sequence_comparison, None, device="cpu")
    seq_int = lambda rs: [(r["seq_type"], r["peak_idx"], r["timing_error"]) for r in rs]  # noqa: E731
    if seq_int(seq_card) != seq_int(seq_cpu):
        raise AssertionError(f"sequence comparison: card {seq_int(seq_card)} != cpu "
                             f"{seq_int(seq_cpu)}")
    q_card = minn_rtl.compare_q_values([128, 256, 512], device=dev)
    q_cpu = minn_rtl.compare_q_values([128, 256, 512], device="cpu")
    q_int = lambda qs: {Q: (r["timing_error"], r["preamble_len"]) for Q, r in qs.items()}  # noqa: E731
    if q_int(q_card) != q_int(q_cpu):
        raise AssertionError(f"Q comparison: card {q_int(q_card)} != cpu {q_int(q_cpu)}")
    log(f"  (a) 12 simulations on the card == the reference's recorded values and the CPU's "
        f"integers; sequence order {[r['seq_type'] for r in seq_card]} and Q timing errors "
        f"{ {Q: r['timing_error'] for Q, r in q_card.items()} } == cpu")
    res["sequences"] = seq_int(seq_card)
    return res


def oracle_cases() -> list[tuple]:
    """(label, Q, planar int16 codes (2, 2, L), event capacity)."""
    cases = [(f"Q={Q}", Q, rtl_stimulus(np.random.default_rng(0), Q, L=max(4000, 900 + 12 * Q)),
              16) for Q in ORACLE_Q]
    L, Q, seam = ORACLE_LONG["L"], ORACLE_LONG["Q"], ORACLE_LONG["seam"]
    positions = [3 * Q] + [3 * seam * k - 5 * Q // 2 + 97 * (k % 5) for k in range(1, 21)]
    cases.append((f"1 x {L}", Q, rtl_stimulus(np.random.default_rng(1), Q, L=L,
                                               positions=positions), 32))
    return cases


def check_oracle(dev, label: str, Q: int, iq: np.ndarray, E: int) -> dict:
    """(b) kernel A's corr/energy mode on the int16 codes == the C++
    model's integer traces (rounded once to A's float32 outputs); (c)
    kernel B on the C++ model's own above / track traces == its events,
    field by field; (d) A + B on the codes as float32: each event's peak
    within RTL_TOL of the C++ model's."""
    det = minn_rtl_detect_native(iq, quarter_len=Q, **KW, hysteresis=HYST, max_events=E,
                                 return_traces=True)
    if det.overflow or not det.count:
        raise AssertionError(f"{label}: the C++ model found {det.total} gates for {E} slots")
    corr_ref = np.maximum(det.corr_total, 0).astype(np.float32)
    corr, energy = F.minn_rtl_corr_energy_planar_fused(rtl_channel_leading(iq, dev),
                                                       quarter_len=Q)
    for what, got, want in (("corr_positive", corr, corr_ref),
                            ("energy_total", energy, det.energy_total.astype(np.float32))):
        got = got[0].cpu().numpy()
        if not np.array_equal(got, want):
            bad = np.flatnonzero(got != want)
            raise AssertionError(f"{label}: kernel A's {what} != the C++ trace at {bad[:5]}: "
                                 f"{got[bad[:5]]} vs {want[bad[:5]]}")
    table = F.gate_events(torch.as_tensor(det.above.astype(bool), device=dev)[None],
                          torch.as_tensor(corr_ref, device=dev)[None], hysteresis=HYST,
                          max_events=E, tie="last", emit_unclosed=False)
    want = [e[:3] + (float(np.float32(e[3])),) + e[4:] for e in native_events(det)]
    if event_tuples(table) != want:
        raise AssertionError(f"{label}: kernel B on the C++ traces {event_tuples(table)} != "
                             f"the C++ events {want}")
    fused = F.minn_rtl_detect_fused(rtl_channel_leading(iq, dev, torch.float32), quarter_len=Q,
                                    **KW, hysteresis=HYST, max_events=E)
    peaks = [e[2] for e in event_tuples(fused)]
    native_peaks = [int(p) for p in det.peak_idx]
    if len(peaks) != len(native_peaks) or any(
            abs(a - b) > RTL_TOL for a, b in zip(peaks, native_peaks)):
        raise AssertionError(f"{label}: A + B peaks {peaks} vs the C++ model's {native_peaks}")
    return dict(events=det.count,
                max_peak_diff=max(abs(a - b) for a, b in zip(peaks, native_peaks)))


def family_stimulus(dev, build, pos: int, seed: int) -> torch.Tensor:
    """(2, FAMILY_L) complex64 on the card: unit-power complex Gaussian
    samples (the statistics of OFDM data), one family's unit-power preamble
    in place of samples [pos, pos + len) on both branches, and noise 20 dB
    below, all from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.complex(*torch.randn((2, 2, FAMILY_L), generator=g, device=dev).mul_(0.5 ** 0.5))
    pre = torch.as_tensor(build(), device=dev).to(torch.complex64)
    x[:, pos: pos + pre.numel()] = pre
    return x + torch.complex(*torch.randn((2, 2, FAMILY_L), generator=g, device=dev).mul_(0.07))


def family_timings(dev, card: str) -> dict:
    """(e): each family's detect on one 2^24 x 2 stream holding its
    preamble, the result checked against the preamble's position, then
    timed; the ZC FFT form on the first 2^20 samples."""
    sys_, cp = SYS_30M72, SYS_30M72.cp_len
    pos, zpos = FAMILY_L // 2 + 12345, ZC_FFT_L // 2 + 4321
    rng = lambda: np.random.default_rng(0)  # noqa: E731
    sc_pre = lambda: WV.build_sc_preamble(rng(), sys_)  # noqa: E731
    minn_pre = lambda: WV.build_minn_preamble(rng(), sys_)  # noqa: E731
    park_pre = lambda: WV.build_park_preamble(rng(), sys_)  # noqa: E731
    pss = lambda: WV.build_pss_symbol(sys_, include_cp=True)  # noqa: E731
    # name, detector, stimulus, samples, (output key, expected, tolerance)
    cases = [
        ("sc", D.SCDetector(), sc_pre, FAMILY_L, ("plateau_end", pos + cp, cp // 2)),
        ("minn", D.MinnDetector(), minn_pre, FAMILY_L, ("peak", pos + cp, 64)),
        ("combined_sc_minn", D.CombinedSCMinnDetector(), minn_pre, FAMILY_L,
         ("peak", pos + cp, 64)),
        ("park", D.ParkDetector(), park_pre, FAMILY_L,
         ("det_symbol_start", pos + cp // 2, 16)),
        ("zc_freq_sliding", D.ZCFreqDetector(form="sliding"), pss, FAMILY_L,
         ("detected_cp_start", zpos, 16)),
        ("zc_freq_fft", D.ZCFreqDetector(form="fft", chunk=ZC_FFT_CHUNK), pss, ZC_FFT_L,
         ("detected_cp_start", zpos, 16)),
    ]
    out = {}
    # the windowed sums' scan: torch.cumsum along the long last axis of a
    # 2-row stream, against the port's two-level `ops.windows.cumsum`
    g = torch.Generator(device=dev).manual_seed(16)
    for dt in (torch.float64, torch.complex128):
        v = torch.randn((2, FAMILY_L), generator=g, dtype=dt, device=dev)
        err = float((cumsum(v) - torch.cumsum(v, dim=-1)).abs().max())
        r = dict(torch_ms=cuda_ms(lambda: torch.cumsum(v, dim=-1), reps=3),
                 two_level_ms=cuda_ms(lambda: cumsum(v), reps=3), max_abs_diff=err)
        out[f"cumsum {str(dt).split('.')[-1]}"] = r
        log(f"  (e) cumsum of 2 x {FAMILY_L} {dt}: torch.cumsum {r['torch_ms']:.3f} ms, "
            f"two-level {r['two_level_ms']:.3f} ms (max |diff| {err:.3g}); card {card}")
        del v
    for seed, (name, det, build, n, (key, want, tol)) in enumerate(cases):
        x = family_stimulus(dev, build, zpos if name.startswith("zc") else pos, seed)[:, :n]
        got = det.detect(x)[key]
        if abs(got - want) > tol:
            raise AssertionError(f"{name} at 2 x {n}: {key} {got}, the preamble puts it at {want}")
        run = lambda: det.detect(x)  # noqa: E731
        bound_ms = bound(x.numel() * 8, 0)[0]
        r = dict(samples=n, ms=cuda_ms(run, reps=3), kernel_ms=kernel_ms(run, reps=3),
                 bound_ms=bound_ms, bound_by="bytes", found=(key, got))
        r["samples_per_s"] = n / (r["ms"] * 1e-3)
        out[name] = r
        log(f"  (e) {name} detect, 2 x {n} complex64: {r['ms']:.3f} ms "
            f"({r['samples_per_s'] / 1e9:.3f} G samples/s), profiler {r['kernel_ms']} ms, "
            f"bytes bound {bound_ms:.4f} ms; {key} {got}; card {card}")
        del x
        torch.cuda.empty_cache()
    return out


def phase_families(dev, card: str) -> dict:
    log("== phase 16: the families without a TPU kernel (sc, minn, minn_rtl, park, zc_freq, "
        "combined_sc_minn) and the C++ integer oracle vs kernels A and B")
    res = {"simulations": family_simulations(dev)}
    cases = oracle_cases()
    reset_launch_counts()
    oracle = {label: check_oracle(dev, label, Q, iq, E) for label, Q, iq, E in cases}
    torch.cuda.synchronize()
    modes = mode_launch_counts()
    counts = launch_counts()
    for need in ("minn_rtl_metric/corr_energy", "minn_rtl_metric/corr_above"):
        if modes.get(need, 0) < 1:
            raise AssertionError(f"{need} was not launched by the oracle checks: {modes}")
    if counts["gate_events"] < 1:
        raise AssertionError(f"kernel B was not launched by the oracle checks: {counts}")
    log(f"  (b)-(d) kernel A's int16 corr/energy == the C++ traces, kernel B on the C++ traces "
        f"== the C++ events, A + B peaks within {RTL_TOL} of the C++ model's: {oracle}; "
        f"launches {modes}")
    res.update(oracle=oracle, modes=modes, gate_events=counts["gate_events"],
               timings=family_timings(dev, card))
    return res


# ---------------------------------------------------------------------------
# phase 17: the sharded path (`parallel.shard`) on the one card
# ---------------------------------------------------------------------------

#: phase 17(a)'s ranks, all on the one card over gloo (NCCL takes one rank a card)
SHARD_RANKS = 4
SHARD_MESHES = ((1, 4), (2, 2))
#: the sharded Minn detect's split: the first rows of a shard wait for the halo
SHARD_ROWS = 2048
#: frames of the long-stream receive: 4096 samples from the preamble's start
SHARD_FRAMES = dict(frame_len=4096, timing_offset=-6 * HEADLINE["Q"], max_frames=8)


def minn_halo() -> int:
    return SH.minn_halo_width(HEADLINE["Q"], KW["smooth_shift"], HYST)


def shard_events(L: int, batch: int) -> list:
    """Preambles whose gates cross the (1, 4) seams, the overlap split of a
    shard (SHARD_ROWS in) and a halo's start (W before a seam), and some
    inside shards: minn_stimulus's four and five more at the headline (one
    a stream), eight on one long stream."""
    Q, W, S = HEADLINE["Q"], minn_halo(), L // 4
    seams = [S - 6 * Q, 2 * S - 7 * Q, 2 * S + SHARD_ROWS - 6 * Q, 3 * S - W - 2 * Q,
             S + SHARD_ROWS - 6 * Q]
    if batch == 1:
        return [(0, p) for p in [3 * Q, S // 2, 2 * S + S // 2, 3 * S + S // 3] + seams[:4]]
    return ([(0, 3 * Q), (1, L // 3), (2, L // 2), (3, L - 7 * Q)]
            + [(4 + k, p) for k, p in enumerate(seams)])


def seq_block(x, mesh, block: int):
    """The rank's (C, B_loc, block) block of a (C, batch, n) stream, zero
    past n (the last block of a length that does not divide)."""
    bb = x.shape[1] // mesh.n_data
    lo = mesh.seq * block
    out = torch.zeros((x.shape[0], bb, block), dtype=x.dtype, device=x.device)
    hi = min(lo + block, x.shape[-1])
    out[..., : hi - lo] = x[:, mesh.data * bb: (mesh.data + 1) * bb, lo:hi]
    return out


def zc_case(dev):
    """Phase 12's from-IQ headline stimulus, its template, taps and norm."""
    B, n = ZC_HEADLINE["batch"], ZC_HEADLINE["n"]
    ref, taps, ref_norm = pss_template(2048)
    events = [(0, 3000), (1, n // 3), (2, n // 2), (3, n - len(ref) - 500)]
    return zc_iq_stimulus(B, n, ref, dev, events=events), taps, events, dict(
        ref_len=len(ref), ref_norm=ref_norm, **ZC_CFAR, hysteresis=ZC_EVENTS["hysteresis"],
        max_events=ZC_EVENTS["max_events"])


def aa_case(dev):
    B, n, lag = AA_HEADLINE["batch"], AA_HEADLINE["n"], AA_HEADLINE["lag"]
    S = n // 4
    events = [(0, 3 * lag), (1, n // 3), (2, n // 2), (3, n - 2 * lag - 700),
              (4, S - lag), (5, 2 * S - 2 * lag + 1), (6, 3 * S - 3 * lag)]
    return aa_stimulus(B, n, lag, dev, events=events), events


def shard_rank(rank: int) -> dict:
    """One rank of phase 17(a): every sharded run on its block, the launch
    counts of each run, the tables as host arrays.  Each rank draws the
    whole stimulus on the card from the same seeded generator as the parent
    and keeps its block; it loads the kernel library the parent built."""
    torch.cuda.set_device(0)
    dev = card_device()
    if build.build().seconds:
        raise AssertionError(f"rank {rank} rebuilt the kernels")
    build.library()
    meshes = {m: SH.make_stream_mesh(*m) for m in SHARD_MESHES}
    Q = HEADLINE["Q"]
    det = dict(quarter_len=Q, **KW, hysteresis=HYST, rows=SHARD_ROWS)
    out = {}

    def run(key, fn):
        reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        out[key] = (res, mode_launch_counts(), launch_counts())

    B, L = HEADLINE["batch"], HEADLINE["L"]
    x32, _ = minn_stimulus(B, L, Q, dev, events=shard_events(L, B))
    for name in ("f32", "i16"):
        x = x32 if name == "f32" else x32.to(torch.int16)
        for m, mesh in meshes.items():
            blk = seq_block(x, mesh, L // mesh.n_seq)
            run(("minn", name, m), lambda: (mesh.data, table_arrays(
                SH.sharded_minn_rtl_detect_fused(blk, mesh, **det, overlap_halo=True))))
            del blk
        del x
    del x32
    torch.cuda.empty_cache()

    mesh, Ll = meshes[1, 4], LONG["L"]
    x, _ = minn_stimulus(1, Ll, Q, dev, seed=17, events=shard_events(Ll, 1))
    blk = seq_block(x, mesh, Ll // 4)
    del x
    for overlap in (False, True):
        run(("long", overlap), lambda: table_arrays(SH.sharded_minn_rtl_detect_fused(
            blk, mesh, **det, max_events=32, emit_unclosed=True, overlap_halo=overlap)))
    run(("receive",), lambda: [a.cpu().numpy() if torch.is_tensor(a) else table_arrays(a)
                                for a in SH.sharded_minn_rtl_receive(
                                    blk, mesh, **det, max_events=32, **SHARD_FRAMES)])
    del blk

    def zc():
        x, taps, _, kw = zc_case(dev)
        mf = MF.matched_filter_ols(x, taps)
        Lc = mf.shape[-1]
        mf_b, iq_b = seq_block(mf, mesh, -(-Lc // 4)), seq_block(x, mesh, -(-Lc // 4))
        del x, mf
        return table_arrays(SH.sharded_zc_iq_detect(mf_b, iq_b, mesh, **kw, stream_len=Lc))

    run(("zc",), zc)
    torch.cuda.empty_cache()

    def aa():
        x, _ = aa_case(dev)
        blk = seq_block(x, mesh, AA_HEADLINE["n"] // 4)
        del x
        t, P, M = SH.sharded_aa_detect_fused(blk, mesh, half_len=AA_HEADLINE["lag"],
                                             threshold=AA_THR, hysteresis=AA_HYST)
        return table_arrays(t), P.cpu().numpy(), M.cpu().numpy()

    run(("aa",), aa)
    return out


def host_table(arrays: dict) -> GateEvents:
    return GateEvents(*(torch.from_numpy(np.asarray(arrays[f])) for f in GateEvents._fields))


def rank_events(arrays, ref, lo: int, h: int, what: str, knife=None, cap=None,
                ref_cap=None) -> int:
    """A rank's merged table (its streams lo, lo + 1, ...) against the
    one-shot host table ``ref``, event by event; an event may differ only
    where its gate span holds a knife-edge sample (`compare_events`).
    Returns the streams so excused."""
    have_t = host_table(arrays)
    n = have_t.count.shape[0]
    have = [table_events(have_t, b, cap) for b in range(n)]
    want = [table_events(ref, lo + b, ref_cap) for b in range(n)]
    kn = None if knife is None else {b - lo: v for b, v in knife.items() if lo <= b < lo + n}
    return len(compare_events(have, want, h, what, kn))


def need(modes: dict, what: str, *names: str) -> None:
    """Fail unless each ``kernel/mode`` (or kernel) launched in a run."""
    missing = [m for m in names if modes.get(m, 0) < 1]
    if missing:
        raise AssertionError(f"{what}: {missing} not launched ({modes})")


def seam_gates(above, h: int, seams) -> dict:
    """For a one-shot above (1, L): at each seam, whether a gate is open
    across it and whether the last above sample before it lies within h."""
    out = {}
    for s in seams:
        before = above[0, s - h: s].nonzero().flatten().tolist()
        out[s] = dict(last_above_within_h=bool(before), above_at_seam=bool(above[0, s]))
    return out


def phase_shards(dev, card: str) -> dict:
    """Phase 17: (a) the sharded Minn-RTL detect and receive, ZC from-IQ
    and [A][A] detects over SHARD_RANKS gloo ranks sharing the card, every
    rank's merged table against the one-shot kernels' on the card; (b)
    mesh (1, 1) over NCCL in this process, timed against the one-shot
    kernels, and kernel A on a shard's interior view against a copy."""
    Q, B, L, h = HEADLINE["Q"], HEADLINE["batch"], HEADLINE["L"], HYST
    W = minn_halo()
    log(f"== phase 17: the sharded path on the one card: {SHARD_RANKS} gloo ranks, meshes "
        f"{SHARD_MESHES}, halo W = {W}, overlap split at {SHARD_ROWS}")
    t0 = time.perf_counter()
    det = dict(quarter_len=Q, **KW, hysteresis=h)
    res = {}

    # the one-shot references on the card (host tables, knife-edge samples)
    x32, _ = minn_stimulus(B, L, Q, dev, events=shard_events(L, B))
    st = F.minn_rtl_metric_planar_fused(x32, quarter_len=Q, **KW)
    knife = minn_knife(st, 3 * Q - 1)
    del st
    ref = {name: cpu_table(F.minn_rtl_detect_fused(x, **det))
           for name, x in (("f32", x32), ("i16", x32.to(torch.int16)))}
    for b, pos in shard_events(L, B):
        pk = ref["f32"].peak_idx[b][ref["f32"].valid[b]].tolist()
        if not any(5 * Q <= p - pos <= 7 * Q for p in pk):
            raise AssertionError(f"phase 17: preamble at {b}:{pos} not found one-shot")
    del x32
    Ll = LONG["L"]
    xl, _ = minn_stimulus(1, Ll, Q, dev, seed=17, events=shard_events(Ll, 1))
    stl = F.minn_rtl_metric_planar_fused(xl, quarter_len=Q, **KW)
    knife_long = minn_knife(stl, 3 * Q - 1)
    res["long_seams"] = seam_gates(stl.above_threshold, h, [k * Ll // 4 for k in (1, 2, 3)])
    del stl
    ref_long = cpu_table(F.minn_rtl_detect_fused(xl, **det, max_events=32, emit_unclosed=True))
    x, taps, zc_events, zkw = zc_case(dev)
    ref_zc = cpu_table(ZF.zc_iq_cfar_detect(MF.matched_filter_ols(x, taps), x, **zkw))
    del x
    x, aa_events = aa_case(dev)
    t, P, M = AF.aa_detect_fused(x, half_len=AA_HEADLINE["lag"])
    ref_aa, ref_aa_cap = cpu_table(t), torch.cat([P, M[:, None]], dim=1).cpu()
    del x, t, P, M
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0

    # (a) the ranks
    ranks = DI.run_ranks(shard_rank, SHARD_RANKS, backend="gloo", timeout_s=600)
    t_ranks = time.perf_counter() - t0 - t_ref
    knives = collections.Counter()
    strided = 0
    for r, out in enumerate(ranks):
        for name in ("f32", "i16"):
            for m in SHARD_MESHES:
                (d, arrays), modes, _ = out["minn", name, m]
                what = f"rank {r} minn {name} mesh {m}"
                need(modes, what, "minn_rtl_metric/strided", "minn_rtl_metric/primed",
                     "gate_events/primed")
                strided += modes.get("minn_rtl_metric/strided", 0)
                knives["minn"] += rank_events(arrays, ref[name], d * (B // m[0]), h, what, knife)
        for overlap in (False, True):
            arrays, modes, _ = out["long", overlap]
            what = f"rank {r} long stream overlap {overlap}"
            need(modes, what, "minn_rtl_metric/primed", "gate_events/primed",
                 *(("minn_rtl_metric/strided",) if overlap else ()))
            if not overlap and modes.get("minn_rtl_metric/strided"):
                raise AssertionError(f"{what}: a strided launch without the split")
            strided += modes.get("minn_rtl_metric/strided", 0)
            knives["long"] += rank_events(arrays, ref_long, 0, h, what, knife_long)
        (table, frames, starts, valid), modes, _ = out["receive",]
        strided += modes.get("minn_rtl_metric/strided", 0)
        knives["long"] += rank_events(table, ref_long, 0, h, f"rank {r} receive", knife_long)
        merged = GateEvents(*(torch.as_tensor(np.asarray(table[f])[0], device=dev)
                              for f in GateEvents._fields))
        want = extract_frames(xl[:, 0], merged, **SHARD_FRAMES)
        for nm, w, g in zip(("frames", "starts", "valid"), want, (frames, starts, valid)):
            if not np.array_equal(w.cpu().numpy(), g[0]):
                raise AssertionError(f"rank {r} receive: {nm} differ from the one-shot "
                                     "extract_frames on the merged table")
        res.setdefault("receive_frames", int(valid.sum()))
        arrays, modes, counts = out["zc",]
        need({**modes, **counts}, f"rank {r} zc", "zc_metric/primed_iq", "gate_events/primed",
             "matched_filter_ols")
        rank_events(arrays, ref_zc, 0, ZC_EVENTS["hysteresis"], f"rank {r} zc")
        (arrays, P, M), modes, _ = out["aa",]
        need(modes, f"rank {r} aa", "aa_metric/primed", "gate_events/primed")
        rank_events(arrays, ref_aa, 0, AA_HYST, f"rank {r} aa",
                    cap=torch.from_numpy(np.concatenate([P, M[:, None]], axis=1)),
                    ref_cap=ref_aa_cap)
    del xl
    # a noise-only ZC stream may hold an event only in the mf's last ZC_TAIL outputs
    n, R = ZC_HEADLINE["n"], 2048
    quiet = torch.ones(ZC_HEADLINE["batch"], dtype=torch.bool)
    quiet[[b for b, _ in zc_events]] = False
    body = (ref_zc.valid & (ref_zc.peak_idx < n + R - 1 - ZC_TAIL)).any(dim=-1)
    if (quiet & body).any():
        raise AssertionError(f"phase 17 zc: events in noise-only streams "
                             f"{(quiet & body).nonzero().flatten().tolist()}")
    check_zc_found(ref_zc, zc_events, R, "phase 17 zc")
    check_aa_found(ref_aa, aa_events, AA_HEADLINE["lag"], "phase 17 aa")
    res.update(strided_launches=strided, knife_streams=dict(knives), ref_s=t_ref,
               ranks_s=t_ranks, events=dict(minn=int(ref["f32"].count.sum()),
                                           long=int(ref_long.count.sum()),
                                           zc=int(ref_zc.count.sum()),
                                           aa=int(ref_aa.count.sum())))
    log(f"  (a) {SHARD_RANKS} ranks x (Minn headline f32 / int16 on {SHARD_MESHES}, long stream "
        f"overlap off / on, receive, ZC from-IQ, [A][A]): every merged table == one-shot "
        f"({res['events']} events one-shot; streams excused on a knife edge {dict(knives)}); "
        f"frames == extract_frames ({res['receive_frames']} valid); kernel A strided launches "
        f"{strided}; long-stream seams {res['long_seams']}; references {t_ref:.1f} s, ranks "
        f"{t_ranks:.1f} s")

    # (b) mesh (1, 1) over NCCL in this process
    x32, _ = minn_stimulus(B, L, Q, dev, events=shard_events(L, B))
    with BENCH.mesh11(dev) as mesh:
        for overlap in (True, False):
            t = SH.sharded_minn_rtl_detect_fused(x32, mesh, **det, overlap_halo=overlap,
                                                 rows=SHARD_ROWS)
            knives["mesh11"] += rank_events(table_arrays(t), ref["f32"], 0, h,
                                            f"mesh (1, 1) overlap {overlap}", knife)
        sharded = lambda ov: lambda: SH.sharded_minn_rtl_detect_fused(  # noqa: E731
            x32, mesh, **det, overlap_halo=ov, rows=SHARD_ROWS)
        view = x32[..., SHARD_ROWS:]
        run_view = lambda: F.minn_rtl_metric(view, quarter_len=Q, **KW)  # noqa: E731
        run_copy = lambda: F.minn_rtl_metric(view.contiguous(), quarter_len=Q, **KW)  # noqa: E731
        reset_launch_counts()
        res["strided_err"] = check_metric(view, Q, "kernel A on the interior view")
        if mode_launch_counts().get("minn_rtl_metric/strided") != 1:
            raise AssertionError(f"the interior view did not run strided: {mode_launch_counts()}")
        res.update(
            sharded_overlap_ms=cuda_ms(sharded(True)), sharded_serial_ms=cuda_ms(sharded(False)),
            one_shot_ms=cuda_ms(lambda: F.minn_rtl_detect_fused(x32, **det)),
            view_ms=cuda_ms(run_view), copy_ms=cuda_ms(run_copy),
            sharded_overlap_kernel_ms=kernel_ms(sharded(True)),
            one_shot_kernel_ms=kernel_ms(lambda: F.minn_rtl_detect_fused(x32, **det)),
            view_kernel_ms=kernel_ms(run_view), copy_kernel_ms=kernel_ms(run_copy),
            plain_view_ms=cuda_ms(lambda: plain_metric(view, Q), reps=3),
            view_work=a_work(B, L - SHARD_ROWS, 4, 4, 5))
        # the sharded detect's parts beside its kernels: one priming pass
        # (the plain metric over W samples), the local merge of the split's
        # two tables, the merge across seq (all-gather of one rank)
        tail = x32[..., SHARD_ROWS - W: SHARD_ROWS]
        carried = dict(det, emit_unclosed=True, stream_len_global=L)
        pieces = (F.minn_rtl_detect_fused(x32[..., :SHARD_ROWS], **carried, base_index=0),
                  F.minn_rtl_detect_fused(view, **carried, base_index=SHARD_ROWS))
        stacked = SH.stack_tables(pieces)
        res.update(
            prime_ms=cuda_ms(lambda: plain_metric(tail, Q)),
            local_merge_ms=cuda_ms(lambda: SH.merge_stacked_event_tables(
                stacked, h=h, E=8, K=1, tie_last=True, emit_unclosed=True)),
            seq_merge_ms=cuda_ms(lambda: SH.merge_shard_event_tables(
                pieces[1], mesh, h=h, E=8, tie_last=True, emit_unclosed=False)))
        del pieces, stacked
    del x32, view
    torch.cuda.empty_cache()
    res["knife_streams"] = dict(knives)
    res["seconds"] = time.perf_counter() - t0
    log(f"  (b) mesh (1, 1) over NCCL, {B} x {L} x 2 f32: sharded detect, overlap split "
        f"{res['sharded_overlap_ms']:.3f} ms (profiler {res['sharded_overlap_kernel_ms']}), one "
        f"primed call {res['sharded_serial_ms']:.3f} ms; one-shot A + B {res['one_shot_ms']:.3f} "
        f"ms (profiler {res['one_shot_kernel_ms']}); kernel A on x[..., {SHARD_ROWS}:] in place "
        f"{res['view_ms']:.3f} ms (profiler {res['view_kernel_ms']}) vs .contiguous() + kernel "
        f"{res['copy_ms']:.3f} ms (profiler {res['copy_kernel_ms']}), plain "
        f"{res['plain_view_ms']:.3f} ms; parts: priming pass {res['prime_ms']:.3f} ms, local "
        f"merge {res['local_merge_ms']:.3f} ms, merge across seq {res['seq_merge_ms']:.3f} ms; "
        f"phase {res['seconds']:.1f} s; card {card}")
    return res


# ---------------------------------------------------------------------------
# phase 18: the rest of the sharded layer (metrics, per-sample merge, ZC)
# ---------------------------------------------------------------------------

#: the sharded Schmidl-Cox metric's window at the [A][A] headline (half = L)
REST_SC_NFFT = 2 * AA_HEADLINE["lag"]
#: sharded metrics vs one-shot: relative to max(1, |one-shot|max)
REST_METRIC_RTOL = 1e-6
#: the ZC detect from IQ: an above bit may differ from the one-shot one only
#: where |mag 2^frac - local_sum T| is within this fraction of local_sum T,
#: or mag within it of min_corr_mag: each shard's matched filter rounds in
#: blocks of its own (kernel E's blocks start at the shard's halo)
ZC_IQ_KNIFE_RTOL = 1e-5


def zc_cfar_case(dev):
    """The ZC CFAR cell's magnitudes (`mag_stimulus`, dyadic so every local
    sum is exact) with peaks inside shards, on the (1, 4) seams, and W + h
    before one."""
    B, n = ZC_HEADLINE["batch"], ZC_HEADLINE["n"]
    S, W = n // 4, ZC_CFAR["corr_window"]
    events = [(0, 3000), (1, S - 1), (2, 2 * S + 2), (3, 3 * S - W - ZC_EVENTS["hysteresis"]),
              (4, n // 2 + 777), (5, S + 100)]
    return dyadic(mag_stimulus(B, n, dev, seed=18, events=events)), events


def cplx_err(out, ref) -> float:
    """`rel_err` of complex tensors, over their planes."""
    return rel_err(torch.view_as_real(out), torch.view_as_real(ref)) if out.is_complex() else \
        rel_err(out, ref)


def rest_rank(rank: int) -> dict:
    """One rank of phase 18(a): the sharded metrics (held here to the
    one-shot kernels on the same seeded stimulus: the arrays are too large
    to send back), and the per-sample and table-merged detects (tables
    returned); the launch counts of each sharded run alone."""
    torch.cuda.set_device(0)
    dev = card_device()
    if build.build().seconds:
        raise AssertionError(f"rank {rank} rebuilt the kernels")
    build.library()
    meshes = {m: SH.make_stream_mesh(*m) for m in SHARD_MESHES}
    B, L, Q = HEADLINE["batch"], HEADLINE["L"], HEADLINE["Q"]
    metric = dict(quarter_len=Q, **KW)
    out, counts = {}, {}

    def run(key, fn):
        reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        counts[key] = {**mode_launch_counts(), **launch_counts()}
        return res

    def rows(x, mesh):
        bb = x.shape[1] // mesh.n_data
        return x[:, mesh.data * bb: (mesh.data + 1) * bb].contiguous()

    x32, _ = minn_stimulus(B, L, Q, dev, events=shard_events(L, B))
    for m, mesh in meshes.items():
        block = L // mesh.n_seq
        sl = slice(mesh.seq * block, (mesh.seq + 1) * block)
        blk = seq_block(x32, mesh, block)
        corr, smooth, energy, above = run(
            ("minn_metric", m), lambda: SH.sharded_minn_rtl_planar(blk, mesh, **metric))
        one = F.minn_rtl_metric_planar_fused(rows(x32, mesh), **metric)
        what = f"rank {rank} minn metric mesh {m}"
        check_equal(corr, one.corr_positive[:, sl], what + " corr")
        check_equal(energy, one.energy_total[:, sl], what + " energy")
        err = rel_err(smooth, one.smooth_metric[:, sl])
        if err > SMOOTH_RTOL:
            raise AssertionError(f"{what}: smooth differs by {err} > {SMOOTH_RTOL}")
        knife = check_knife(above, one.above_threshold[:, sl], one.smooth_metric[:, sl],
                            one.energy_total[:, sl], what)
        out["minn_metric", m] = dict(smooth_err=err, knife_bits=knife)
        del corr, smooth, energy, above, one
        t = run(("minn_detect", m), lambda: SH.sharded_minn_rtl_detect(
            blk, mesh, **metric, hysteresis=HYST))
        out["minn_detect", m] = (mesh.data, table_arrays(t))
        del blk
    del x32
    torch.cuda.empty_cache()

    xa, _ = aa_case(dev)
    n, lag, N = AA_HEADLINE["n"], AA_HEADLINE["lag"], REST_SC_NFFT
    for m, mesh in meshes.items():
        block = n // mesh.n_seq
        lo = mesh.seq * block
        blk, xr = seq_block(xa, mesh, block), rows(xa, mesh)
        P, R, M, valid = run(("aa", m), lambda: SH.sharded_aa_metric(blk, mesh, lag))
        one = AF.aa_metric(xr, half_len=lag)
        what = f"rank {rank} aa metric mesh {m}"
        check_equal(P.real, one.P_re[:, lo: lo + block], what + " P_re")
        check_equal(P.imag, one.P_im[:, lo: lo + block], what + " P_im")
        check_equal(R, one.R[:, lo: lo + block], what + " R")
        M1, v1 = SP._aa_normalized(one.P_re * one.P_re + one.P_im * one.P_im, one.R, lag)
        check_equal(M, M1[:, lo: lo + block], what + " M")
        check_equal(valid[0], v1[lo: lo + block], what + " valid")
        del P, R, M, valid, one, M1
        Msc, Psc, Rsc = run(("sc", m), lambda: SH.sharded_sc_metric(blk, mesh, N))
        hi = min(lo + block, n - N + 1)  # the plain metric's last offset
        err = 0.0
        for b in range(xr.shape[1]):  # the plain SC metric, a stream at a time
            ref = sc_metric(torch.complex(xr[0::2, b], xr[1::2, b]), N)
            err = max(err, *(cplx_err(got[b, : hi - lo], want[lo:hi])
                             for got, want in zip((Msc, Psc, Rsc), ref)))
        if err > REST_METRIC_RTOL:
            raise AssertionError(f"rank {rank} sc metric mesh {m}: {err} > {REST_METRIC_RTOL}")
        out["aa_sc", m] = dict(sc_err=err)
        del blk, xr, Msc, Psc, Rsc
    del xa
    torch.cuda.empty_cache()

    mag, _ = zc_cfar_case(dev)
    cfar = dict(ZC_CFAR, hysteresis=ZC_EVENTS["hysteresis"], max_events=ZC_EVENTS["max_events"])
    for m, mesh in meshes.items():
        mb = seq_block(mag[None], mesh, mag.shape[-1] // mesh.n_seq)[0]
        t = run(("zc_cfar", m), lambda: SH.sharded_zc_cfar_detect(mb, mesh, **cfar))
        out["zc_cfar", m] = (mesh.data, table_arrays(t))
    del mag, mb
    torch.cuda.empty_cache()

    x, _, _, _ = zc_case(dev)
    ref = pss_template(2048)[0]
    for m, mesh in meshes.items():
        blk = seq_block(x, mesh, x.shape[-1] // mesh.n_seq)
        for route in ZC_ROUTES:  # kernel E, then the FFT convolution as its witness
            with contextlib.ExitStack() as stack:
                if route == "fft":
                    stack.enter_context(mock.patch.object(SH, "zc_matched_filter",
                                                          SH.fft_matched_filter))
                t = run(("zc", m, route), lambda: SH.sharded_zc_detect(
                    blk, mesh, reference=ref, **cfar))
            out["zc", m, route] = (mesh.data, table_arrays(t))
            torch.cuda.empty_cache()
        del blk
    return dict(out=out, counts=counts)


#: sharded_zc_detect's matched filter in phase 18(a): kernel E (its route
#: for this template), and the torch FFT convolution put in its place
ZC_ROUTES = ("kernel_e", "fft")


#: ZC detect from IQ: peak values within this fraction of the largest peak
#: of the one-shot table (as phase 12 holds E -> D -> B to its plain version)
ZC_IQ_PEAK_RTOL = 1e-4


def zc_iq_events(arrays, ref, lo: int, what: str, knife) -> int:
    """`rank_events` for the ZC detect from IQ, whose magnitudes differ
    from the one-shot ones by each shard's FFT roundoff: events compared
    without their peak values (an event may differ only where its gate
    holds a knife-edge sample), then the peak values of the streams not so
    excused within ZC_IQ_PEAK_RTOL.  Returns the streams excused."""
    have_t = host_table(arrays)
    n, h = have_t.count.shape[0], ZC_EVENTS["hysteresis"]
    strip = lambda evs: [e[:3] + (None,) + e[4:] for e in evs]  # noqa: E731
    kn = {b - lo: v for b, v in knife.items() if lo <= b < lo + n}
    excused = compare_events([strip(table_events(have_t, b)) for b in range(n)],
                             [strip(table_events(ref, lo + b)) for b in range(n)], h, what, kn)
    keep = [b for b in range(n) if b not in excused]
    got, want = have_t.peak_value[keep], ref.peak_value[lo: lo + n][keep]
    tol = ZC_IQ_PEAK_RTOL * float(ref.peak_value.abs().max())
    if keep and float((got - want).abs().max()) > tol:
        raise AssertionError(f"{what}: peak values differ by more than {tol}")
    return len(excused)


def zc_iq_knife(mag) -> dict:
    """Stream -> sorted indices where the one-shot magnitudes' CFAR
    decision sits within ZC_IQ_KNIFE_RTOL of flipping (`ZC_IQ_KNIFE_RTOL`)."""
    W = ZC_CFAR["corr_window"]
    e_s = running_sum_stream(mag, W) * float(ZC_CFAR["threshold_value"])
    margin = (mag * float(1 << ZC_CFAR["threshold_frac_bits"]) - e_s).abs()
    floor = ZC_CFAR["min_corr_mag"]
    edge = (margin <= ZC_IQ_KNIFE_RTOL * e_s.abs()) | (
        (mag - floor).abs() <= ZC_IQ_KNIFE_RTOL * floor)
    edge[:, :W] = False
    b, idx = (t.cpu().numpy() for t in edge.nonzero(as_tuple=True))
    return {int(s): idx[b == s] for s in np.unique(b)}


def rest_timings(dev, card: str) -> dict:
    """Phase 18(b): mesh (1, 1) over NCCL in this process, each sharded
    function against the one-shot kernels at the same shape, and its parts
    (halo, kernel, fix-up or priming, merge) timed alone; CUDA events
    (`cuda_ms`), profiler in brackets (`kernel_ms`) for the whole calls."""
    B, L, Q, h = HEADLINE["batch"], HEADLINE["L"], HEADLINE["Q"], HYST
    metric = dict(quarter_len=Q, **KW)
    res = {}
    with BENCH.mesh11(dev) as mesh:
        zero = torch.zeros(B, device=dev)

        def timed(name, sharded, one_shot):
            res[name] = dict(ms=cuda_ms(sharded), one_shot_ms=cuda_ms(one_shot),
                             kernel_ms=kernel_ms(sharded), one_shot_kernel_ms=kernel_ms(one_shot))

        # items 3 and 5: the Minn-RTL metric with the blocked IIR, the detect
        x32, _ = minn_stimulus(B, L, Q, dev, events=shard_events(L, B))
        timed("minn_metric", lambda: SH.sharded_minn_rtl_planar(x32, mesh, **metric),
              lambda: F.minn_rtl_metric_planar_fused(x32, **metric))
        halo = SH._left_halo(x32, 3 * Q, mesh)
        primed = lambda: F.minn_rtl_metric_planar_fused(  # noqa: E731
            x32, **metric, base_index=0, hist_init=halo, carry_init=zero)
        st = primed()
        corr, above = st.corr_positive, SH.minn_fixup(st, 0, mesh, **KW)[1]
        res["minn_metric"].update(
            halo_ms=cuda_ms(lambda: SH._left_halo(x32, 3 * Q, mesh)), kernel_part_ms=cuda_ms(primed),
            fixup_ms=cuda_ms(lambda: SH.minn_fixup(st, 0, mesh, **KW)),
            kernel_part_bound=bound(*a_work(B, L, 4, 4, 13, hist_len=3 * Q)))
        timed("minn_detect", lambda: SH.sharded_minn_rtl_detect(x32, mesh, **metric, hysteresis=h),
              lambda: F.minn_rtl_detect_fused(x32, **metric, hysteresis=h))
        res["minn_detect"]["merge_ms"] = cuda_ms(lambda: SH.cross_shard_event_merge(
            above, corr, 0, mesh, h=h, E=8, n=L, tie_last=True, emit_unclosed=False))
        del x32, halo, st, corr, above
        torch.cuda.empty_cache()

        # item 6: the [A][A] metric
        xa, _ = aa_case(dev)
        lag = AA_HEADLINE["lag"]
        timed("aa_metric", lambda: SH.sharded_aa_metric(xa, mesh, lag),
              lambda: AF.aa_metric(xa, half_len=lag))
        halo = SH._left_halo(xa, 2 * lag, mesh)
        o = AF.aa_metric(xa, half_len=lag, base_index=0, hist_init=halo)
        res["aa_metric"].update(
            halo_ms=cuda_ms(lambda: SH._left_halo(xa, 2 * lag, mesh)),
            kernel_part_ms=cuda_ms(lambda: AF.aa_metric(xa, half_len=lag, base_index=0,
                                                        hist_init=halo)),
            m_ms=cuda_ms(lambda: SP._aa_normalized(o.P_re * o.P_re + o.P_im * o.P_im, o.R,
                                                   lag)),
            kernel_part_bound=bound(*c_work(B, xa.shape[-1], 4, 4, 12, hist_len=2 * lag)))
        del xa, halo, o
        torch.cuda.empty_cache()

        # item 8: the ZC CFAR detect
        mag, _ = zc_cfar_case(dev)
        W, hz = ZC_CFAR["corr_window"], ZC_EVENTS["hysteresis"]
        cfar = dict(ZC_CFAR, hysteresis=hz, max_events=ZC_EVENTS["max_events"])
        timed("zc_cfar", lambda: SH.sharded_zc_cfar_detect(mag, mesh, **cfar),
              lambda: ZF.zc_cfar_detect(mag, **cfar))
        halo = SH._left_halo(mag, W + hz, mesh)

        def prime():
            tail = SP.cfar_gate(halo, **ZC_CFAR, base_index=-W - hz)[0][:, -hz:]
            return SH._gate_from_tail(tail, 0, hz)

        gate = prime()
        kern = lambda: ZF.zc_cfar_detect(  # noqa: E731
            mag, **cfar, base_index=0, stream_len_global=mag.shape[-1],
            shard_init=(halo[:, hz:], gate))
        t = kern()
        res["zc_cfar"].update(
            halo_ms=cuda_ms(lambda: SH._left_halo(mag, W + hz, mesh)), prime_ms=cuda_ms(prime),
            kernel_part_ms=cuda_ms(kern), merge_ms=cuda_ms(lambda: SH.merge_shard_event_tables(
                t, mesh, h=hz, E=ZC_EVENTS["max_events"], tie_last=False, emit_unclosed=True)),
            d_bound=bound(*d_mag_work(*mag.shape, hist_len=W)))
        del mag, halo, gate, t
        torch.cuda.empty_cache()

        # item 9: the ZC detect from IQ (kernel E), against E -> D -> B one-shot
        x, taps, _, zkw = zc_case(dev)
        ref, _, ref_norm = pss_template(2048)
        R = len(ref)
        timed("zc_detect", lambda: SH.sharded_zc_detect(x, mesh, reference=ref, **cfar),
              lambda: ZF.zc_iq_cfar_detect(MF.matched_filter_ols(x, taps), x, **zkw))
        kernel = torch.as_tensor(ref).flip(-1).conj()
        H = W + R - 1
        halo = SH._left_halo(x, H, mesh)
        ext = torch.cat([halo, x], dim=-1)
        mf = SH.zc_matched_filter(ext, kernel)
        d_part = lambda: ZF.zc_metric(  # noqa: E731
            mf[..., H:].contiguous(), x, ref_len=R, ref_norm=ref_norm, **ZC_CFAR, base_index=0,
            hist_init=(mf[..., :H], halo), hysteresis=hz)
        o = d_part()
        res["zc_detect"].update(
            halo_ms=cuda_ms(lambda: torch.cat([SH._left_halo(x, H, mesh), x], dim=-1)),
            e_ms=cuda_ms(lambda: SH.zc_matched_filter(ext, kernel)),
            d_ms=cuda_ms(d_part),
            merge_ms=cuda_ms(lambda: SH.cross_shard_event_merge(
                o.above, o.mag, 0, mesh, h=hz, E=ZC_EVENTS["max_events"], n=x.shape[-1],
                tie_last=False, emit_unclosed=True)),
            e_bound=bound(*e_work(ext, R, ext.shape[-1])),
            d_bound=bound(*d_iq_work(x.shape[1], x.shape[-1], x.shape[-1], x.shape[0], 4,
                                     hist_len=H)))
        del x, ext, mf, halo, o
        torch.cuda.empty_cache()
    for name, r in res.items():
        parts = ", ".join(f"{k[:-3]} {v:.3f}" for k, v in r.items()
                          if k.endswith("_ms") and k not in ("ms", "one_shot_ms", "kernel_ms",
                                                             "one_shot_kernel_ms"))
        bounds = {k: f"{v[0]:.4f} {v[1]}" for k, v in r.items() if k.endswith("bound")}
        log(f"  (b) {name}: sharded {r['ms']:.3f} ms [{r['kernel_ms']}] vs one-shot "
            f"{r['one_shot_ms']:.3f} ms [{r['one_shot_kernel_ms']}]; parts (ms): {parts}; "
            f"bounds (ms) {bounds}; card {card}")
    return res


def phase_rest(dev, card: str) -> dict:
    """Phase 18: the rest of the sharded layer.  (a) SHARD_RANKS gloo ranks
    sharing the card on meshes (1, 4) and (2, 2): the Minn-RTL metric with
    the blocked IIR, the [A][A] and S&C metrics (held to the one-shot
    kernels in each rank), the Minn-RTL detect with the per-sample merge,
    the ZC CFAR detect and the ZC detect from IQ (kernel E and the FFT
    convolution), each rank's table against the one-shot kernels' table
    here; then `dryrun_multichip(4)`.  (b) mesh (1, 1) over NCCL, timed
    (`rest_timings`)."""
    B, L, Q, h = HEADLINE["batch"], HEADLINE["L"], HEADLINE["Q"], HYST
    log(f"== phase 18: the rest of the sharded layer: {SHARD_RANKS} gloo ranks, meshes "
        f"{SHARD_MESHES}")
    t0 = time.perf_counter()
    metric = dict(quarter_len=Q, **KW)
    res = {}

    # the one-shot references on the card
    x32, _ = minn_stimulus(B, L, Q, dev, events=shard_events(L, B))
    knife = minn_knife(F.minn_rtl_metric_planar_fused(x32, **metric), 3 * Q - 1)
    ref_minn = cpu_table(F.minn_rtl_detect_fused(x32, **metric, hysteresis=h))
    del x32
    mag, cfar_events = zc_cfar_case(dev)
    ref_cfar = cpu_table(ZF.zc_cfar_detect(mag, **ZC_CFAR))
    check_zc_found(ref_cfar, [(b, p) for b, p in cfar_events], 1, "phase 18 zc cfar one-shot")
    del mag
    x, taps, zc_events, zkw = zc_case(dev)
    n, R = x.shape[-1], len(pss_template(2048)[0])
    zmag = ZF.zc_metric(MF.matched_filter_ols(x, taps), x, **{
        k: zkw[k] for k in ("ref_len", "ref_norm", *ZC_CFAR)}).mag[:, :n].contiguous()
    del x
    ref_zc = cpu_table(ZF.zc_cfar_detect(zmag, **ZC_CFAR))
    zknife = zc_iq_knife(zmag)
    del zmag
    torch.cuda.empty_cache()
    check_zc_found(ref_zc, zc_events, R, "phase 18 zc one-shot")
    t_ref = time.perf_counter() - t0

    # (a) the ranks
    ranks = DI.run_ranks(rest_rank, SHARD_RANKS, backend="gloo", timeout_s=600)
    t_ranks = time.perf_counter() - t0 - t_ref
    knives, modes = collections.Counter(), collections.Counter()
    need_of = {"minn_metric": ("minn_rtl_metric/full", "minn_rtl_metric/primed"),
               "minn_detect": ("minn_rtl_metric/full", "minn_rtl_metric/primed"),
               "aa": ("aa_metric/primed",), "sc": (),
               "zc_cfar": ("zc_metric/primed", "gate_events/primed"),
               "zc": ("zc_metric/primed_iq",)}
    metric_errs = collections.defaultdict(float)
    for r, rk in enumerate(ranks):
        out = rk["out"]
        for key, c in rk["counts"].items():
            what = f"rank {r} {key}"
            need(c, what, *need_of[key[0]],
                 *(("matched_filter_ols",) if key[-1] == "kernel_e" else ()))
            if key[-1] == "fft" and c.get("matched_filter_ols"):
                raise AssertionError(f"{what}: kernel E ran on the FFT route")
            modes.update({k: v for k, v in c.items() if "/" in k or k == "matched_filter_ols"})
        for m in SHARD_MESHES:
            bb = B // m[0]
            knives["minn_metric_bits"] += out["minn_metric", m]["knife_bits"]
            metric_errs["smooth"] = max(metric_errs["smooth"], out["minn_metric", m]["smooth_err"])
            metric_errs["sc"] = max(metric_errs["sc"], out["aa_sc", m]["sc_err"])
            d, arrays = out["minn_detect", m]
            knives["minn_detect"] += rank_events(arrays, ref_minn, d * bb, h,
                                                 f"rank {r} minn detect mesh {m}", knife)
            d, arrays = out["zc_cfar", m]
            rank_events(arrays, ref_cfar, d * bb, ZC_EVENTS["hysteresis"],
                        f"rank {r} zc cfar mesh {m}")
            tables = {}
            for route in ZC_ROUTES:
                d, arrays = out["zc", m, route]
                tables[route] = arrays
                knives[f"zc_{route}"] += zc_iq_events(arrays, ref_zc, d * bb,
                                                      f"rank {r} zc {route} mesh {m}", zknife)
            knives["zc_kernel_e_vs_fft"] += zc_iq_events(
                tables["kernel_e"], host_table(tables["fft"]), 0,
                f"rank {r} zc kernel E vs FFT mesh {m}",
                {b - d * bb: v for b, v in zknife.items() if d * bb <= b < (d + 1) * bb})
    line = DR.dryrun_multichip(SHARD_RANKS, device=dev)
    t_dry = time.perf_counter() - t0 - t_ref - t_ranks
    res.update(knife=dict(knives), metric_errs=dict(metric_errs), modes=dict(modes),
               events=dict(minn=int(ref_minn.count.sum()), zc_cfar=int(ref_cfar.count.sum()),
                           zc=int(ref_zc.count.sum())), dryrun=line, ref_s=t_ref, ranks_s=t_ranks,
               dryrun_s=t_dry)
    log(f"  (a) {SHARD_RANKS} ranks x meshes {SHARD_MESHES}: Minn metric == kernel A's full "
        f"mode one-shot (corr, energy equal; smooth within {metric_errs['smooth']:.3g}), [A][A] "
        f"metric == kernel C's (P, R, M equal), S&C within {metric_errs['sc']:.3g} of the plain "
        f"metric; Minn detect, ZC CFAR, ZC from IQ (E and FFT) tables == one-shot "
        f"({res['events']} events one-shot; knife-edge bits / streams {dict(knives)}); launches "
        f"by mode {dict(modes)}; references {t_ref:.1f} s, ranks {t_ranks:.1f} s, dry run "
        f"{t_dry:.1f} s")
    res["timings"] = rest_timings(dev, card)
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 18: {res['seconds']:.1f} s; card {card}")
    return res


# ---------------------------------------------------------------------------
# phase 19: the port's two benches, run as a user runs them
# ---------------------------------------------------------------------------

#: where phase 19 has the benches write their result lines
BENCH_DIR = os.path.join(ROOT, "bench_out")
BENCH_TIMEOUT_S = 600


def run_bench(module: list[str], name: str) -> dict:
    """``python -m <module> --out bench_out/<name>.json`` from the
    checkout's root in a process of its own: exit code 0, and the last line
    of its standard output, parsed, equal to the file it wrote."""
    os.makedirs(BENCH_DIR, exist_ok=True)
    path = os.path.join(BENCH_DIR, f"{name}.json")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", *module, "--out", path], cwd=ROOT,
                       capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    for line in p.stderr.splitlines():
        log(f"  | {line}")
    if p.returncode != 0:
        raise AssertionError(f"{' '.join(module)} exited {p.returncode}")
    line = json.loads(p.stdout.strip().splitlines()[-1])
    with open(path) as f:
        if json.load(f) != line:
            raise AssertionError(f"{path} differs from the printed line")
    log(f"  {' '.join(module)}: {time.perf_counter() - t0:.1f} s, line in {path}")
    return line


def positive(value, what: str) -> None:
    if not (isinstance(value, (int, float)) and value > 0 and np.isfinite(value)):
        raise AssertionError(f"{what}: {value!r} is not a positive number")


def phase_benches(card: str) -> dict:
    """Phase 19: `python -m ofdm_sync_tpu_torch bench` and
    `python -m ofdm_sync_tpu_torch.bench_scaling`, each in a process of its
    own; their lines checked: every on-card check "ok", the card named,
    every headline, latency and secondary figure and every bound and share
    a positive number, the fused step's launches kernel F's alone; (a)'s and (b)'s tables equal, (b)'s counts as coded
    and repeated, the int16 wire bit-identical, (d) holding."""
    log("== phase 19: the benches, as a user runs them")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    b = run_bench(["ofdm_sync_tpu_torch", "bench"], "bench_torch")
    bad = {k: v for k, v in b["checks"].items() if v != "ok"}
    if not (b["checked"] and b["check_ok"]) or bad or len(b["checks"]) != 5:
        raise AssertionError(f"bench: on-card checks {b['checks']}")
    if b["device"]["name"] != kind or b["device"]["nvidia_smi"] != card:
        raise AssertionError(f"bench: device {b['device']} is not {kind} ({card})")
    if "vs_baseline" in b:
        raise AssertionError("bench: a vs_baseline key")
    positive(b["value"], "bench value")
    h = b["headline"]
    for key in ("median_ms", "p90_ms", "n", "int16_samples_per_sec"):
        positive(h[key], f"bench headline {key}")
    for name in ("f32", "int16", "full_metric", "corr_energy"):
        for key in ("median_ms", "p90_ms", "per_s", "bound_ms", "share"):
            positive(h[name][key], f"bench headline {name} {key}")
    for name in ("fused", "composed", "plain"):
        for key in ("p50_us", "p90_us", "marginal_us", "enqueue_p50_us"):
            positive(b["latency"][name][key], f"bench latency {name} {key}")
    if set(b["latency"]["fused"]["launches"]) != {"minn_rtl_step"}:
        raise AssertionError(f"bench: the fused step launched {b['latency']['fused']['launches']}")
    for name, r in b["secondary"].items():
        for key in ("median_ms", "p90_ms", "per_s", "bound_ms", "share"):
            positive(r[key], f"bench secondary {name} {key}")
    if len(b["kernels"]) != 10:
        raise AssertionError(f"bench: {len(b['kernels'])} kernel rows, not 10")
    for row in b["kernels"]:
        for path, r in row["timed"].items():
            positive(r["share"], f"bench kernels {row['tpu_kernel']} {path} share")
            if not r["launches"]:
                raise AssertionError(f"bench: {row['tpu_kernel']} {path} launched no kernel")
    s = run_bench(["ofdm_sync_tpu_torch.bench_scaling"], "scaling_torch")
    ranks = s["cpu_ranks"]
    if not (s["ok"] and s["card"]["tables_equal"] and ranks["holds"]
            and ranks["int16_wire_bit_identical"] and s["structure"]["holds"]
            and s["structure"]["kernel_a_launched_before_wait"] is True):
        raise AssertionError(f"bench_scaling: ok {s['ok']}, (b) {ranks['meshes']}, (d) "
                             f"{s['structure']}")
    if s["device"]["name"] != kind or not s["cross_card"].startswith("not measured"):
        raise AssertionError(f"bench_scaling: device {s['device']}, cross_card {s['cross_card']}")
    for key in ("sharded_overhead_ratio", "sharded_overlap_overhead_ratio",
                "one_shot_samples_per_sec"):
        positive(s["card"][key], f"bench_scaling (a) {key}")
    res = {"bench": {"value": b["value"], "headline_median_ms": h["median_ms"],
                     "fused_p50_us": b["latency"]["fused"]["p50_us"],
                     "composed_p50_us": b["latency"]["composed"]["p50_us"]},
           "scaling": {"overhead_ratio": s["card"]["sharded_overhead_ratio"],
                       "weak_seq_8card_nvlink_f32":
                           s["projection"]["halo_f32"]["weak_seq_8card_nvlink"]},
           "seconds": time.perf_counter() - t0}
    log(f"  phase 19: {res}; card {card}")
    return res


def library_conv_ms(x, taps, y_kernel) -> tuple[float, float]:
    """Kernel E's function as one PyTorch call, `conv1d` (cuDNN, TF32 off):
    the complex full convolution of each plane pair with the taps as a
    2-in / 2-out real convolution.  Returns (ms, max |conv - kernel E| over
    the kernel's peak)."""
    C, batch, L = x.shape
    T = taps.shape[-1]
    hr, hi = taps[0].flip(-1), taps[1].flip(-1)
    w = torch.stack([torch.stack([hr, -hi]), torch.stack([hi, hr])])  # (out 2, in 2, T)
    xin = x.reshape(C // 2, 2, batch, L).permute(0, 2, 1, 3).reshape(-1, 2, L)
    torch.backends.cudnn.allow_tf32 = False
    conv = lambda: torch.nn.functional.conv1d(xin, w, padding=T - 1)  # noqa: E731
    y = conv().reshape(C // 2, batch, 2, L + T - 1).permute(0, 2, 1, 3).reshape(C, batch, -1)
    err = float((y - y_kernel).abs().max()) / float(y_kernel.abs().max())
    del y
    return cuda_ms(conv, reps=3), err


def sass_mix(lib, name: str) -> dict | None:
    """Instruction counts of one kernel's SASS, disassembled by the
    toolkit's cuobjdump: in total, FP32 (FADD / FFMA / FMUL), FP64, IMAD,
    type conversions, shared and global memory, shuffles, barriers and
    local (spill) memory.  Static counts: each instruction of the kernel's
    code once, whichever branch runs.  None where the toolkit has no
    cuobjdump or the library no such kernel."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
    except (FileNotFoundError, subprocess.CalledProcessError) as e:
        log(f"  cuobjdump: {e}")
        return None
    ops, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = name in line
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            ops.append(m.group(1))
    if not ops:
        return None
    groups = {"fp32": ("FADD", "FFMA", "FMUL"), "fp64": ("DADD", "DFMA", "DMUL"),
              "imad": ("IMAD",), "cvt": ("I2F", "I2FP", "F2F", "F2FP", "F2I", "F2IP"),
              "shared": ("LDS", "STS"), "global": ("LDG", "STG"), "shfl": ("SHFL",),
              "bar": ("BAR",), "local": ("LDL", "STL")}
    return {"total": len(ops), **{k: sum(op in v for op in ops) for k, v in groups.items()}}


#: kernel A's instantiations at up to two branches, by their mangled names:
#: the exact int16 path, the float path on int16 (with a history) and on float32
A_KERNELS = {"int16 exact": "minn_rtl_metric_kernelIsLi4ELb1E",
             "int16 float path": "minn_rtl_metric_kernelIsLi4ELb0E",
             "float32": "minn_rtl_metric_kernelIfLi4ELb0E"}


#: kernel C's instantiations at up to two branches: the exact int16 path,
#: the float path on int16 (with a history, or more than two branches) and
#: on float32
C_KERNELS = {"int16 exact": "aa_metric_exact_kernel",
             "int16 float path": "aa_metric_kernelIsLi4E",
             "float32": "aa_metric_kernelIfLi4E"}


#: kernels G and H: G's instantiations on the frame cell's codes and on
#: float32 at two branches, and H
RX_KERNELS = {"front int16": "minn_rx_front_kernelIsLi4E",
              "front float32": "minn_rx_front_kernelIfLi4E", "back": "minn_rx_back_kernel"}


def sass_mixes(lib, kernels: dict) -> dict:
    """`sass_mix` of each instantiation in ``kernels`` (`A_KERNELS`,
    `C_KERNELS`)."""
    return {kind: sass_mix(lib, name) for kind, name in kernels.items()}


def main() -> int:
    t_start = time.perf_counter()
    log("== phase 1: device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke run needs a GPU")
    dev = card_device()
    card = card_line()
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    log("== phase 2: build")
    info = build.build()
    build.library()
    log(f"  built {info.path.name} in {info.seconds:.1f} s")
    spills = []
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and (int(m.group(1)) or int(m.group(2))):
            spills.append(line.strip())
    if spills:
        raise AssertionError(f"a kernel spills registers: {spills}")
    missing = [name for name in (*A_KERNELS.values(), *C_KERNELS.values(),
                                 *(RX_KERNELS.values() if RK is not None else ()))
               if name not in info.log]
    if info.log and missing:
        raise AssertionError(f"ptxas reported no registers for {missing}")
    e_sass = sass_mix(info.path, "mf_ols_kernel")
    log(f"  kernel E's SASS instructions (a thread, a block): {e_sass}")
    a_sass = sass_mixes(info.path, A_KERNELS)
    log(f"  kernel A's SASS instructions (static, a thread): {a_sass}")
    c_sass = sass_mixes(info.path, C_KERNELS)
    log(f"  kernel C's SASS instructions (static, a thread): {c_sass}")
    if any(launch_counts().values()):
        raise AssertionError(f"launch counters do not start at 0: {launch_counts()}")
    if TIMING:
        log(f"== timing the kernels of {TREE}")
        out = {"tree": TREE, "e_sass": e_sass, "a_sass": a_sass, "c_sass": c_sass,
               "headline": phase_headline(dev, card),
               "long": phase_long(dev, card),
               "receive": timing_receive(dev, card),
               "aa_headline": timing_aa(dev, card), "zc_headline": timing_zc(dev, card),
               "mf": timing_e(dev, card), "stream_kernels": phase_stream_kernels(dev, card)["res"],
               "latency": phase_latency(dev, card)}
        print(json.dumps(out))
        print(card)
        return 0

    k = phase_kernels(dev)
    counts = phase_slice(dev)
    receive = phase_receive(dev)
    receive["timing"] = timing_receive(dev, card)
    head = phase_headline(dev, card)
    long = phase_long(dev, card)
    aa_k = phase_aa_kernels(dev)
    aa_chain = phase_aa_chain(dev)
    aa_sweep = phase_aa_sweep(dev)
    aa_grid = phase_aa_grid(dev, card)
    aa_head = phase_aa_headline(dev, card)
    zc_k = phase_zc_kernels(dev)
    zc_chain = phase_zc_chain(dev)
    zc_head = phase_zc_headline(dev, card)
    sk = phase_stream_kernels(dev, card)
    streams = phase_streams(dev, card)
    lat = phase_latency(dev, card)
    fam = phase_families(dev, card)
    shards = phase_shards(dev, card)
    rest = phase_rest(dev, card)
    benches = phase_benches(card)
    h32 = head["f32"]
    aa_launches = {name: aa_chain["counts"][name] + aa_sweep["counts"][name]
                   + aa_grid["counts"][name] for name in counts}
    zc_launches = zc_chain["counts"]
    # the stream phases' mode counts, and phase 16's launches of A and B
    modes = (collections.Counter(streams["modes"]) + collections.Counter(fam["modes"])
             + collections.Counter(rest["modes"]))
    B, L = HEADLINE["batch"], HEADLINE["L"]
    n, Bm = ZC_HEADLINE["n"], ZC_HEADLINE["mf_batch"]
    src = "ofdm_sync_tpu_torch/kernels/csrc/"
    # name, source, replaces, launches, max_abs_err, ms, plain_ms, (bytes, flops), library
    rows = [
        ("minn_rtl_metric", "minn_rtl_metric.cu", "ofdm_sync_tpu/kernels/pallas_minn_tm.py:60",
         counts["minn_rtl_metric"] + fam["modes"].get("minn_rtl_metric/corr_above", 0),
         k["corr_err"], h32["a_ms"], h32["plain_a_ms"], a_work(B, L, 4, 4, 5), None),
        ("minn_rtl_metric[full]", "minn_rtl_metric.cu", "ofdm_sync_tpu/kernels/pallas_minn.py:240",
         modes.get("minn_rtl_metric/full", 0), sk["errs"]["full"], sk["res"]["full_f32_ms"],
         sk["res"]["plain_full_ms"], a_work(B, L, 4, 4, 13), None),
        ("minn_rtl_metric[corr_energy]", "minn_rtl_metric.cu",
         "ofdm_sync_tpu/kernels/pallas_minn.py:113", modes.get("minn_rtl_metric/corr_energy", 0),
         sk["errs"]["corr_energy"], sk["res"]["corr_energy_f32_ms"],
         sk["res"]["plain_corr_energy_ms"], a_work(B, L, 4, 4, 8, scan=False), None),
        ("minn_rtl_metric[strided]", "minn_rtl_metric.cu",
         "ofdm_sync_tpu/kernels/pallas_minn_tm.py:269", shards["strided_launches"],
         shards["strided_err"], shards["view_ms"], shards["plain_view_ms"], shards["view_work"],
         None),
        ("minn_rtl_metric[primed]", "minn_rtl_metric.cu",
         "ofdm_sync_tpu/kernels/pallas_minn.py:403", modes.get("minn_rtl_metric/primed", 0),
         max(sk["errs"]["primed_a"], lat["a_primed_err"]), lat["a_primed_ms"],
         lat["plain_a_primed_ms"], lat["a_primed_work"], None),
        ("minn_rtl_step", "minn_rtl_step.cu", "ofdm_sync_tpu/kernels/pallas_minn.py:403",
         streams["minn_step_launches"] + lat["stream16_launches"]["minn_rtl_step"],
         max(sk["errs"]["step"], lat["f_err"]), lat["f_step"]["f_ms"], lat["plain_f_ms"],
         lat["f_step"]["work"], None),
        ("gate_events", "gate_events.cu", "ofdm_sync_tpu/kernels/pallas_minn_tm.py:60",
         counts["gate_events"] + fam["gate_events"], 0.0, h32["b_ms"], h32["plain_b_ms"],
         b_work(torch.empty((B, L), dtype=torch.bool, device="meta"), h32["b_gated"]), None),
        ("gate_events[primed]", "gate_events.cu",
         "ofdm_sync_tpu/kernels/pallas_minn.py:403, ofdm_sync_tpu/kernels/pallas_aa.py:221, "
         "ofdm_sync_tpu/kernels/pallas_zc.py:35", modes.get("gate_events/primed", 0), 0.0,
         lat["b_primed_ms"], lat["plain_b_primed_ms"], lat["b_primed_work"], None),
        ("gate_events[capture]", "gate_events.cu", "ofdm_sync_tpu/kernels/pallas_aa.py:221",
         aa_launches["gate_events"], 0.0, aa_head["b_ms"], aa_head["plain_b_ms"],
         aa_head["b_capture_work"], None),
        ("aa_metric", "aa_metric.cu",
         "ofdm_sync_tpu/kernels/pallas_aa.py:71, ofdm_sync_tpu/kernels/pallas_aa.py:221",
         aa_launches["aa_metric"], aa_k["max_err"], aa_head["c_ms"], aa_head["plain_c_ms"],
         c_work(B, AA_HEADLINE["n"], 4, 4, 17), None),
        ("aa_metric[gate_input]", "aa_metric.cu", "ofdm_sync_tpu/kernels/pallas_aa.py:221",
         aa_head["lean"]["float_launches"], aa_head["lean"]["c_float_err"],
         aa_head["lean"]["c_float_ms"], aa_head["lean"]["plain_c_ms"],
         c_work(B, AA_HEADLINE["n"], 4, 2, 5), None),
        ("aa_metric[gate_input exact_i16]", "aa_metric.cu",
         "ofdm_sync_tpu/kernels/pallas_aa.py:221",
         aa_head["lean"]["exact_launches"], aa_head["lean"]["c_err"],
         aa_head["lean"]["c_ms"], aa_head["lean"]["plain_c_ms"],
         c_work(B, AA_HEADLINE["n"], 4, 2, 5), None),
        ("aa_peak_capture", "aa_metric.cu", "ofdm_sync_tpu/kernels/pallas_aa.py:221",
         aa_launches["aa_peak_capture"] + aa_head["lean"]["capture_launches"],
         aa_head["lean"]["cap_err"], aa_head["lean"]["cap_ms"], aa_head["lean"]["plain_cap_ms"],
         aa_head["lean"]["cap_work"], None),
        ("aa_metric[primed]", "aa_metric.cu",
         "ofdm_sync_tpu/kernels/pallas_aa.py:221, ofdm_sync_tpu/kernels/pallas_aa.py:71",
         modes.get("aa_metric/primed", 0), sk["errs"]["primed_c"], lat["c_primed_ms"],
         lat["plain_c_primed_ms"], lat["c_primed_work"], None),
        ("zc_metric", "zc_cfar.cu",
         "ofdm_sync_tpu/kernels/pallas_zc.py:35, ofdm_sync_tpu/kernels/pallas_zc.py:156, "
         "ofdm_sync_tpu/kernels/pallas_zc_tm.py:78", zc_launches["zc_metric"], zc_k["mag_err"],
         zc_head["d_iq_f32_ms"], zc_head["plain_d_iq_ms"],
         d_iq_work(ZC_HEADLINE["batch"], n + 2047, n, 4, 4), None),
        ("zc_metric[primed magnitude]", "zc_cfar.cu", "ofdm_sync_tpu/kernels/pallas_zc.py:35",
         modes.get("zc_metric/primed", 0), 0.0, lat["d_primed_ms"], lat["plain_d_primed_ms"],
         lat["d_primed_work"], None),
        ("zc_metric[primed IQ]", "zc_cfar.cu", "ofdm_sync_tpu/kernels/pallas_zc_tm.py:78",
         zc_head["shard_launches"] + rest["modes"].get("zc_metric/primed_iq", 0),
         zc_head["shard_mag_err"], zc_head["shard_d_ms"],
         zc_head["plain_shard_d_ms"], zc_head["shard_work"], None),
        ("minn_rx_front", "minn_rx_front.cu", "none (the receive's plain body before its FFT)",
         receive["timing"]["launches"]["minn_rx_front"], receive["timing"]["gaps"]["cfo_hz"],
         receive["timing"]["front_ms"], None, receive["timing"]["front_work"], None),
        ("minn_rx_back", "minn_rx_back.cu", "none (the receive's plain body after its FFT)",
         receive["timing"]["launches"]["minn_rx_back"], receive["timing"]["gaps"]["eq"],
         receive["timing"]["back_ms"], None, receive["timing"]["back_work"], None),
        ("matched_filter_ols", "matched_filter.cu", "ofdm_sync_tpu/kernels/pallas_mf.py:137",
         zc_launches["matched_filter_ols"] + modes["matched_filter_ols"], zc_k["mf_err"],
         zc_head["e_ms"],
         zc_head["plain_e_ms"], zc_head["e_work"], zc_head["library_e_ms"]),
    ]
    # the bounds of the other cells of PERF.md's kernel table
    other_bounds = {
        "minn_rtl_metric int16": bound(*a_work(B, L, 4, 2, 5)),
        "minn_rtl_metric[full] int16": bound(*a_work(B, L, 4, 2, 13)),
        "aa_metric metric mode": bound(*c_work(B, AA_HEADLINE["n"], 4, 4, 12)),
        "aa_metric int16": bound(*c_work(B, AA_HEADLINE["n"], 4, 2, 17)),
        "aa_metric gate_input int16": bound(*c_work(B, AA_HEADLINE["n"], 4, 2, 5)),
        "zc_metric magnitude, CFAR cell": bound(*d_mag_work(ZC_HEADLINE["batch"], n)),
        "zc_metric IQ int16": bound(*d_iq_work(ZC_HEADLINE["batch"], n + 2047, n, 4, 2)),
    }
    kernels = []
    for name, source, replaces, launches, err, ms, plain_ms, work, library in rows:
        if launches < 1:
            raise AssertionError(f"{name} was not launched on its path")
        bound_ms, bound_by = bound(*work)
        kernels.append(dict(name=name, route="cuda", source=src + source, replaces=replaces,
                            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=library))
        if name == "aa_metric[gate_input exact_i16]":
            kernels[-1]["failed_tiles"] = aa_head["lean"]["failed_tiles"]
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"e_sass": e_sass, "a_sass": a_sass, "c_sass": c_sass, "headline": head,
                      "long": long,
                      "receive": receive,
                      "aa_headline": aa_head,
                      "aa_chain_ms": aa_chain["chain_ms"],
                      "aa_grid": {k: v for k, v in aa_grid.items() if k != "counts"},
                      "zc_headline": zc_head,
                      "stream_kernels": sk["res"], "streams": streams, "latency": lat,
                      "families": {k: fam[k] for k in ("simulations", "oracle", "timings")},
                      "shards": {k: v for k, v in shards.items() if k != "view_work"},
                      "rest": rest, "benches": benches,
                      "other_bounds_ms": other_bounds}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
