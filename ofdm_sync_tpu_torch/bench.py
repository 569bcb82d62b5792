"""Benchmark of the port on one card: the counterpart of the JAX package's
`bench.py`, at its shapes and settings.

    python -m ofdm_sync_tpu_torch bench [--seed N] [--out PATH]
    python -m ofdm_sync_tpu_torch.bench [--seed N] [--out PATH]

It runs on the card only and in this order:

1. the on-card checks (the counterparts of `conformance/onchip.py`'s five,
   at its shapes): each kernel family against its plain PyTorch version on
   the card, tables field by field; the sharded detect at mesh (1, 1) over
   NCCL against the one-shot kernels;
2. the headline: kernels A + B, the flagship Minn-RTL detect, on 512
   streams x 262,144 samples x 2 branches (planar float32, 2 GiB; then the
   same samples as int16 ADC codes), with kernel A's full-metric and
   corr/energy modes beside it and one torch.profiler window over its calls;
3. the block latency of the streaming receiver at batch 1 (4096-sample
   blocks): the fused step (kernel F), the same step composed of kernels A
   and B, and the plain step, each with its host enqueue time;
4. the secondary workloads of `bench.py`'s `_secondary_kernels`.

Every stimulus is drawn on the card from a `torch.Generator` seeded from
``--seed``, with preambles planted at known positions.  Each timed call is
warmed up, then run at least 100 times with one CUDA-event pair around
each call; it reports the median, the p90 and their count, the bound of
the kernels it launches (`utils.roofline`, the same work counts as
`chip_smoke.py`'s), the share bound / median, and the launches of each
kernel over the timed calls (`kernels.launches`).

The last line of standard output is one JSON object with `bench.py`'s keys
(``metric``, ``value``, ``unit``, ``checked``, ``check_ok``, ``checks``)
and ``device``, ``seed``, ``headline``, ``latency``, ``secondary`` and
``kernels``; ``--out`` writes the same object to a file.  It has no
``vs_baseline``: `bench.py`'s baseline is a Python loop timed on another
machine.  There is no fallback: without a card it exits non-zero before
any timing; a kernel that fails to build or launch raises; a failed check
prints the line with ``check_ok`` false and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ofdm_sync_tpu_torch.kernels import aa_fused as AF
from ofdm_sync_tpu_torch.kernels import matched_filter as MF
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F
from ofdm_sync_tpu_torch.kernels import streaming_chunked as ST
from ofdm_sync_tpu_torch.kernels import zc_fused as ZF
from ofdm_sync_tpu_torch.kernels.launches import (
    launch_counts,
    mode_launch_counts,
    reset_launch_counts,
)
from ofdm_sync_tpu_torch.kernels.streaming import (
    aa_detect_step,
    aa_metric_planar,
    minn_rtl_metric_planar,
    zc_iq_planar,
)
from ofdm_sync_tpu_torch.ops.channel import fft_convolve_full_ols
from ofdm_sync_tpu_torch.ops.detect import extract_gate_events, extract_gate_events_capture
from ofdm_sync_tpu_torch.ops.metrics import zc_freq_metric_sliding
from ofdm_sync_tpu_torch.ops.waveforms import centered_subcarrier_indices, generate_zadoff_chu
from ofdm_sync_tpu_torch.ops.windows import running_sum_stream
from ofdm_sync_tpu_torch.parallel import distributed as DI
from ofdm_sync_tpu_torch.parallel import shard as SH
from ofdm_sync_tpu_torch.testing import (
    aa_stimulus,
    assert_tables_equal,
    mag_stimulus,
    mf_reference,
    minn_stimulus,
    rel_err,
    zc_iq_stimulus,
)
from ofdm_sync_tpu_torch.utils.profiling import call_times, device_window, marginal_us, summary
from ofdm_sync_tpu_torch.utils.roofline import (
    a_work,
    b_work,
    bound_sum,
    c_work,
    d_iq_work,
    d_mag_work,
    e_work,
    f_work,
    gated_samples,
    sliding_dft_work,
)

# the flagship Minn-RTL configuration (bench.py:33-47)
Q = 512
BRANCHES = 2
MINN = dict(quarter_len=Q, smooth_shift=3, threshold_value=int(0.10 * (1 << 15)),
            threshold_frac_bits=15)
HYST = 2
DETECT = dict(MINN, hysteresis=HYST, max_events=8, tie="last", emit_unclosed=False)
HEADLINE = dict(batch=512, L=1 << 18)
#: timed calls of every workload, after WARMUP calls; the p90 of 100 has
#: ten samples beyond it
CALLS, WARMUP = 100, 3
#: the streaming receiver's blocks: a 30.72 Msps stream delivers one every
#: 133.3 us; p50 / p90 of BLOCK_STEPS synchronized steps, the marginal cost
#: between MARGINAL_STEPS
BLOCK, BLOCK_STEPS, MARGINAL_STEPS = 4096, 120, (128, 1152)
BLOCK_BUDGET_US = BLOCK / 30.72e6 * 1e6
# the secondary workloads (bench.py:450-675)
AA = dict(batch=512, n=1 << 18, half_len=512, threshold=0.15, hysteresis=128)
ZC = dict(batch=512, n=1 << 18, ref_len=2048, mf_batch=64)
ZC_CFAR = dict(corr_window=2048, threshold_value=64, threshold_frac_bits=15, min_corr_mag=0.3)
ZC_EVENTS = dict(hysteresis=256, max_events=16, valid_from=2048, tie="first", emit_unclosed=True)
ZC_FREQ = dict(offsets=1 << 15, bins=62, root=25, n_fft=2048, cp_len=512)
#: the on-card checks at `conformance/onchip.py`'s shapes (batch, L)
CHECKS = dict(minn_rtl=(128, 24576), zc_iq=(128, 16384), aa=(64, 16384), mf=(8, 65536),
              sharded=(128, 16384))
#: kernel A's corr_positive vs plain, relative to max(1, |plain|max)
CORR_RTOL = 2e-5
#: an above bit may differ only where the plain threshold margin is within
#: this fraction of the threshold's side (kernel A: the smoothing scans
#: round in another order; kernel D: the local sums start at other samples)
MINN_KNIFE_RTOL, ZC_KNIFE_RTOL = 1e-5, 1e-6
#: kernel E vs a complex128 FFT convolution, relative to the output peak
MF_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def zc_template(ref_len: int = ZC["ref_len"]):
    """`bench.py`'s ZC template (bench.py:548): the root-25 chirp of
    ``ref_len`` samples (complex128), the matched filter's planar taps
    (2, ref_len) float32 (the conjugate reversed) and the template's norm."""
    n = np.arange(ref_len)
    ref = np.exp(-1j * np.pi * 25 * n * (n + 1) / ref_len)
    taps = np.stack([ref.real[::-1], -ref.imag[::-1]]).astype(np.float32)
    return ref, taps, float(np.sqrt(np.sum(np.abs(ref) ** 2)))


# ---------------------------------------------------------------------------
# The checks: each kernel family against its plain version on the same
# inputs (the counterparts of conformance/onchip.py's check_*)
# ---------------------------------------------------------------------------

def _knife(diff, margin, side, rtol: float, what: str) -> int:
    """Differing above bits; raises unless each lies on the knife edge
    (margin within rtol of |side|)."""
    if not bool(diff.any()):
        return 0
    if bool((diff & ~(margin <= rtol * side.abs())).any()):
        raise AssertionError(f"{what}: above differs off the knife edge at "
                             f"{diff.nonzero()[:5].tolist()}")
    return int(diff.sum())


def _equal(out, ref, what: str) -> None:
    if out.shape != ref.shape or not torch.equal(out, ref):
        raise AssertionError(f"{what}: kernel differs from the plain version")


def check_minn_rtl(x):
    """Kernels A + B (`minn_rtl_detect_fused`) against the plain metric and
    `extract_gate_events` on x (4, batch, L): corr_positive within
    CORR_RTOL, above equal off the knife edge, tables equal field by field.
    Returns the kernels' table."""
    table = F.minn_rtl_detect_fused(x, **DETECT)
    corr, above = F.minn_rtl_metric(x, **MINN)
    st = minn_rtl_metric_planar(F._planar_view(x), **MINN)
    err = rel_err(corr, st.corr_positive)
    if err > CORR_RTOL:
        raise AssertionError(f"minn_rtl: corr_positive err {err} > {CORR_RTOL}")
    side = st.energy_total * float(MINN["threshold_value"])
    margin = (st.smooth_metric * float(1 << MINN["threshold_frac_bits"]) - side).abs()
    knife = _knife(above != st.above_threshold, margin, side, MINN_KNIFE_RTOL, "minn_rtl")
    ref = extract_gate_events(above if knife else st.above_threshold, st.corr_positive,
                              hysteresis=HYST, max_events=DETECT["max_events"],
                              valid_from=st.valid_from, tie=DETECT["tie"],
                              emit_unclosed=DETECT["emit_unclosed"])
    assert_tables_equal(ref, table, "minn_rtl")
    return table


def zc_check_inputs(batch: int, L: int, device, seed: int):
    """(mf, iq, ref_norm) of the from-IQ check: integer-valued IQ with the
    template planted in three streams, and its matched filter from a
    complex128 FFT convolution (independent of kernel E) in float32."""
    ref, taps, ref_norm = zc_template()
    R = len(ref)
    iq = zc_iq_stimulus(batch, L, ref, device, seed=seed,
                        events=[(0, 2048), (min(1, batch - 1), L // 2),
                                (min(2, batch - 1), L - 2 * R)])
    return mf_reference(iq, taps).to(torch.float32), iq, ref_norm


def check_zc_iq(mf, iq, ref_norm: float):
    """Kernels D (IQ mode) + B (`zc_iq_cfar_detect`) against the plain
    `zc_iq_planar` and `extract_gate_events`: the magnitude bit-equal, above
    equal off the knife edge, tables equal.  Returns the kernels' table."""
    kw = dict(ref_len=mf.shape[-1] - iq.shape[-1] + 1, ref_norm=ref_norm, **ZC_CFAR)
    o = ZF.zc_metric(mf, iq, **kw)
    table = ZF.zc_iq_cfar_detect(mf, iq, **kw, hysteresis=ZC_EVENTS["hysteresis"],
                                 max_events=ZC_EVENTS["max_events"])
    mag, above = zc_iq_planar(mf, iq, **kw)
    _equal(o.mag, mag, "zc_iq magnitude")
    side = running_sum_stream(mag, ZC_CFAR["corr_window"]) * float(ZC_CFAR["threshold_value"])
    margin = (mag * float(1 << ZC_CFAR["threshold_frac_bits"]) - side).abs()
    knife = _knife(o.above != above, margin, side, ZC_KNIFE_RTOL, "zc_iq")
    assert_tables_equal(extract_gate_events(o.above if knife else above, mag, **ZC_EVENTS),
                        table, "zc_iq")
    return table


def check_aa(x):
    """Kernels C + B with capture (`aa_detect_fused`) and kernel C's metric
    mode against the plain `aa_metric_planar`, `aa_detect_step` and
    `extract_gate_events_capture` on integer stimulus: every output
    bit-equal, tables equal.  Returns the kernels' table."""
    L, thr, h = AA["half_len"], AA["threshold"], AA["hysteresis"]
    table, P, M = AF.aa_detect_fused(x, half_len=L, threshold=thr, hysteresis=h)
    st = aa_metric_planar(F._planar_view(x), L)
    track, Mp, above = aa_detect_step(st.P_re, st.P_im, st.R, L, thr)
    ref, cap = extract_gate_events_capture(above, track, (st.P_re, st.P_im, Mp), hysteresis=h)
    assert_tables_equal(ref, table, "aa")
    _equal(P, cap[:, :2], "aa P_at_peak")
    _equal(M, cap[:, 2], "aa M_at_peak")
    for name, out, want in zip(("P_re", "P_im", "R"), AF.aa_metric_planar(x, half_len=L),
                               (st.P_re, st.P_im, st.R)):
        _equal(out, want, f"aa metric mode {name}")
    return table


def check_mf(x, taps) -> float:
    """Kernel E (`matched_filter_ols`) against a complex128 FFT convolution,
    within MF_RTOL of the output peak; returns the error over the peak."""
    y = MF.matched_filter_ols(x, taps)
    ref = mf_reference(x, taps)
    if y.shape != ref.shape:
        raise AssertionError(f"mf: shape {tuple(y.shape)} != {tuple(ref.shape)}")
    err = float((y.double() - ref).abs().max()) / float(ref.abs().max())
    if err > MF_RTOL:
        raise AssertionError(f"mf: kernel E err {err} of the peak > {MF_RTOL}")
    return err


@contextlib.contextmanager
def mesh11(device):
    """A process group of this process alone (NCCL on a card, gloo on the
    CPU) and its (1, 1) mesh; the group is destroyed on exit."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    DI.initialize(f"tcp://localhost:{DI.free_port()}", 1, 0, backend=backend)
    try:
        yield SH.make_stream_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def check_sharded(x):
    """`sharded_minn_rtl_detect_fused` at mesh (1, 1) (one primed call and
    the overlap split) against the one-shot kernels A + B: tables equal."""
    one = F.minn_rtl_detect_fused(x, **DETECT)
    with mesh11(x.device) as mesh:
        for overlap in (False, True):
            t = SH.sharded_minn_rtl_detect_fused(x, mesh, **DETECT, overlap_halo=overlap)
            assert_tables_equal(one, t, f"sharded mesh (1, 1) overlap {overlap}")
    return one


def run_checks(dev, seed: int) -> dict:
    """Each check on its own seeded stimulus: {name: "ok" | reason}.  A
    wrong result is a reason; any other error (a kernel that does not
    build or launch) raises."""
    ref, taps, _ = zc_template()

    def minn(batch, L, s):
        return minn_stimulus(batch, L, Q, dev, seed=s)[0]

    cases = {
        "minn_rtl": lambda b, L, s: check_minn_rtl(minn(b, L, s)),
        "zc_iq": lambda b, L, s: check_zc_iq(*zc_check_inputs(b, L, dev, s)),
        "aa": lambda b, L, s: check_aa(aa_stimulus(
            b, L, AA["half_len"], dev, seed=s, events=[(0, 2048), (1, L // 2), (2, L - 4096)])),
        "mf": lambda b, L, s: check_mf(zc_iq_stimulus(b, L, ref, dev, seed=s,
                                                      events=[(0, 1000)]), taps),
        "sharded": lambda b, L, s: check_sharded(minn(b, L, s)),
    }
    out = {}
    for k, (name, fn) in enumerate(cases.items()):
        try:
            fn(*CHECKS[name], seed + k)
            out[name] = "ok"
        except AssertionError as e:
            out[name] = str(e)
        log(f"bench check {name}: {out[name]}")
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def timed(fn, *, units: float, works=(), n: int = CALLS) -> dict:
    """Warm up, reset the launch counts, then time ``n`` calls of fn(), one
    CUDA-event pair each: median and p90 (ms), n, units per second at the
    median, the bound of ``works`` (the (bytes, flops) of each kernel or
    function of the call, `utils.roofline`), the share bound / median, and
    the launches of each kernel and mode over the n calls."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    reset_launch_counts()
    s = summary(call_times(fn, n, warmup=0))
    out = {"median_ms": s["median"], "p90_ms": s["p90"], "n": s["n"],
           "per_s": units / s["median"] * 1e3,
           "launches": {k: v for k, v in launch_counts().items() if v},
           "modes": mode_launch_counts()}
    if works:
        out["bound_ms"], out["bound_by"] = bound_sum(works)
        out["share"] = out["bound_ms"] / s["median"]
    return out


def need_launches(res: dict, what: str, n: int, *kernels: str) -> None:
    """Each of ``kernels`` launched at least once a call in the timed run."""
    short = {k: res["launches"].get(k, 0) for k in kernels if res["launches"].get(k, 0) < n}
    if short:
        raise RuntimeError(f"{what}: kernels launched fewer than {n} times: {short}")


def _found(table, events, near, what: str) -> None:
    """Every planted (stream, position) has a peak p with near(p, pos)."""
    for b, pos in events:
        pk = table.peak_idx[b][table.valid[b]].tolist()
        if not any(near(p, pos) for p in pk):
            raise AssertionError(f"{what}: preamble at {b}:{pos} not found (peaks {pk})")


def headline(dev, seed: int) -> dict:
    """Kernels A + B at 512 x 262,144 x 2, float32 and int16 codes; kernel
    A's full-metric and corr/energy modes on the same samples; one
    profiler window over the f32 calls."""
    B, L = HEADLINE["batch"], HEADLINE["L"]
    x, events = minn_stimulus(B, L, Q, dev, seed=seed)
    table = F.minn_rtl_detect_fused(x, **DETECT)
    _found(table, events, lambda p, pos: 5 * Q <= p - pos <= 7 * Q, "headline")
    res = {}
    for name, xs in (("f32", x), ("int16", None)):
        xs = x.to(torch.int16) if xs is None else xs
        corr, above = F.minn_rtl_metric(xs, **MINN)
        works = (a_work(B, L, 4, xs.element_size(), 5), b_work(above, gated_samples(above, HYST)))
        del corr, above
        res[name] = timed(lambda: F.minn_rtl_detect_fused(xs, **DETECT), units=B * L,
                          works=works)
        need_launches(res[name], f"headline {name}", CALLS, "minn_rtl_metric", "gate_events")
        log(f"bench headline {name}: {res[name]['median_ms']:.4f} ms (p90 "
            f"{res[name]['p90_ms']:.4f}, n {CALLS}) = {res[name]['per_s']:.6g} samples/s, "
            f"{res[name]['share']:.3f} of the bound {res[name]['bound_ms']:.4f} ms")
    del xs
    res["profile"] = device_window(lambda: F.minn_rtl_detect_fused(x, **DETECT), CALLS,
                                   launches_per_call=2)
    res["full_metric"] = timed(lambda: F.minn_rtl_metric_planar_fused(x, **MINN), units=B * L,
                               works=(a_work(B, L, 4, 4, 13),))
    res["corr_energy"] = timed(lambda: F.minn_rtl_corr_energy_planar_fused(x, quarter_len=Q),
                               units=B * L, works=(a_work(B, L, 4, 4, 8, scan=False),))
    for name in ("full_metric", "corr_energy"):
        need_launches(res[name], name, CALLS, "minn_rtl_metric")
    del x
    torch.cuda.empty_cache()
    return res


def composed_step(state, chunk, params):
    """The fused Minn-RTL stream step as it ran before kernel F: the
    chunk's float32 copy, the gate rule in torch, kernel A primed, kernel B
    carried and the history roll (`minn_rtl_step_plain` on the card's
    tensors).  Kept here to time beside F in one call; the port never
    calls it."""
    base = int(state.base)
    table, carry, gate, hist = F.minn_rtl_step_plain(
        chunk.to(torch.float32).contiguous(), state.hist, state.carry, state.gate,
        **ST.minn_step_kwargs(params, base))
    state = ST.MinnRTLFusedStreamState(
        hist=hist, carry=carry, gate=gate,
        base=torch.tensor(base + chunk.shape[-1], dtype=torch.int32))
    return state, table


def block_latency(dev, seed: int) -> dict:
    """The streaming receiver at batch 1 x 2 branches on 4096-sample blocks:
    the fused `minn_rtl_fused_stream_step` (kernel F, one launch a block),
    the same step composed of kernels A (primed) and B (carried) and torch
    (`composed_step`), and the plain `minn_rtl_stream_step`.  For each: the
    p50 and p90 of BLOCK_STEPS steps, each ended by a synchronize (us), the
    host's enqueue time of the same steps (the host clock from the call to
    its return, before the synchronize: p50 and p90, us), and the marginal
    cost (wall(1152 steps) - wall(128 steps)) / 1024 (us); the launches of
    each kernel over the timed steps, and the bound of the fused and the
    composed step's kernels."""
    mp = ST.MinnRTLStreamParams(**MINN, hysteresis=HYST, max_events=DETECT["max_events"],
                                tie=DETECT["tie"])
    nblk = MARGINAL_STEPS[1]
    x, _ = minn_stimulus(1, BLOCK * nblk, Q, dev, seed=seed,
                         events=[(0, BLOCK * k + 1000) for k in range(3, nblk, 40)])
    fused_chunks = [x[..., BLOCK * i: BLOCK * (i + 1)].contiguous() for i in range(nblk)]
    plain_chunks = [F._planar_view(c)[0] for c in fused_chunks]  # (2, 2, BLOCK) views
    fused = lambda s, c: ST.minn_rtl_fused_stream_step(s, c, params=mp)[0]  # noqa: E731
    composed = lambda s, c: composed_step(s, c, mp)[0]  # noqa: E731
    plain = lambda s, c: ST.minn_rtl_stream_step(s, c, params=mp)  # noqa: E731
    fused_init = lambda: ST.minn_rtl_fused_stream_init(mp, 1, device=dev)  # noqa: E731
    res = {"budget_us": BLOCK_BUDGET_US, "block": BLOCK, "batch": 1, "branches": BRANCHES}
    for name, step, init, chunks in (
            ("fused", fused, fused_init, fused_chunks),
            ("composed", composed, fused_init, fused_chunks),
            ("plain", plain, lambda: ST.minn_rtl_stream_init(mp, BRANCHES, device=dev),
             plain_chunks)):
        s = init()
        for c in chunks[:8]:  # warm up
            s = step(s, c)
        torch.cuda.synchronize()
        reset_launch_counts()
        walls, enqueue = [], []
        for c in chunks[8: 8 + BLOCK_STEPS]:
            t0 = time.perf_counter()
            s = step(s, c)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e6)
            enqueue.append((t1 - t0) * 1e6)
        sm, se = summary(walls), summary(enqueue)
        res[name] = {"p50_us": sm["median"], "p90_us": sm["p90"], "n": sm["n"],
                     "enqueue_p50_us": se["median"], "enqueue_p90_us": se["p90"],
                     "launches": {k: v for k, v in launch_counts().items() if v}}
        res[name]["marginal_us"] = marginal_us(step, init, chunks, *MARGINAL_STEPS)
        log(f"bench latency {name}: p50 {sm['median']:.1f} us, p90 {sm['p90']:.1f} us "
            f"(n {sm['n']}), host enqueue p50 {se['median']:.1f} us, marginal "
            f"{res[name]['marginal_us']:.1f} us per block; budget {BLOCK_BUDGET_US:.1f} us")
    need_launches(res["fused"], "fused step", BLOCK_STEPS, "minn_rtl_step")
    if set(res["fused"]["launches"]) != {"minn_rtl_step"}:
        raise RuntimeError(f"the fused step launched more than kernel F: "
                           f"{res['fused']['launches']}")
    need_launches(res["composed"], "composed step", BLOCK_STEPS, "minn_rtl_metric", "gate_events")
    corr, above = F.minn_rtl_metric(fused_chunks[100], **MINN)
    hist = fused_init().hist.shape[-1]
    gated = gated_samples(above, HYST)
    for name, works in (("fused", (f_work(1, BLOCK, 4, 4, hist, gated),)),
                        ("composed", (a_work(1, BLOCK, 4, 4, 5, hist_len=hist),
                                      b_work(above, gated)))):
        bound_ms, res[name]["bound_by"] = bound_sum(works)
        res[name]["bound_us"] = bound_ms * 1e3
        res[name]["share"] = res[name]["bound_us"] / res[name]["p50_us"]
    del x, fused_chunks, plain_chunks
    torch.cuda.empty_cache()
    return res


def secondary(dev, seed: int) -> dict:
    """`bench.py`'s secondary workloads, each timed as the headline is."""
    res = {}
    # [A][A]: kernels C + B with capture, and C's metric mode (#5, #6)
    B, n, L = AA["batch"], AA["n"], AA["half_len"]
    ev = [(0, 3 * L), (1, n // 3), (2, n // 2), (3, n - 2 * L - 700)]
    x = aa_stimulus(B, n, L, dev, seed=seed, events=ev)
    table = AF.aa_detect_fused(x, half_len=L)[0]
    _found(table, ev, lambda p, pos: abs(p - 2 * L + 1 - pos) <= 2, "aa_fused")
    o = AF.aa_metric(x, half_len=L, threshold=AA["threshold"])
    b_capture = b_work(o.above, gated_samples(o.above, AA["hysteresis"]), n_extra=3)
    del o
    res["aa_fused"] = timed(lambda: AF.aa_detect_fused(x, half_len=L), units=B * n,
                            works=(c_work(B, n, 4, 4, 17), b_capture))
    res["aa_metric"] = timed(lambda: AF.aa_metric_planar(x, half_len=L), units=B * n,
                             works=(c_work(B, n, 4, 4, 12),))
    need_launches(res["aa_fused"], "aa_fused", CALLS, "aa_metric", "gate_events")
    need_launches(res["aa_metric"], "aa_metric", CALLS, "aa_metric")
    del x
    torch.cuda.empty_cache()

    # ZC CFAR: kernel D's magnitude mode + B on magnitudes (#7)
    B, n = ZC["batch"], ZC["n"]
    ev = [(0, 3000), (1, n // 3), (2, n // 2), (3, n - 500)]
    mag = mag_stimulus(B, n, dev, seed=seed + 1, events=ev)
    _found(ZF.zc_cfar_detect(mag, **ZC_CFAR), ev, lambda p, pos: p == pos, "zc_cfar")
    above = ZF.zc_metric(mag, **ZC_CFAR).above
    works = (d_mag_work(B, n), b_work(above, gated_samples(above, 256), E=16))
    del above
    res["zc_cfar"] = timed(lambda: ZF.zc_cfar_detect(mag, **ZC_CFAR), units=B * n, works=works)
    need_launches(res["zc_cfar"], "zc_cfar", CALLS, "zc_metric", "gate_events")
    del mag
    torch.cuda.empty_cache()

    # ZC from IQ: kernel D's IQ mode + B, float32 and int16 IQ (#8, #9),
    # on the matched filter of kernel E (made once, not timed)
    ref, taps, ref_norm = zc_template()
    R = len(ref)
    ev = [(0, 3000), (1, n // 3), (2, n // 2), (3, n - R - 500)]
    x = zc_iq_stimulus(B, n, ref, dev, seed=seed + 2, events=ev)
    mf = MF.matched_filter_ols(x, taps)
    kw = dict(ref_len=R, ref_norm=ref_norm, **ZC_CFAR)
    _found(ZF.zc_iq_cfar_detect(mf, x, **kw), ev, lambda p, pos: abs(p - (pos + R - 1)) <= 2,
           "zc_iq")
    for name in ("f32", "int16"):
        xs = x if name == "f32" else x.to(torch.int16)
        above = ZF.zc_metric(mf, xs, **kw).above
        works = (d_iq_work(B, n + R - 1, n, 4, xs.element_size()),
                 b_work(above, gated_samples(above, 256), E=16))
        del above
        res[f"zc_iq_{name}"] = timed(lambda: ZF.zc_iq_cfar_detect(mf, xs, **kw), units=B * n,
                                     works=works)
        need_launches(res[f"zc_iq_{name}"], f"zc_iq {name}", CALLS, "zc_metric", "gate_events")
    del xs, mf
    torch.cuda.empty_cache()

    # the matched filter at 64 x 262,144 x 2, T = 2048: the port's
    # overlap-save FFT convolution in torch (cuFFT), kernel E, E -> D -> B (#10)
    Bm = ZC["mf_batch"]
    xm = x[:, :Bm].contiguous()
    del x
    torch.cuda.empty_cache()
    mf_work = e_work(xm, R, n + R - 1)
    xc = torch.complex(xm[0::2], xm[1::2])
    kern = torch.as_tensor(np.conj(ref[::-1]).astype(np.complex64), device=dev)
    res["zc_mf_ols"] = timed(lambda: fft_convolve_full_ols(xc, kern), units=Bm * n,
                             works=(mf_work,))
    del xc
    res["zc_mf"] = timed(lambda: MF.matched_filter_ols(xm, taps), units=Bm * n, works=(mf_work,))
    need_launches(res["zc_mf"], "zc_mf", CALLS, "matched_filter_ols")
    mfm = MF.matched_filter_ols(xm, taps)
    above = ZF.zc_metric(mfm, xm, **kw).above
    works = (mf_work, d_iq_work(Bm, n + R - 1, n, 4, 4),
             b_work(above, gated_samples(above, 256), E=16))
    del above, mfm
    res["zc_e2e_iq"] = timed(lambda: ZF.zc_iq_cfar_detect(MF.matched_filter_ols(xm, taps), xm,
                                                          **kw), units=Bm * n, works=works)
    need_launches(res["zc_e2e_iq"], "zc_e2e_iq", CALLS, "matched_filter_ols", "zc_metric",
                  "gate_events")
    del xm
    torch.cuda.empty_cache()

    # the ZC-frequency sliding DFT (no TPU kernel; plain torch): offsets/s
    f = ZC_FREQ
    zf_L = f["n_fft"] + f["cp_len"] + f["offsets"] - 1
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    rx = torch.randn((2, BRANCHES, zf_L), generator=g, device=dev)
    rx = torch.complex(rx[0], rx[1])
    tmpl = np.asarray(generate_zadoff_chu(f["root"], f["bins"]), np.complex64)
    bins = centered_subcarrier_indices(f["bins"])
    res["zc_freq_sliding"] = timed(
        lambda: zc_freq_metric_sliding(rx, tmpl, bins, n_fft=f["n_fft"], cp_len=f["cp_len"]),
        units=f["offsets"], works=(sliding_dft_work(BRANCHES, zf_L, f["bins"], f["offsets"]),))
    del rx
    torch.cuda.empty_cache()
    for name, r in res.items():
        unit = "offsets/s" if name == "zc_freq_sliding" else "samples/s"
        log(f"bench secondary {name}: {r['median_ms']:.4f} ms (p90 {r['p90_ms']:.4f}) = "
            f"{r['per_s']:.6g} {unit}, {r['share']:.3f} of the bound {r['bound_ms']:.4f} ms")
    log("bench family map: D3 minn_rtl = headline; D9 aa = aa_fused (+ aa_metric); D7 zc_v2 = "
        "zc_cfar + zc_iq_{f32,int16}; D5 zc_mf = zc_mf_ols, zc_mf, zc_e2e_iq; D6 zc_freq = "
        "zc_freq_sliding; D1 sc, D2 minn, D4 park and D8 combined have no TPU kernel and "
        "chip_smoke.py phase 16 times their detects (bench.py's reason for leaving Park "
        "out, its TPU compile time, does not hold for the port)")
    return res


#: the ten TPU kernels and the timed calls of this bench that reach their
#: port (`kernels` of the result line)
TPU_KERNELS = (
    ("ofdm_sync_tpu/kernels/pallas_minn_tm.py:60 _tm_kernel", "A + B",
     ("headline.f32", "headline.int16")),
    ("ofdm_sync_tpu/kernels/pallas_minn.py:403 _detect_kernel", "F (the stream step)",
     ("latency.fused",)),
    ("ofdm_sync_tpu/kernels/pallas_minn.py:240 _minn_kernel", "A full-metric mode",
     ("headline.full_metric",)),
    ("ofdm_sync_tpu/kernels/pallas_minn.py:113 _corr_energy_kernel", "A corr/energy mode",
     ("headline.corr_energy",)),
    ("ofdm_sync_tpu/kernels/pallas_aa.py:71 _aa_metric_kernel", "C metric mode",
     ("secondary.aa_metric",)),
    ("ofdm_sync_tpu/kernels/pallas_aa.py:221 _aa_kernel", "C detect + B capture",
     ("secondary.aa_fused",)),
    ("ofdm_sync_tpu/kernels/pallas_zc.py:35 _zc_kernel", "D magnitude + B",
     ("secondary.zc_cfar",)),
    ("ofdm_sync_tpu/kernels/pallas_zc.py:156 _zc_iq_kernel", "D IQ + B",
     ("secondary.zc_iq_f32",)),
    ("ofdm_sync_tpu/kernels/pallas_zc_tm.py:78 _zc_iq_tm_kernel", "D IQ int16 + B",
     ("secondary.zc_iq_int16",)),
    ("ofdm_sync_tpu/kernels/pallas_mf.py:137 _mf_kernel", "E",
     ("secondary.zc_mf", "secondary.zc_e2e_iq")),
)


def kernel_rows(sections: dict) -> list[dict]:
    """One row per TPU kernel: its port and, per timed call that reaches
    it, the median, bound, share and launches."""
    rows = []
    for tpu, port, calls in TPU_KERNELS:
        timed_calls = {}
        for path in calls:
            sec, name = path.split(".")
            r = sections[sec][name]
            keep = ("median_ms", "p50_us", "enqueue_p50_us", "bound_ms", "bound_us",
                    "bound_by", "share", "launches")
            timed_calls[path] = {k: r[k] for k in keep if k in r}
        rows.append({"tpu_kernel": tpu, "port": port, "timed": timed_calls})
    return rows


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_info() -> dict:
    return {"platform": "gpu", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": card_line()}


def result_line(device: dict, seed: int, checks: dict, head=None, latency=None,
                sec=None) -> dict:
    """The result object: `bench.py`'s keys (``value`` the f32 headline's
    IQ samples/s at its median; None where the checks failed and nothing was
    timed) and the port's."""
    checked = len(checks) == len(CHECKS)
    line = {
        "metric": "iq_samples_per_sec_per_chip",
        "value": None if head is None else head["f32"]["per_s"],
        "unit": "samples/s",
        "checked": checked,
        "check_ok": checked and all(v == "ok" for v in checks.values()),
        "checks": checks,
        "device": device,
        "seed": seed,
        "headline": None,
        "latency": latency,
        "secondary": sec,
        "kernels": None,
    }
    if head is not None:
        f32, i16 = head["f32"], head["int16"]
        line["headline"] = {
            "batch": HEADLINE["batch"], "L": HEADLINE["L"], "branches": BRANCHES, "Q": Q,
            "median_ms": f32["median_ms"], "p90_ms": f32["p90_ms"], "n": f32["n"],
            "int16_samples_per_sec": i16["per_s"], **{k: head[k] for k in head}}
    if head is not None and latency is not None and sec is not None:
        line["kernels"] = kernel_rows({"headline": head, "latency": latency, "secondary": sec})
    return line


def emit(line: dict, out: str | None) -> None:
    text = json.dumps(line)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ofdm_sync_tpu_torch bench",
        description="the port's benchmark on one card (the JAX package's bench.py)")
    parser.add_argument("--seed", type=int, default=0, help="seed of every stimulus")
    parser.add_argument("--out", default=None, help="also write the result line to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        log("bench: no CUDA device (torch.cuda.is_available() is False); the bench runs on "
            "the card only and times nothing without one")
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    device = device_info()
    log(f"bench: {device['name']} ({device['nvidia_smi']}), torch {torch.__version__}, "
        f"seed {args.seed}")
    checks = run_checks(dev, args.seed)
    if not all(v == "ok" for v in checks.values()):
        emit(result_line(device, args.seed, checks), args.out)
        log("bench: an on-card check failed; nothing timed")
        return 1
    head = headline(dev, args.seed)
    lat = block_latency(dev, args.seed + 1)
    sec = secondary(dev, args.seed + 2)
    emit(result_line(device, args.seed, checks, head, lat, sec), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
