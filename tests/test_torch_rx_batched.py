"""The batched Minn-RTL receive (`pipelines.fused_rx.receive_minn_rtl_frames`)
on the CPU at the published widths (N 2048, Q 512, CP 512), on small
batches: against the plain reference of the `minn_rtl_rx` configuration
(`benchmark/reference/minn_rtl_rx.py`), against the per-frame path
(`estimate_cfo_from_cp` + `_demod`) slot by slot, and against the JAX
package's `run_fused_rx_minn_rtl`; its empty slots, its counters and its
spans.

JAX is imported inside the one test that uses it, so on a card this file
runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rx_batched.py
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import harness as H  # noqa: E402
from benchmark import stimulus  # noqa: E402
from benchmark.preambles import minn_rtl_frame  # noqa: E402
from benchmark.reference import gates as G  # noqa: E402
from benchmark.reference import minn_rtl_fpga as FPGA  # noqa: E402
from benchmark.reference import minn_rtl_rx as REF  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import reset_launch_counts  # noqa: E402
from ofdm_sync_tpu_torch.ops.estimate import estimate_cfo_from_cp  # noqa: E402
from ofdm_sync_tpu_torch.ops.extract import extract_frames_planar  # noqa: E402
from ofdm_sync_tpu_torch.params import MinnRTLParams, SystemParams  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import fused_rx as RX  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELL = "minn_rtl_rx.frames"
#: 4 streams of 2^16 samples, 4 frames each (one a 16,384-sample segment)
BATCH, N_SAMPLES, FRAMES = 4, 1 << 16, 4


def cell() -> H.Cell:
    c = H.Cell(H.load_spec(ROOT), CELL, ROOT)
    c.traffic.update(batch=BATCH, samples=N_SAMPLES, distinct=2, preambles_per_stream=FRAMES)
    return c


def received(seed: int, dtype=None):
    """(config, codes, table, slot outputs, pilot, data) of one seeded batch."""
    c = cell()
    cfg = c.config
    x = stimulus.streams(cfg, c.traffic, stimulus.seeded(seed, "cpu"), BATCH, N_SAMPLES, "cpu")
    if dtype is not None:
        x = x.to(dtype)
    det, sys, rx = cfg["detector"], cfg["system"], cfg["receive"]
    table = F.minn_rtl_detect_fused(x, **{k: det[k] for k in (
        "quarter_len", "smooth_shift", "threshold_value", "threshold_frac_bits", "hysteresis",
        "max_events", "tie", "emit_unclosed")})
    pilot, data = (torch.as_tensor(v, dtype=torch.complex64)
                   for v in minn_rtl_frame.symbols(cfg))
    out = RX.receive_minn_rtl_frames(
        x, table, sys=SystemParams(n_fft=sys["n_fft"], num_active=sys["num_active"],
                                   cp_len=sys["cp_len"], sample_rate_hz=sys["sample_rate_hz"]),
        params=MinnRTLParams(quarter_len=det["quarter_len"], timing_offset=rx["timing_offset"]),
        pilot_used=pilot, data_used=data, max_frames=rx["max_frames"])
    return cfg, x, table, out, pilot, data


@pytest.mark.parametrize("seed", [5, 2**31 + 99, 9_876_543_210])
def test_matches_reference(seed):
    cfg, x, table, out, pilot, data = received(seed)
    ref, amb, _ = FPGA.detect(x, cfg["detector"])
    bad, _, gap = G.compare({f: getattr(table, f).numpy() for f in G.FIELDS}, ref, amb,
                            cfg["detector"]["hysteresis"])
    assert int(bad.sum()) == 0 and gap <= REF.LIMITS["peak_value_gap"]
    kept = {"peak_idx": table.peak_idx, "table_valid": table.valid, "count": table.count,
            **out._asdict()}
    mism, gaps, compared, _ = REF.judge_rx(cfg, x, kept, pilot.to(torch.complex128),
                                           data.to(torch.complex128))
    assert compared >= BATCH * FRAMES - 1
    assert mism == 0
    for k, v in gaps.items():
        assert v <= REF.LIMITS[k], (k, v)


@pytest.mark.parametrize("dtype", [None, torch.float32])
def test_matches_per_frame_path(dtype):
    """Slot by slot against the per-frame stages of the chain (the frames
    re-emitted whole, `estimate_cfo_from_cp` and `_demod` on each), int16
    codes and float32 samples alike: equal starts, CFO, EVM and gain within
    float32 rounding."""
    cfg, x, table, out, pilot, data = received(7, dtype)
    sys_p = SystemParams()
    Q = cfg["detector"]["quarter_len"]
    frames, starts, valid = extract_frames_planar(x, table, frame_len=7680,
                                                  timing_offset=-6 * Q, max_frames=16)
    assert torch.equal(valid, out.valid) and torch.equal(torch.where(valid, starts, 0),
                                                         out.starts)
    n = 0
    for b, k in zip(*np.nonzero(valid.numpy())):
        fp = frames[b, k].to(torch.float32)
        ants = torch.complex(fp[0::2], fp[1::2])
        cfo = float(estimate_cfo_from_cp(ants, 5 * Q, 2048, 512, sys_p.sample_rate_hz))
        evm_pct, evm_db, gain = RX._demod(fp, cfo, (5 * Q + 512, 5 * Q + 3072), sys_p, pilot,
                                          data)
        assert float(out.cfo_hz[b, k]) == pytest.approx(cfo, abs=1e-3, rel=1e-5)
        assert 100 * float(out.evm_rms[b, k]) == pytest.approx(evm_pct, rel=1e-4)
        assert float(out.evm_db[b, k]) == pytest.approx(evm_db, abs=1e-3)
        assert complex(out.gain[b, k]) == pytest.approx(gain, rel=1e-4)
        n += 1
    assert n >= BATCH * FRAMES - 1


def test_empty_slots_are_zero():
    """Slots beyond the count, past max_frames' table slots or not valid
    give zeros in every output."""
    cfg, x, table, _, pilot, data = received(11)
    table = table._replace(valid=table.valid.clone(), count=table.count.clone())
    table.valid[0, 1] = False            # an invalid slot below the count
    table.count[1] = 2                   # valid slots beyond the count
    out = RX.receive_minn_rtl_frames(x, table, pilot_used=pilot, data_used=data,
                                     max_frames=16)
    empty = ~out.valid
    assert bool(empty[0, 1]) and bool(empty[1, 2:].all()) and bool(empty[:, 4:].all())
    assert int(out.valid.sum()) >= 2 * FRAMES - 2
    for f in RX.RxSlots._fields:
        v = getattr(out, f)
        if f != "valid":
            assert not bool(v[empty].ne(0).any()), f
            assert bool(v[out.valid].ne(0).any()), f


def test_counters_and_spans():
    cfg, x, table, _, pilot, data = received(13)
    reset_launch_counts()
    assert RX.receive_minn_rtl_frames.calls == RX.receive_minn_rtl_frames.slots == 0
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        RX.receive_minn_rtl_frames(x, table, pilot_used=pilot, data_used=data, max_frames=16)
        RX.receive_minn_rtl_frames(x, table, pilot_used=pilot, data_used=data, max_frames=3)
    assert RX.receive_minn_rtl_frames.calls == 2
    assert RX.receive_minn_rtl_frames.slots == BATCH * 16 + BATCH * 3
    assert RX.RECEIVE_SPAN == "ofdm_sync.minn_rtl_receive"
    assert RX.RECEIVE_STAGES == tuple(f"ofdm_sync.minn_rtl_receive.{s}"
                                      for s in ("front", "fft", "back"))
    spans = [e for e in prof.events() if e.name.startswith(RX.RECEIVE_SPAN)]
    for name in (RX.RECEIVE_SPAN, *RX.RECEIVE_STAGES):
        assert sum(e.name == name for e in spans) == 2, name
    for e in spans:
        if e.name != RX.RECEIVE_SPAN:
            assert e.cpu_parent.name == RX.RECEIVE_SPAN
    reset_launch_counts()
    assert RX.receive_minn_rtl_frames.calls == RX.receive_minn_rtl_frames.slots == 0


def _norm(text):
    """Printed report with the detector description (which names the
    kernel) left out."""
    return re.sub(r"detector: .*", "detector: -", text).splitlines()


@pytest.mark.parametrize("channel", [None, "cir2"])
def test_chain_matches_jax(capsys, channel):
    """The chain (now the batched receive) against the JAX package's
    per-frame chain on its own stimulus: every printed number, CFO and EVM
    to their displayed precision."""
    pytest.importorskip("jax")
    from ofdm_sync_tpu.pipelines.fused_rx import run_fused_rx_minn_rtl as j_run

    kw = dict(snr_db=30.0 if channel is None else 10.0, channel_name=channel,
              cfo_hz=1000.0, seed=0)
    jr = j_run(**kw)
    jout = capsys.readouterr().out
    tr = RX.run_fused_rx_minn_rtl(**kw, device="cpu")
    tout = capsys.readouterr().out
    assert jr.detected and tr.detected and len(tr.frames) == len(jr.frames) == 2
    assert _norm(tout) == _norm(jout)
