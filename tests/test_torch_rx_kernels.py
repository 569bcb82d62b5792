"""Kernels G and H of the batched Minn-RTL receive (`kernels.minn_rx`),
around its one FFT, as `pipelines.fused_rx.receive_minn_rtl_frames` runs
them on a card.

On the CPU: a CPU tensor takes the plain body and launches nothing; the
wrappers' checks of device, type, shape, contiguity and numerology raise
before any launch; `build.SIGNATURES` matches the C entry points of the
CUDA sources, argument for argument.  On a card (`gpu`): the kernel path
against the same call's plain body on the card, on the same codes and
table (int16 and float32 codes, one and two branches, ``max_frames`` below,
at and above the table's slots, slots past the count or not valid, starts
clipped at both ends of the stream, AWGN and the cir2 channel), within
PERF.md section 2's limits: CFO within 0.01 Hz, EVM within 1e-3 relative,
each equalized bin and the gain within 1e-3 over max(1, |plain|) outside
the weak bins (`benchmark.reference.minn_rtl_rx.WEAK`), starts and valid
exactly; one launch of each kernel a call in the codes' mode, and the same
outputs again under ``torch.cuda.set_sync_debug_mode("error")``.  This
file imports no JAX, so on a card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rx_kernels.py
"""

import ctypes
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import harness as H  # noqa: E402
from benchmark import stimulus  # noqa: E402
from benchmark.preambles import minn_rtl_frame  # noqa: E402
from benchmark.reference import minn_rtl_rx as REF  # noqa: E402
from ofdm_sync_tpu_torch.kernels import build  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rx as RK  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import (  # noqa: E402
    launch_counts,
    mode_launch_counts,
    reset_launch_counts,
)
from ofdm_sync_tpu_torch.models.detectors import MinnRTLDetector  # noqa: E402
from ofdm_sync_tpu_torch.ops.detect import GateEvents  # noqa: E402
from ofdm_sync_tpu_torch.ops import waveforms as WV  # noqa: E402
from ofdm_sync_tpu_torch.ops.waveforms import build_minn_rtl_preamble  # noqa: E402
from ofdm_sync_tpu_torch.params import (  # noqa: E402
    SYS_30M72,
    SYS_AA_10M,
    SYS_DEMO_512,
    MinnRTLParams,
    SystemParams,
)
from ofdm_sync_tpu_torch.pipelines import common  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import fused_rx as RX  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELL = "minn_rtl_rx.frames"
#: 8 streams of 2^16 samples, 4 frames each (one a 16,384-sample segment)
BATCH, N_SAMPLES, FRAMES = 8, 1 << 16, 4
#: PERF.md section 2's limits of the receive (the benchmark's own)
LIMITS = {k: REF.LIMITS[k] for k in ("cfo_gap_hz", "evm_gap", "eq_gap")}
DET = ("quarter_len", "smooth_shift", "threshold_value", "threshold_frac_bits", "hysteresis",
       "max_events", "tie", "emit_unclosed")


def _cell():
    c = H.Cell(H.load_spec(ROOT), CELL, ROOT)
    c.traffic.update(batch=BATCH, samples=N_SAMPLES, distinct=2, preambles_per_stream=FRAMES)
    return c


def _frames(seed: int, device="cpu", dtype=torch.int16):
    """(config, codes (4, BATCH, N_SAMPLES), their table, pilot, data): the
    frame cell's stimulus at a small batch, detected by kernels A + B (on a
    card) or their plain versions."""
    c = _cell()
    cfg = c.config
    x = stimulus.streams(cfg, c.traffic, stimulus.seeded(seed, "cpu"), BATCH, N_SAMPLES, "cpu")
    x = x.to(dtype).to(device)
    table = F.minn_rtl_detect_fused(x, **{k: cfg["detector"][k] for k in DET})
    pilot, data = (torch.as_tensor(v, dtype=torch.complex64, device=device)
                   for v in minn_rtl_frame.symbols(cfg))
    return cfg, x, table, pilot, data


def _kw(cfg):
    sys, det, rx = cfg["system"], cfg["detector"], cfg["receive"]
    return dict(sys=SystemParams(n_fft=sys["n_fft"], num_active=sys["num_active"],
                                 cp_len=sys["cp_len"], sample_rate_hz=sys["sample_rate_hz"]),
                params=MinnRTLParams(quarter_len=det["quarter_len"],
                                     timing_offset=rx["timing_offset"]))


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

def test_cpu_tensor_takes_the_plain_body_and_launches_nothing():
    """The call's outputs are those of one call of the plain body, bit for
    bit (a second call of the CPU's plain body may differ in the last bits:
    its vectorized sums follow each tensor's alignment)."""
    cfg, x, table, pilot, data = _frames(3)
    body, calls = RX.receive_minn_rtl_frames_plain, []

    def spy(*args, **kw):
        calls.append(body(*args, **kw))
        return calls[-1]

    reset_launch_counts()
    with mock.patch.object(RX, "receive_minn_rtl_frames_plain", spy):
        out = RX.receive_minn_rtl_frames(x, table, **_kw(cfg), pilot_used=pilot,
                                         data_used=data, max_frames=16)
    assert launch_counts()["minn_rx_front"] == launch_counts()["minn_rx_back"] == 0
    assert not any(k.startswith("minn_rx_") for k in mode_launch_counts())
    assert RX.receive_minn_rtl_frames.calls == 1 and len(calls) == 1
    assert int(out.valid.sum()) >= BATCH * FRAMES - 1
    for f in RX.RxSlots._fields:
        assert torch.equal(getattr(out, f), getattr(calls[0], f)), f


def _front_args(x, table):
    return dict(x=x, table=table, n_fft=2048, cp_len=512, pilot_cp=2560, offset=-3072,
                max_frames=16, sample_rate_hz=30.72e6)


def _table(batch=2, E=4, **kw):
    t = dict(valid=torch.ones((batch, E), dtype=torch.bool),
             peak_idx=torch.full((batch, E), 9000, dtype=torch.int32),
             count=torch.full((batch,), E, dtype=torch.int32))
    t.update(kw)
    return GateEvents(valid=t["valid"], closed=t["valid"], gate_start=t["peak_idx"],
                        gate_close=t["peak_idx"], peak_idx=t["peak_idx"],
                        peak_value=t["peak_idx"].float(), count=t["count"],
                        overflow=torch.zeros(batch, dtype=torch.bool))


#: the wrappers' checks: the error each case raises, and whether it gets as
#: far as the device check (numerology and layouts the kernels take, which
#: a CPU tensor reaches only to be sent to the plain body)
_ON_CARD = "runs on a card"

_FRONT_CASES = {
    "codes_float64": (TypeError, lambda a: a.update(x=a["x"].double())),
    "five_branches": (ValueError, lambda a: a.update(x=torch.zeros((10, 2, 20000),
                                                                    dtype=torch.int16))),
    "codes_2d": (ValueError, lambda a: a.update(x=a["x"][0])),
    "peak_idx_int64": (TypeError, lambda a: a.update(table=a["table"]._replace(
        peak_idx=a["table"].peak_idx.long()))),
    "valid_int": (TypeError, lambda a: a.update(table=a["table"]._replace(
        valid=a["table"].valid.int()))),
    "count_shape": (ValueError, lambda a: a.update(table=a["table"]._replace(
        count=a["table"].count[:1]))),
    "table_rows": (ValueError, lambda a: a.update(table=_table(batch=3))),
    "n_fft_zero": (ValueError, lambda a: a.update(n_fft=0)),
    "cp_negative": (ValueError, lambda a: a.update(cp_len=-1)),
    "frame_past_stream": (ValueError, lambda a: a.update(x=a["x"][..., :7679])),
    "max_frames_negative": (ValueError, lambda a: a.update(max_frames=-1)),
}
#: taken by the kernels: these reach the device check
_FRONT_TAKEN = {
    "three_branches": lambda a: a.update(x=torch.zeros((6, 2, 20000), dtype=torch.int16)),
    "n_fft_1024": lambda a: a.update(n_fft=1024),
    "cp_zero": lambda a: a.update(cp_len=0),
    "cp_over_n": lambda a: a.update(cp_len=4096),
    "no_slot": lambda a: a.update(max_frames=0),
    "codes_not_contiguous": lambda a: a.update(x=torch.zeros((2, 4, 20000),
                                                             dtype=torch.int16).transpose(0, 1)),
    "codes_strided_in_time": lambda a: a.update(x=torch.zeros((4, 2, 40000),
                                                              dtype=torch.int16)[..., ::2]),
    "table_not_contiguous": lambda a: a.update(table=a["table"]._replace(
        peak_idx=torch.full((4, 2), 9000, dtype=torch.int32).t())),
    "on_the_cpu": lambda a: None,
}
_FRONT_CASES.update({k: (ValueError, v) for k, v in _FRONT_TAKEN.items()})


@pytest.mark.parametrize("case", sorted(_FRONT_CASES))
def test_front_checks_raise_before_a_launch(case):
    err, change = _FRONT_CASES[case]
    args = _front_args(torch.zeros((4, 2, 20000), dtype=torch.int16), _table())
    change(args)
    reset_launch_counts()
    with pytest.raises(err) as info:
        RK.minn_rx_front(**args)
    assert (_ON_CARD in str(info.value)) == (case in _FRONT_TAKEN), str(info.value)
    assert launch_counts()["minn_rx_front"] == 0


def _back_args():
    return dict(bins=torch.zeros((2, 3, 2, 2048), dtype=torch.complex64),
                valid=torch.ones((2, 3), dtype=torch.bool),
                pilot_used=torch.ones(1200, dtype=torch.complex64),
                data_used=torch.ones(1200, dtype=torch.complex64), num_active=1200,
                codes_dtype=torch.int16)


_BACK_CASES = {
    "bins_complex128": (TypeError, lambda a: a.update(bins=a["bins"].to(torch.complex128))),
    "bins_3d": (ValueError, lambda a: a.update(bins=a["bins"][0])),
    "bins_three_symbols": (ValueError, lambda a: a.update(
        bins=torch.zeros((2, 3, 3, 2048), dtype=torch.complex64))),
    "num_active_odd": (ValueError, lambda a: a.update(num_active=1199)),
    "num_active_over_n": (ValueError, lambda a: a.update(
        num_active=2050, pilot_used=torch.ones(2050, dtype=torch.complex64),
        data_used=torch.ones(2050, dtype=torch.complex64))),
    "pilot_length": (ValueError, lambda a: a.update(pilot_used=a["pilot_used"][:600])),
    "data_complex128": (TypeError, lambda a: a.update(
        data_used=a["data_used"].to(torch.complex128))),
    "valid_shape": (ValueError, lambda a: a.update(valid=a["valid"][:, :2])),
    "codes_dtype": (TypeError, lambda a: a.update(codes_dtype=torch.float64)),
    "bins_not_contiguous": (ValueError, lambda a: a.update(
        bins=torch.zeros((3, 2, 2, 2048), dtype=torch.complex64).transpose(0, 1))),
}
_BACK_TAKEN = {
    "n_fft_4096": lambda a: a.update(bins=torch.zeros((2, 3, 2, 4096), dtype=torch.complex64)),
    "num_active_over": lambda a: a.update(
        num_active=1282, pilot_used=torch.ones(1282, dtype=torch.complex64),
        data_used=torch.ones(1282, dtype=torch.complex64)),
    "num_active_all_bins": lambda a: a.update(
        num_active=2048, pilot_used=torch.ones(2048, dtype=torch.complex64),
        data_used=torch.ones(2048, dtype=torch.complex64)),
    "pilot_not_contiguous": lambda a: a.update(
        pilot_used=torch.ones(2400, dtype=torch.complex64)[::2]),
    "on_the_cpu": lambda a: None,
}
_BACK_CASES.update({k: (ValueError, v) for k, v in _BACK_TAKEN.items()})


@pytest.mark.parametrize("case", sorted(_BACK_CASES))
def test_back_checks_raise_before_a_launch(case):
    err, change = _BACK_CASES[case]
    args = _back_args()
    change(args)
    reset_launch_counts()
    with pytest.raises(err) as info:
        RK.minn_rx_back(**args)
    assert (_ON_CARD in str(info.value)) == (case in _BACK_TAKEN), str(info.value)
    assert launch_counts()["minn_rx_back"] == 0


#: a C parameter's type -> its ctypes type in `build.SIGNATURES`
_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float,
            "double": ctypes.c_double, "void*": ctypes.c_void_p}


def _c_entries() -> dict:
    """{name: [ctypes type of each parameter]} of every ``extern "C" int``
    entry point of `kernels/csrc/*.cu`."""
    out = {}
    for path in sorted(build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            types = []
            for p in params.split(","):
                p = " ".join(p.replace("*", " * ").split()[:-1]).replace("const ", "")
                types.append(_C_TYPES[p.replace(" *", "*")])
            out[name] = types
    return out


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_signature_matches_the_c_entry(name):
    """Each entry of `build.SIGNATURES` has the C function's parameters in
    number and type (a pointer passed as an int would be cut to 32 bits)."""
    entries = _c_entries()
    assert set(entries) == set(build.SIGNATURES)
    assert build.SIGNATURES[name] == entries[name], name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _gaps(kern, plain, x, pilot, data, sys, params) -> dict:
    """The kernel path against the plain body: starts and valid exactly,
    zeros in every empty slot, and at the valid slots the largest CFO,
    relative EVM, gain and equalized-bin differences (gain and bins over
    max(1, |plain|), the bins outside the weak ones of a float64 channel
    estimate, `chip_smoke.rx_weak`)."""
    from chip_smoke import rx_weak

    assert torch.equal(kern.valid, plain.valid) and torch.equal(kern.starts, plain.starts)
    v = plain.valid
    for f in RX.RxSlots._fields:
        if f != "valid":
            assert not bool(getattr(kern, f)[~v].ne(0).any()), f
    if not bool(v.any()):
        return dict.fromkeys(("cfo_gap_hz", "evm_gap", "eq_gap", "gain_gap"), 0.0)
    weak = rx_weak(x, plain.starts, pilot, data, sys, params.quarter_len)
    rel = lambda a, b: (a - b).abs() / b.abs().clamp_min(1.0)  # noqa: E731
    return {"cfo_gap_hz": float((kern.cfo_hz - plain.cfo_hz)[v].abs().max()),
            "evm_gap": float(((kern.evm_rms - plain.evm_rms).abs() / plain.evm_rms)[v].max()),
            "eq_gap": float(rel(kern.eq, plain.eq).masked_fill(weak, 0.0)[v].max()),
            "gain_gap": float(rel(kern.gain, plain.gain)[v].max())}


def _check(x, table, cfg, pilot, data, max_frames, what, **kw) -> RX.RxSlots:
    """One call of the kernel path against the plain body on the card:
    gaps within the limits, one launch of each kernel in the codes' mode."""
    args = {**(_kw(cfg) if cfg else {}), "pilot_used": pilot, "data_used": data,
            "max_frames": max_frames, **kw}
    reset_launch_counts()
    out = RX.receive_minn_rtl_frames(x, table, **args)
    modes = mode_launch_counts()
    plain = RX.receive_minn_rtl_frames_plain(x, table, **args)
    torch.cuda.synchronize()
    mode = "int16" if x.dtype == torch.int16 else "float32"
    assert launch_counts()["minn_rx_front"] == launch_counts()["minn_rx_back"] == 1, what
    assert modes[f"minn_rx_front/{mode}"] == modes[f"minn_rx_back/{mode}"] == 1, (what, modes)
    K = min(max_frames, table.peak_idx.shape[1])
    assert out.eq.shape == (x.shape[1], K, args["sys"].num_active), what
    gaps = _gaps(out, plain, x, pilot, data, args["sys"], args["params"])
    for k, v in gaps.items():
        assert v <= LIMITS.get(k, LIMITS["eq_gap"]), (what, k, v)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("max_frames", [5, 16, 40])
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_cuda_kernels_match_the_plain_body(cuda, dtype, max_frames):
    """The frame cell's stimulus: max_frames below, at and above the
    table's 16 slots (clipped to them)."""
    cfg, x, table, pilot, data = _frames(2**31 + 41, cuda, dtype)
    out = _check(x, table, cfg, pilot, data, max_frames, f"{dtype} K={max_frames}")
    assert int(out.valid.sum()) >= BATCH * min(FRAMES, max_frames) - 1


@pytest.mark.gpu
@pytest.mark.parametrize("branches", [1, 2])
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_cuda_empty_and_clipped_slots(cuda, dtype, branches):
    """Slots past the row's count or not valid, and frames whose starts
    clip at both ends of the stream (the window shifted by up to 300
    samples, inside the CP), one branch or two."""
    cfg, x, table, pilot, data = _frames(9_876_543_219, cuda, dtype)
    x = x[: 2 * branches].contiguous()
    table = table._replace(valid=table.valid.clone(), count=table.count.clone(),
                           peak_idx=table.peak_idx.clone())
    L = x.shape[-1]
    table.valid[0, 1] = False                  # a slot below the count not valid
    table.count[1] = 2                         # valid slots past the count
    table.peak_idx[2, 0] = 6 * 512 - 300       # its start clips to 0
    table.valid[2, 0] = True
    table.peak_idx[3, 3] = L - 7680 + 3072 + 300  # its start clips to L - 7680
    table.valid[3, 3] = True
    table.count[3] = max(int(table.count[3]), 4)
    out = _check(x, table, cfg, pilot, data, 16, f"{dtype} branches={branches}")
    assert not bool(out.valid[0, 1]) and not bool(out.valid[1, 2:].any())
    assert int(out.starts[2, 0]) == 0 and int(out.starts[3, 3]) == L - 7680
    assert bool(out.valid[2, 0]) and bool(out.valid[3, 3])


def _chain(channel, device):
    """`run_fused_rx_minn_rtl`'s stimulus (two frames through the channel,
    float32 samples) and its one-stream table on the card."""
    sys_p, params = SYS_30M72, MinnRTLParams()
    rng = np.random.default_rng(0)
    pre = build_minn_rtl_preamble(params.seq_type, rng, Q=params.quarter_len, sys=sys_p)
    setup = common.build_setup(pre, rng, sys=sys_p, channel_name=channel, cir_mode="two",
                               snr_db=30.0 if channel is None else 10.0, cfo_hz=1000.0,
                               two_frames=True, device=device)
    rx = torch.cat([setup.rx, setup.rx.new_zeros((setup.rx.shape[0], sys_p.cp_len + 256))],
                   dim=-1)
    x, table = MinnRTLDetector(sys_p, params).detect_fused_table(rx)
    used = lambda v: torch.as_tensor(v, device=device).to(torch.complex64)  # noqa: E731
    return x, table, used(setup.pilot_used), used(setup.data_used)


@pytest.mark.gpu
@pytest.mark.parametrize("channel", [None, "cir2"])
def test_cuda_chain_stimulus(cuda, channel):
    """AWGN and cir2, as the chain builds them (float32 samples, one
    stream): both frames received, within the limits."""
    x, table, pilot, data = _chain(channel, cuda)
    cfg = _cell().config
    out = _check(x, table, cfg, pilot, data, 4, f"chain {channel}",
                 sys=SYS_30M72, params=MinnRTLParams())
    assert int(out.valid.sum()) == 2


@pytest.mark.gpu
def test_cuda_no_host_sync_and_repeatable(cuda):
    """A repeat call under set_sync_debug_mode("error") gives the same
    outputs, bit for bit (a host synchronisation inside the call raises)."""
    cfg, x, table, pilot, data = _frames(77, cuda)
    args = dict(**_kw(cfg), pilot_used=pilot, data_used=data, max_frames=16)
    first = RX.receive_minn_rtl_frames(x, table, **args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = RX.receive_minn_rtl_frames(x, table, **args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for f in RX.RxSlots._fields:
        assert torch.equal(getattr(first, f), getattr(again, f)), f


def _synthetic(sys_p, Q, dtype, branches, device, seed=0, batch=3, frames=3):
    """(codes (2*branches, batch, L), their table, pilot, data): each stream
    holds ``frames`` frames of [5Q of noise | CP + pilot | CP + data]
    (QPSK on the used bins of ``sys_p``) at seeded offsets, each branch
    with its own gain and phase, a CFO a stream within +-1 kHz, noise of 4
    codes; the table gives every frame (its peak 6Q past the frame's
    start) and one slot more that is not valid."""
    rng = np.random.default_rng(seed)
    pilot, pv = WV.build_random_qpsk_symbol(rng, sys_p)
    data, dv = WV.build_random_qpsk_symbol(rng, sys_p)
    frame = np.concatenate([np.zeros(5 * Q), pilot, data])
    seg = frame.size + 2 * Q
    L = frames * seg
    x = 4.0 * (rng.standard_normal((branches, batch, L))
               + 1j * rng.standard_normal((branches, batch, L)))
    peak = np.zeros((batch, frames + 1), np.int32)
    n = np.arange(frame.size)
    for b in range(batch):
        tone = np.exp(2j * np.pi * rng.uniform(-1000.0, 1000.0) / sys_p.sample_rate_hz * n)
        for f in range(frames):
            at = f * seg + int(rng.integers(0, 2 * Q))
            peak[b, f] = at + 6 * Q
            for br in range(branches):
                g = 200.0 * rng.uniform(0.5, 1.0) * np.exp(2j * np.pi * rng.uniform())
                x[br, b, at: at + frame.size] += g * frame * tone
    planes = np.stack([p for br in x for p in (br.real, br.imag)])
    codes = torch.from_numpy(np.round(planes).astype(np.float32)).to(dtype)
    valid = torch.ones((batch, frames + 1), dtype=torch.bool)
    valid[:, frames] = False
    table = _table(batch, frames + 1, valid=valid, peak_idx=torch.from_numpy(peak),
                   count=torch.full((batch,), frames + 1, dtype=torch.int32))
    table = table._replace(**{f: getattr(table, f).to(device) for f in table._fields})
    used = lambda v: torch.as_tensor(v, dtype=torch.complex64, device=device)  # noqa: E731
    return codes.to(device), table, used(pv), used(dv)


#: numerologies beside the flagship's: (system, Q, codes, branches); the
#: last reads its runs in place (beyond a CTA's shared memory in both kernels)
_NUMEROLOGIES = {
    "aa_10m": (SYS_AA_10M, 256, torch.int16, 2),
    "demo_512_all_bins": (SYS_DEMO_512, 128, torch.float32, 1),
    "cp_zero": (SYS_30M72.replace(cp_len=0), 512, torch.int16, 2),
    "three_branches": (SYS_30M72, 512, torch.float32, 3),
    "four_branches": (SYS_30M72, 512, torch.int16, 4),
    "in_place_n16384": (SystemParams(n_fft=16384, num_active=15000, cp_len=1024), 512,
                        torch.float32, 4),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_NUMEROLOGIES))
def test_cuda_other_numerologies(cuda, name):
    """Every numerology `SystemParams` admits: other N, CP and used bins
    (all N of them at the demo's 512), one to four branches, and runs too
    large for shared memory, against the plain body on the card."""
    sys_p, Q, dtype, branches = _NUMEROLOGIES[name]
    x, table, pilot, data = _synthetic(sys_p, Q, dtype, branches, cuda)
    out = _check(x, table, None, pilot, data, 8, name, sys=sys_p,
                 params=MinnRTLParams(quarter_len=Q, timing_offset=0))
    assert int(out.valid.sum()) == 9


#: views of the codes: a window in time, planes outermost in memory (stream
#: stride C L), a stride of 2 along time (read in place)
_VIEWS = {
    "time_window": lambda x: x[..., 8:],
    "planes_outer": lambda x: x.permute(1, 0, 2).contiguous().permute(1, 0, 2),
    "time_strided": lambda x: torch.repeat_interleave(x, 2, dim=-1)[..., ::2],
}


@pytest.mark.gpu
@pytest.mark.parametrize("view", sorted(_VIEWS))
def test_cuda_code_views(cuda, view):
    """Codes that are a view of other storage are read in place, through
    their strides, as the plain body reads them."""
    cfg, x, table, pilot, data = _frames(31, cuda)
    xv = _VIEWS[view](x)
    assert not xv.is_contiguous()
    out = _check(xv, table, cfg, pilot, data, 16, view)
    assert int(out.valid.sum()) >= BATCH * FRAMES - 2


@pytest.mark.gpu
def test_cuda_checks_raise_before_a_launch(cuda):
    """On the card too: codes of five branches or in float64 and a table on
    the host raise, and nothing runs."""
    cfg, x, table, pilot, data = _frames(5, cuda)
    args = dict(**_kw(cfg), pilot_used=pilot, data_used=data, max_frames=16)
    host = table._replace(**{f: getattr(table, f).cpu() for f in table._fields})
    reset_launch_counts()
    with pytest.raises(ValueError):
        RX.receive_minn_rtl_frames(torch.cat([x, x, x[:2]]), table, **args)
    with pytest.raises(TypeError):
        RX.receive_minn_rtl_frames(x.double(), table, **args)
    with pytest.raises(ValueError):
        RX.receive_minn_rtl_frames(x, host, **args)
    assert launch_counts()["minn_rx_front"] == launch_counts()["minn_rx_back"] == 0
