"""The `minn_rtl_rx` configuration of the benchmark on the CPU at small
sizes: the cell's `correct` for a sound run, for the bfloat16 control and
for each fault planted in the program's receive or in what it keeps; the
frame (`preambles/minn_rtl_frame.py`) against the port's symbol recipe; the receive's work count;
and the entry's import of the receive at its top, which a program without
the receive fails at once.  This file imports no JAX."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import harness as H  # noqa: E402
from benchmark import run as R  # noqa: E402
from benchmark.entries import minn_rx as ENTRY  # noqa: E402
from benchmark.preambles import minn_rtl, minn_rtl_frame  # noqa: E402
from benchmark.reference import minn_rtl_rx as REF  # noqa: E402
from benchmark.work.counts import bound_s  # noqa: E402
from benchmark.work.rx_counts import rx_demod_work  # noqa: E402
from ofdm_sync_tpu_torch.ops.waveforms import build_random_qpsk_symbol  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import fused_rx as RX  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELL = "minn_rtl_rx.frames"
CPU = torch.device("cpu")
SEED = 2**31 + 2323
#: 4 streams of 2^16 samples, 4 frames each, 2 distinct batches
SMALL = dict(batch=4, samples=1 << 16, distinct=2, preambles_per_stream=4)


def small() -> H.Cell:
    cell = H.Cell(H.load_spec(ROOT), CELL, ROOT)
    cell.traffic.update(SMALL)
    return cell


def run(seed: int = SEED) -> dict:
    return R.run_cell(small(), seed, 0.3, False, CPU)


@pytest.mark.parametrize("seed", [SEED, 17])
def test_sound_run_is_correct(seed):
    res = run(seed)
    assert res["line"]["correct"], res["checks"]
    assert res["line"]["failed"] == 0
    assert res["info"]["slots_compared"] >= 4 * 4 * 2 - 2
    assert set(res["checks"]) == set(REF.LIMITS)


def test_control_is_incorrect():
    """The receive with the frame samples and the FFT bins stored in
    bfloat16 breaks a limit of the receive, and its detection those of the
    tables."""
    cell = small()
    res = R.run_cell(cell, SEED, 0.3, False, CPU)
    c = REF.judge(cell.config, res["record"], control=True)["checks"]
    assert not H.passed(c)
    assert any(c[k][0] > c[k][1] for k in REF.RX_CHECKS), c


def _wrapped(change):
    """The entry's receive with ``change(out) -> out`` applied to its slots."""
    real = RX.receive_minn_rtl_frames

    def fn(*a, **k):
        return change(real(*a, **k))
    return fn


def _moved(out):
    """Every valid slot's start moved by one sample."""
    return out._replace(starts=torch.where(out.valid, out.starts + 1, out.starts))


def _bf16(out):
    """The equalized bins stored in bfloat16."""
    eq = out.eq
    low = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    return out._replace(eq=torch.complex(low(eq.real), low(eq.imag)))


@pytest.mark.parametrize("change,check", [(_moved, "start_mismatch"), (_bf16, "eq_gap")])
def test_fault_in_the_kept_outputs_is_incorrect(monkeypatch, change, check):
    monkeypatch.setattr(ENTRY, "receive_minn_rtl_frames", _wrapped(change))
    res = run()
    assert not res["line"]["correct"] and res["line"]["failed"] > 0
    value, limit = res["checks"][check]
    assert value > limit, res["checks"]


def test_flipped_cfo_is_incorrect(monkeypatch):
    """The CP CFO's sign flipped inside the program's call: the frames are
    turned the wrong way too."""
    real = RX.cfo_from_cp_windows
    monkeypatch.setattr(RX, "cfo_from_cp_windows", lambda *a, **k: -real(*a, **k))
    res = run()
    assert not res["line"]["correct"]
    assert res["checks"]["cfo_gap_hz"][0] > res["checks"]["cfo_gap_hz"][1]


def test_data_bins_swapped_for_pilot_bins_is_incorrect(monkeypatch):
    """One slot's data bins replaced by its pilot bins before equalization."""
    real_ls, real_eq = RX.ls_channel_estimate, RX.equalize
    seen = {}

    def ls(y, x, *a, **k):
        seen["pilot"] = y
        return real_ls(y, x, *a, **k)

    def eq(y, h, *a, **k):
        y = y.clone()
        y[0, 0] = seen["pilot"][0, 0]
        return real_eq(y, h, *a, **k)

    monkeypatch.setattr(RX, "ls_channel_estimate", ls)
    monkeypatch.setattr(RX, "equalize", eq)
    res = run()
    assert not res["line"]["correct"]
    c = res["checks"]
    assert c["eq_gap"][0] > c["eq_gap"][1] and c["evm_gap"][0] > c["evm_gap"][1]


def test_frame_symbols_are_the_port_recipe():
    """`minn_rtl_frame`'s pilot and data equal `build_random_qpsk_symbol`
    drawn twice from the same seed (values and time samples with their CP),
    after the `minn_rtl` preamble; each part has unit power before its CP."""
    cfg = json.loads((ROOT / "benchmark/configs/minn_rtl_rx.json").read_text())
    rng = np.random.default_rng(cfg["preamble"]["symbols_seed"])
    p_td, p_used = build_random_qpsk_symbol(rng)
    d_td, d_used = build_random_qpsk_symbol(rng)
    pilot, data = minn_rtl_frame.symbols(cfg)
    np.testing.assert_array_equal(pilot, p_used)
    np.testing.assert_array_equal(data, d_used)
    t = minn_rtl_frame.template(cfg)
    Q, sym = cfg["detector"]["quarter_len"], 2048 + 512
    assert t.shape == (5 * Q + 2 * sym,) == (7680,)
    np.testing.assert_array_equal(t[: 5 * Q], minn_rtl.template(cfg))
    np.testing.assert_allclose(t[5 * Q: 5 * Q + sym], p_td, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t[5 * Q + sym:], d_td, rtol=0, atol=1e-12)
    for part in (t[: 5 * Q], t[5 * Q + 512: 5 * Q + sym], t[-2048:]):
        assert np.mean(np.abs(part) ** 2) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("batch,K", [(512, 16), (3, 5)])
def test_work_count_by_hand(batch, K):
    C, N, cp, A, E = 4, 2048, 512, 1200, 16
    nbytes, flops = rx_demod_work(batch, K, C, 2, N, cp, A, E)
    # 5,120 samples of 4 int16 planes a slot; peak_idx and valid a table
    # slot and the count; 25 B of outputs and 1,200 complex64 bins a slot
    assert nbytes == batch * K * 5120 * 8 + batch * (16 * 5 + 4) + batch * K * (25 + 9600)
    per = 8 * 2 * 512 + 8 * 2 * 2 * 2048 + 2 * 5 * 2048 * 11 + 49 * 1200
    assert flops == batch * K * per
    if batch == 512:  # the cell's bound: its bytes, ~0.124 ms
        assert bound_s(nbytes, flops) == pytest.approx(0.1237e-3, rel=1e-3)


def test_entry_imports_the_receive_at_its_top():
    """A program without `receive_minn_rtl_frames` fails the cell when the
    entry is imported, before any input is made."""
    tree = ast.parse((ROOT / "benchmark/entries/minn_rx.py").read_text())
    tops = [n for n in tree.body if isinstance(n, ast.ImportFrom)]
    assert any(n.module == "ofdm_sync_tpu_torch.pipelines.fused_rx"
               and [a.name for a in n.names] == ["receive_minn_rtl_frames"] for n in tops)
    assert ENTRY.Entry.stages == ("detect_call", "demod_call")


@pytest.mark.gpu
def test_small_rx_cell_on_card():
    """A short traced window of the frame sweep at a small size on the card:
    the line is correct and the shares of both stages are read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = R.run_cell(small(), SEED, 0.5, True, torch.device("cuda", 0))
    assert res["line"]["correct"], res["checks"]
    for share in ("rx_demod.roofline", "minn_detect.roofline.sweep"):
        assert 0 < res["line"]["metrics"][share]["value"] <= 100
