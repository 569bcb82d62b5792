"""`correct` on the CPU at small sizes: the program's plain path passes;
the control (the reference in bfloat16 in the program's place) and each
fault a cell can have, planted under the timed path, make it false."""

import pytest
import torch

from benchmark import harness as H
from benchmark import run as R
from ofdm_sync_tpu_torch.kernels import matched_filter as MF
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F
from ofdm_sync_tpu_torch.kernels import streaming_chunked as ST
from ofdm_sync_tpu_torch.kernels import zc_fused as ZF

CPU = torch.device("cpu")
SMALL = {
    "minn_rtl_fpga.sweep": dict(batch=6, samples=1 << 15, distinct=2),
    "zc_v2_cfar.sweep": dict(batch=4, samples=1 << 14, distinct=2),
    "minn_rtl_fpga.live": dict(streams=3, block=4096, ring_samples=1 << 15, check_blocks=4,
                               preambles_per_stream=6,
                               warmup_blocks=2),
}
SEED = 2**31 + 12345


def small(name: str) -> H.Cell:
    cell = H.Cell(H.load_spec(), name)
    cell.traffic.update(SMALL[name])
    if cell.loop == "open":  # a block every 25 ms, which the plain step keeps up with
        cell.config["system"]["sample_rate_hz"] = 4096 / 0.025
    return cell


def run(name: str, seconds: float = 0.3) -> dict:
    return R.run_cell(small(name), SEED, seconds, False, CPU)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["line"]["correct"], res["checks"]
    assert res["line"]["failed"] == 0
    assert res["info"]["events"] > 0


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_incorrect(name):
    res = run(name)
    cell = small(name)
    verdict = cell.module("reference").judge(cell.config, res["record"], control=True)
    assert not H.passed(verdict["checks"]), verdict["checks"]


def _altered(table):
    """Every valid event's peak index moved by one sample."""
    return table._replace(peak_idx=torch.where(table.valid, table.peak_idx + 1, table.peak_idx))


def _half(fn):
    """The second half of the batch left out: its rows come back empty."""
    def wrapped(*args, **kw):
        table = fn(*args, **kw)
        half = table.valid.shape[0] // 2
        return table._replace(valid=torch.cat([table.valid[:half],
                                               torch.zeros_like(table.valid[half:])]),
                              count=torch.cat([table.count[:half],
                                               torch.zeros_like(table.count[half:])]))
    return wrapped


def test_minn_detect_faults(monkeypatch):
    name = "minn_rtl_fpga.sweep"
    real = F.minn_rtl_detect_fused
    monkeypatch.setattr(F, "minn_rtl_detect_fused", lambda *a, **k: _altered(real(*a, **k)))
    assert not run(name)["line"]["correct"]
    monkeypatch.setattr(F, "minn_rtl_detect_fused", _half(real))
    assert not run(name)["line"]["correct"]


def test_zc_faults(monkeypatch):
    name = "zc_v2_cfar.sweep"
    real_d, real_e = ZF.zc_iq_cfar_detect, MF.matched_filter_ols
    monkeypatch.setattr(ZF, "zc_iq_cfar_detect", lambda *a, **k: _altered(real_d(*a, **k)))
    assert not run(name)["line"]["correct"]
    monkeypatch.setattr(ZF, "zc_iq_cfar_detect", _half(real_d))
    assert not run(name)["line"]["correct"]
    monkeypatch.setattr(ZF, "zc_iq_cfar_detect", real_d)
    monkeypatch.setattr(MF, "matched_filter_ols", lambda *a, **k: real_e(*a, **k) * 1.001)
    res = run(name)
    assert not res["line"]["correct"] and res["checks"]["mf_rel_err"][0] > 1e-4


def test_live_faults(monkeypatch):
    name = "minn_rtl_fpga.live"
    real = ST.minn_rtl_fused_stream_step

    def unchanged(state, chunk, **kw):
        return state, real(state, chunk, **kw)[1]

    monkeypatch.setattr(ST, "minn_rtl_fused_stream_step", unchanged)
    res = run(name)
    assert not res["line"]["correct"] and res["checks"]["state_mismatch"][0] > 0

    def altered(state, chunk, **kw):
        state, table = real(state, chunk, **kw)
        return state, _altered(table)

    monkeypatch.setattr(ST, "minn_rtl_fused_stream_step", altered)
    assert not run(name, 1.0)["line"]["correct"]

    def half(state, chunk, **kw):
        return real(state, chunk, **kw)[0], _half(lambda: real(state, chunk, **kw)[1])()

    monkeypatch.setattr(ST, "minn_rtl_fused_stream_step", half)
    assert not run(name, 1.0)["line"]["correct"]


@pytest.mark.gpu
def test_small_cell_on_card():
    """A short window of the Minn sweep at a small size on the card: the
    kernels build, and the line is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = small("minn_rtl_fpga.sweep")
    res = R.run_cell(cell, SEED, 0.5, True, torch.device("cuda", 0))
    assert res["line"]["correct"], res["checks"]
    assert res["line"]["device"]["busy_s"] > 0
