"""The benchmark's frozen work counts equal the port's `utils/roofline.py`
at today's shapes (the copy must not drift while the program's stays)."""

import pytest
import torch

from benchmark.work import counts as W
from ofdm_sync_tpu_torch.utils import roofline as R

SHAPES = [(512, 1 << 18), (1, 1 << 24), (128, 16384), (3, 1000)]


@pytest.mark.parametrize("batch,L", SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_a_f_d_work(batch, L, itemsize):
    assert W.a_work(batch, L, 4, itemsize, 5) == R.a_work(batch, L, 4, itemsize, 5)
    assert W.a_work(batch, L, 4, itemsize, 8, scan=False) == R.a_work(batch, L, 4, itemsize, 8,
                                                                      scan=False)
    assert W.f_work(batch, L, 4, itemsize, 1536, 777) == R.f_work(batch, L, 4, itemsize, 1536, 777)
    assert W.d_iq_work(batch, L + 2047, L, 4, itemsize) == R.d_iq_work(batch, L + 2047, L, 4,
                                                                       itemsize)


@pytest.mark.parametrize("batch,L", SHAPES)
@pytest.mark.parametrize("E", [8, 16])
def test_b_work(batch, L, E):
    above = torch.zeros((batch, L), dtype=torch.bool)
    assert W.b_work(batch, L, 4321, E=E) == R.b_work(above, 4321, E=E)


@pytest.mark.parametrize("batch,L", [(512, 1 << 18), (64, 1 << 18), (2, 5000)])
def test_e_work(batch, L):
    x = torch.empty((4, batch, L), device="meta")
    assert W.e_work(4, batch, L, 2048, L + 2047) == R.e_work(x, 2048, L + 2047)


def test_e_geometry_frozen():
    from ofdm_sync_tpu_torch.kernels import matched_filter as MF

    assert (W.FFT_SIZE, W.DISCARD) == (MF.FFT_SIZE, MF.DISCARD)


@pytest.mark.parametrize("h", [1, 2, 256])
def test_gated_samples(h):
    g = torch.Generator().manual_seed(h)
    above = torch.rand((6, 5000), generator=g) > 0.97
    assert W.gated_samples(above, h) == R.gated_samples(above, h)


def test_peaks():
    assert (W.HBM_BYTES_PER_S, W.FP32_FLOP_PER_S) == (R.HBM_BYTES_PER_S, R.FP32_FLOP_PER_S)


@pytest.mark.parametrize("batch,L", SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_stage_functions_count_no_intermediates(batch, L, itemsize):
    """A stage's function reads its inputs and writes its table once: the
    kernels' counts less what they pass between them (A's corr and above,
    5 bytes a sample, and B's read of above; D's mag and above, and B's
    read of above), with the same flops."""
    gated = 4321
    a, b = W.a_work(batch, L, 4, itemsize, 5), W.b_work(batch, L, gated, E=8)
    between = batch * L * 5 + batch * L + 4 * gated + 8 * batch
    assert W.minn_detect_work(batch, L, 4, itemsize, gated, E=8) == (
        a[0] + b[0] - between, a[1] + b[1])
    Lc = L + 2047
    d, b = W.d_iq_work(batch, Lc, L, 4, itemsize), W.b_work(batch, Lc, gated, E=16)
    between = batch * Lc * 5 + batch * Lc + 4 * gated
    assert W.zc_detect_work(batch, Lc, L, 4, itemsize, gated, E=16) == (
        d[0] + b[0] - between, d[1] + b[1])
