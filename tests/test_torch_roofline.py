"""The work counts of `ofdm_sync_tpu_torch.utils.roofline` reproduce the
bounds PERF.md's kernel table quotes at the bench's shapes (NVIDIA H100
SXM peaks at 700 W: 3.35 TB/s, 67 FP32 TFLOP/s), and `chip_smoke.py`
takes them from there instead of keeping its own copy."""

import os
import re

import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu_torch.utils import roofline as RL  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, T = 512, 1 << 18, 2048


@pytest.mark.parametrize("name,work,ms,by", [
    ("A", lambda: RL.a_work(B, L, 4, 4, 5), 0.841, "bytes"),
    ("A int16", lambda: RL.a_work(B, L, 4, 2, 5), 0.52, "bytes"),
    ("A full metric", lambda: RL.a_work(B, L, 4, 4, 13), 1.162, "bytes"),
    ("A corr/energy", lambda: RL.a_work(B, L, 4, 4, 8, scan=False), 0.962, "bytes"),
    ("C detect", lambda: RL.c_work(B, L, 4, 4, 17), 1.322, "bytes"),
    ("C int16", lambda: RL.c_work(B, L, 4, 2, 17), 1.002, "bytes"),
    ("D IQ", lambda: RL.d_iq_work(B, L + T - 1, L, 4, 4), 1.489, "bytes"),
    ("D magnitude", lambda: RL.d_mag_work(B, L), 0.20, "bytes"),
    ("E", lambda: RL.e_work(torch.empty((4, 64, L), device="meta"), T, L + T - 1), 0.161,
     "bytes"),
])
def test_bounds_match_the_kernel_table(name, work, ms, by):
    t, bound_by = RL.bound(*work())
    digits = len(str(ms).split(".")[1])
    assert round(t, digits) == ms, (name, t)
    assert bound_by == by


def test_e_flops_are_the_cheaper_fft_convolution():
    nbytes, flops = RL.e_work(torch.empty((4, 64, L), device="meta"), T, L + T - 1)
    assert nbytes == 538_983_424
    assert round(flops / 1e9, 2) == 6.13
    assert round(flops / RL.FP32_FLOP_PER_S * 1e3, 3) == 0.092


def test_bound_sum_and_gated_samples():
    above = torch.zeros((2, 100), dtype=torch.bool)
    above[0, 10] = above[1, 50] = above[1, 52] = True
    assert RL.gated_samples(above, 2) == 3 + 5  # [10, 12] and [50, 54]
    t, by = RL.bound_sum([(3.35e9, 0.0), (0.0, 67e9)])
    assert t == pytest.approx(2.0) and by in ("bytes", "operations")


def test_chip_smoke_keeps_no_copy_of_the_counts():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    for name in ("bound", "a_work", "b_work", "c_work", "d_mag_work", "d_iq_work", "e_work",
                 "gated_samples", "marginal_us", "minn_stimulus", "zc_iq_stimulus"):
        assert not re.search(rf"^def {name}\(", src, re.M), name
    assert "from ofdm_sync_tpu_torch.utils.roofline import" in src
