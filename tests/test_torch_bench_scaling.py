"""The port's scaling bench (`ofdm_sync_tpu_torch.bench_scaling`) on the CPU.

* Part (b) on 4 gloo ranks, meshes (4, 1), (2, 2) and (1, 4), Q = 32, a
  preamble across a seam: every rank's table equals the one-shot table,
  and the one-shot table equals JAX's unsharded detect
  (`kernels.streaming.minn_rtl_detect_planar` a stream at a time) on the
  same NumPy stimulus, ``peak_value`` within 1e-4 of max(1, |ref|);
* the collectives of one sharded call repeat exactly and equal the count
  worked out from the code (`expected_collectives`), checked here once
  more by hand for the (1, 4) mesh;
* int16 input on the int16 wire gives the same tables bit for bit, with
  half the halo bytes;
* part (d) holds on 2 ranks: the interior call is issued before the wait
  and reads nothing received;
* the projection's arithmetic matches hand-worked values;
* without a card the command exits non-zero and names the reason.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels.streaming import minn_rtl_detect_planar  # noqa: E402
from ofdm_sync_tpu_torch import bench_scaling as S  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks4():
    return S.part_ranks(4, seed=0)


def test_rank_tables_equal_one_shot_and_jax(ranks4):
    assert set(ranks4["meshes"]) == {f"data{d}xseq{s}_{t}" for d, s in ((4, 1), (2, 2), (1, 4))
                                     for t in ("f32", "int16")}
    assert all(m["tables_equal_one_shot"] for m in ranks4["meshes"].values())
    assert ranks4["events_one_shot"] >= ranks4["events_planted"]
    x, events = S.rank_stimulus(0)
    kw = S._kw(S.RANK_Q)
    one = F.minn_rtl_detect_fused(torch.from_numpy(x), **kw)
    jkw = {k: kw[k] for k in ("quarter_len", "smooth_shift", "threshold_value",
                              "threshold_frac_bits", "hysteresis", "max_events")}
    ref = jax.tree.map(lambda *a: np.stack(a), *(
        minn_rtl_detect_planar(jnp.asarray(x[:, b].reshape(2, 2, -1)), **jkw)[1]
        for b in range(x.shape[1])))
    assert_tables_equal(ref, one, "one-shot vs JAX", peak_rtol=1e-4)
    b, pos = events[0]  # across the middle seam
    peaks = one.peak_idx[b][one.valid[b]].tolist()
    assert any(5 * S.RANK_Q <= p - pos <= 7 * S.RANK_Q for p in peaks), peaks
    assert S.RANK_L // 2 in range(pos, pos + 5 * S.RANK_Q)


def test_collective_counts_repeat_and_match_the_code(ranks4):
    for name, m in ranks4["meshes"].items():
        assert m["counts_repeat"] and m["counts_as_coded"], name
    W = ranks4["halo_width_samples"]
    assert W == 354  # 3Q of delay line + the smoothing memory + h, at Q = 32
    # (1, 4): B_loc = 16, one halo batch (4 x 16 x W float32 from the left
    # neighbour), one all-gather of 16 x (5 x 8 + 2) int32, no all-reduce
    c = ranks4["meshes"]["data1xseq4_f32"]["collectives_per_call"]
    assert c["batch_isend_irecv"] == {"calls": 1, "bytes": 4 * 16 * W * 4,
                                      "recv_bytes": 4 * 16 * W * 4}
    assert c["all_gather"] == {"calls": 1, "bytes": 16 * 42 * 4}
    assert c["all_reduce"] == {"calls": 0, "bytes": 0}
    c = ranks4["meshes"]["data4xseq1_f32"]["collectives_per_call"]
    assert c["batch_isend_irecv"]["calls"] == 0 and c["all_gather"]["calls"] == 1
    assert S.expected_collectives(2, 0, 8, W, 2, 8)["batch_isend_irecv"] == {
        "calls": 1, "bytes": 4 * 8 * W * 2, "recv_bytes": 0}


def test_int16_wire_bit_identical(ranks4):
    assert ranks4["int16_wire_bit_identical"] and ranks4["int16_equals_f32_one_shot"]
    m = ranks4["meshes"]
    for mesh in ("data2xseq2", "data1xseq4"):
        f32, i16 = m[f"{mesh}_f32"], m[f"{mesh}_int16"]
        assert i16["halo_bytes_per_shard"] * 2 == f32["halo_bytes_per_shard"] > 0
    assert ranks4["holds"]


def test_overlap_structure_two_ranks():
    st = S.part_structure("cpu", seed=1)
    assert st["holds"] and st["interior_issued_before_wait"]
    assert not st["interior_reads_received"]
    interior, wait, first = st["order"]
    assert (interior["event"], wait["event"], first["event"]) == ("detect", "wait", "detect")
    start = S.RANK_L // 2
    assert interior["base_index"] == start + st["rows"] and first["base_index"] == start
    assert interior["samples"] == S.RANK_L // 2 - st["rows"] and first["samples"] == st["rows"]
    assert first["reads_received"]


def test_projection_matches_hand_worked_values():
    p = S.projection(1e11, 4.0, 8.0, 2, batch=512, L=262144, halo=1794, rows=2048)
    tc = 512 * 262144 / 1e11                    # 1.34217728 ms of one card
    halo32, gather = 4 * 512 * 1794 * 4, 512 * 42 * 4
    assert p["assumptions"]["halo_bytes_f32"] == 14_696_448
    assert p["assumptions"]["table_gather_bytes"] == 86_016
    # serialized, weak seq over NVLink: t = tc x 4 + (halo + gather) / bw + 2 x 10 us
    want = tc / (tc * 4.0 + (halo32 + gather) / 450e9 + 2 * 10e-6)
    assert p["halo_f32"]["weak_seq_8card_nvlink"] == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(0.247564, rel=1e-5)
    # serialized, strong seq on 2 hosts over IB, int16 halo
    t2 = tc / 2
    want = t2 / (t2 * 4.0 + (halo32 // 2 + gather) / 50e9 + 2 * 25e-6)
    assert p["halo_int16"]["strong_seq_2host_ib"] == pytest.approx(want, rel=1e-12)
    # overlap, weak seq over NVLink: the interior (1 - 2048 / 262144 of the
    # samples) outlasts the halo; then the first rows and the gather
    frac = 2048 / 262144
    t = tc * 8.0 * (1 - frac) + tc * 8.0 * frac + gather / 450e9 + 10e-6
    assert p["halo_f32_overlap"]["weak_seq_8card_nvlink"] == pytest.approx(tc / t, rel=1e-12)
    assert p["weak_data"] == {"efficiency_8card": 1.0, "efficiency_2host": 1.0}
    fast = S.projection(1e11, 0.5, 0.5, 2, batch=512, L=262144, halo=1794, rows=2048)
    assert fast["halo_f32_overlap"]["weak_seq_8card_nvlink"] == 1.0  # capped


def test_scaling_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "ofdm_sync_tpu_torch.bench_scaling"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "no CUDA device" in p.stderr and "{" not in p.stdout
