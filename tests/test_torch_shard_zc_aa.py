"""The port's sharded from-IQ ZC and [A][A] detectors (`parallel.shard`)
against the JAX package, over four gloo ranks on the CPU.

One module-scoped `run_ranks` of 4 ranks (`tests/torch_shard_ranks.py`,
which imports no JAX) runs, on meshes (1, 4) and (2, 2):

* `sharded_zc_iq_detect` (kernel D's primed IQ mode + kernel B carried per
  shard, then the table merge) on tests/test_torch_zc_iq_shard.py's
  stimulus (R = W = 128, h = 16, Lc = 4,096 in four 1,024-sample shards,
  integer IQ zero-padded to Lc and its exact integer matched filter,
  templates on the seams), IQ as float32 and int16, against JAX's
  unsharded `zc_iq_cfar_detect_tm` (Pallas interpret mode);
* `sharded_aa_detect_fused` (kernel C primed + kernel B carried with
  capture) on tests/test_sharded_detect.py's [A][A] stimulus (L = 128,
  400 Hz CFO, preambles across the seams of four 1,024-sample shards),
  against JAX's unsharded `aa_detect_fused_pallas` and, once, JAX's
  `sharded_aa_detect_fused` on the 8-device CPU mesh (2, 4), the
  (P_re, P_im, M) captured at each peak included.

Tolerances: integer fields equal; peak values, and each captured field,
within 1e-4 of the largest reference value (JAX sums its windows in
float32, the port in float64).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels.pallas_aa import aa_detect_fused_pallas  # noqa: E402
from ofdm_sync_tpu.kernels.pallas_zc_tm import to_time_tiled, zc_iq_cfar_detect_tm  # noqa: E402
from ofdm_sync_tpu.kernels.streaming import to_planar  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_aa_preamble  # noqa: E402
from ofdm_sync_tpu.params import SYS_AA_10M  # noqa: E402
from ofdm_sync_tpu.parallel.shard import make_stream_mesh, sharded_aa_detect_fused  # noqa: E402
from ofdm_sync_tpu_torch.parallel import distributed  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402
from test_torch_sc import no_jax_cache_writes  # noqa: E402,F401
from test_torch_zc_iq_shard import (  # noqa: E402
    KW as ZC_KW,
    L as ZC_L,
    LC,
    REF_NORM,
    RF,
    ROWS,
    SEAM_EVENTS as ZC_EVENTS,
    _stimulus as zc_stimulus,
)
from torch_shard_ranks import zc_aa_rank  # noqa: E402

BATCH = 4
PEAK_RTOL = 1e-4
MESHES = [(1, 4), (2, 2)]
AA_TOTAL, AA_N = 256, 4096
AA_KW = dict(half_len=AA_TOTAL // 2, threshold=0.15, hysteresis=128)
#: preambles across the seams at 1024, 2048 and 3072, and one inside a shard
AA_POS = [1024 - 128, 2048 - 64, 3072 - 200, 1536]


def _aa_stimulus(rng):
    """tests/test_sharded_detect.py's [A][A] stimulus: the preamble under a
    400 Hz CFO on branch 0 and at 0.7x on branch 1, complex noise 0.02;
    channel-leading (4, BATCH, AA_N)."""
    pre, _, _ = build_aa_preamble(AA_TOTAL)
    fs = SYS_AA_10M.sample_rate_hz
    iq = np.zeros((BATCH, 2, 2, AA_N), np.float32)
    for b, pos in enumerate(AA_POS):
        sig = np.zeros(AA_N, complex)
        sig[pos: pos + AA_TOTAL] = pre
        sig = sig * np.exp(2j * np.pi * 400.0 * np.arange(AA_N) / fs)
        rx = np.stack([sig, 0.7 * sig])
        rx = rx + 0.02 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
        iq[b] = np.asarray(to_planar(jnp.asarray(rx)))
    return np.ascontiguousarray(iq.reshape(BATCH, 4, AA_N).transpose(1, 0, 2))


def _rows(arrays: dict, d: int, nd: int):
    bb = BATCH // nd
    return SimpleNamespace(**{f: np.asarray(a)[d * bb: (d + 1) * bb] for f, a in arrays.items()})


def _jax_arrays(table) -> dict:
    return {f: np.asarray(getattr(table, f)) for f in table._fields}


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PEAK_RTOL * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@pytest.fixture(scope="module")
def runs():
    mf, iq = zc_stimulus(7, BATCH, ZC_EVENTS)
    iqp = np.zeros(mf.shape, np.float32)
    iqp[..., :ZC_L] = iq
    aa = _aa_stimulus(np.random.default_rng(0))
    zc_kw = dict(ZC_KW, ref_len=RF, ref_norm=REF_NORM, stream_len=LC)
    ranks = distributed.run_ranks(zc_aa_rank, 4, (mf, iqp, zc_kw, aa, AA_KW), timeout_s=600)
    return mf, iqp, aa, ranks


def test_ranks_import_no_jax(runs):
    for out in runs[-1]:
        assert out["modules"] == []


def test_sharded_zc_iq_matches_unsharded_tm_kernel(runs):
    mf, iqp, _, ranks = runs
    mft, _, _ = to_time_tiled(jnp.asarray(mf), ROWS)
    iqt, _, _ = to_time_tiled(jnp.asarray(iqp), ROWS)
    ref = _jax_arrays(zc_iq_cfar_detect_tm(mft, iqt, ref_len=RF, ref_norm=REF_NORM,
                                           stream_len=LC, batch=BATCH, rows=ROWS, interpret=True,
                                           emit_unclosed=True, **ZC_KW))
    assert (ref["count"] >= 1).all()
    for r, out in enumerate(ranks):
        for nd, ns in MESHES:
            for dtype in ("f32", "i16"):
                d, table = out["zc", nd, ns, dtype]
                assert_tables_equal(_rows(ref, d, nd), SimpleNamespace(**table),
                                    f"rank {r} mesh {(nd, ns)} {dtype}", PEAK_RTOL)


@pytest.mark.parametrize("sharded", [False, True])
def test_sharded_aa_matches_jax(runs, sharded):
    """Against the unsharded fused kernel, and against JAX's own sharded
    detect on its 8-device mesh (2, 4)."""
    _, _, aa, ranks = runs
    if sharded:
        tab, P, M = sharded_aa_detect_fused(jnp.asarray(aa), make_stream_mesh(n_data=2, n_seq=4),
                                            **AA_KW, kernel_block=512, channel_leading=True,
                                            interpret=True)
    else:
        tab, P, M = aa_detect_fused_pallas(jnp.asarray(aa), **AA_KW, block=512,
                                           channel_leading=True, interpret=True)
    ref = _jax_arrays(tab)
    assert (ref["count"] >= 1).all()
    for r, out in enumerate(ranks):
        for nd, ns in MESHES:
            d, table, P_t, M_t = out["aa", nd, ns]
            what = f"rank {r} mesh {(nd, ns)}"
            assert_tables_equal(_rows(ref, d, nd), SimpleNamespace(**table), what, PEAK_RTOL)
            bb = BATCH // nd
            for k, name in enumerate(("P_re", "P_im")):
                _close(P_t[:, k], np.asarray(P)[d * bb: (d + 1) * bb, k], f"{what} {name}")
            _close(M_t, np.asarray(M)[d * bb: (d + 1) * bb], f"{what} M")
