"""The port's sharded Minn-RTL receive chain (`parallel.shard`) against the
JAX package, over four gloo ranks on the CPU.

One module-scoped `run_ranks` of 4 ranks (`tests/torch_shard_ranks.py`,
which imports no JAX) runs every configuration on meshes (1, 4) and (2, 2):
`sharded_minn_rtl_detect_fused` with the overlap split on and off, float32
and int16, ``emit_unclosed`` both ways; `sharded_minn_rtl_receive`; and the
detect of a second stimulus.  Stimulus of tests/test_sharded_tm.py: Q = 32,
4 streams of 4,096 samples, rows = 512, preambles across the seams of the
four 1,024-sample shards, gates open across a seam, closing within h of
one, and across the overlap split.
Every rank's merged table is held to:

* JAX's unsharded `minn_rtl_detect_fused_tm` (Pallas interpret mode) on
  the same input, for every configuration;
* once, JAX's `sharded_minn_rtl_detect_fused` (``channel_leading=True``)
  on the 8-device CPU mesh, on tests/test_sharded_detect.py's stimulus at
  the size its quick test runs;

and the frames to JAX's `extract_frames_batched` on the whole stream and
JAX's `sharded_extract_frames` on the 8-device mesh.  Tolerances as in
tests/test_sharded_tm.py: integer fields equal, peak values within 1e-4 of
the largest peak; frames (copies of input samples) equal.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels.pallas_minn_tm import (  # noqa: E402
    minn_rtl_detect_fused_tm,
    to_time_tiled,
)
from ofdm_sync_tpu.kernels.streaming import to_planar  # noqa: E402
from ofdm_sync_tpu.ops.extract import extract_frames_batched  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_minn_rtl_preamble  # noqa: E402
from ofdm_sync_tpu.parallel.shard import (  # noqa: E402
    make_stream_mesh,
    sharded_extract_frames,
    sharded_minn_rtl_detect_fused,
)
from ofdm_sync_tpu_torch.parallel import distributed  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402
from test_torch_sc import no_jax_cache_writes  # noqa: E402,F401
from torch_shard_ranks import minn_rank  # noqa: E402

Q = 32
KW = dict(quarter_len=Q, smooth_shift=3, threshold_value=3276, threshold_frac_bits=15,
          hysteresis=2)
ROWS = 512
L = 4096
BLOCK = L // 4
BATCH = 4
PEAK_RTOL = 1e-4
#: tests/test_sharded_tm.py's preambles on the seams, then (a preamble's
#: above run lies ~176-229 samples after it) runs across a seam, ending
#: within h of a seam, and across the overlap split (rows into a shard)
SEAM_EVENTS = [(0, BLOCK - 3 * Q), (1, 2 * BLOCK - 2 * Q), (2, 3 * BLOCK - 4 * Q),
               (3, BLOCK - Q), (0, 2 * BLOCK - 200), (1, 3 * BLOCK - 230),
               (2, BLOCK + ROWS - 200), (3, 2 * BLOCK + ROWS - 3 * Q)]
#: (frame_len, timing_offset, max_frames): windows that open before the
#: preamble and span the seams; more frames than slots
FRAMES = [(300, -6 * Q - 100, 4), (700, -6 * Q, 10)]
MESHES = [(1, 4), (2, 2)]


def _stimulus(rng):
    """tests/test_sharded_tm.py:_stimulus: 0.25 N(0, 1) noise, 3x the 5Q
    preamble [-A, A, A, -A, -A] on every branch."""
    x = (0.25 * rng.standard_normal((4, BATCH, L))).astype(np.float32)
    A = rng.standard_normal(Q) + 1j * rng.standard_normal(Q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    for b, pos in SEAM_EVENTS:
        for c, comp in ((0, pre.real), (1, pre.imag), (2, pre.real), (3, pre.imag)):
            x[c, b, pos: pos + 5 * Q] += 3 * comp.astype(np.float32)
    return x


def _dsd_stimulus(rng):
    """tests/test_sharded_detect.py:_streams(boundary_positions=True), as
    the channel-leading (4, 4, 4096) layout."""
    iq = np.zeros((BATCH, 2, 2, L), np.float32)
    for b in range(BATCH):
        sig = np.zeros(L, complex)
        pos = L // 4 - 3 * Q + (b % 2) * (L // 4)
        pre = build_minn_rtl_preamble("qpsk_freq", rng=np.random.default_rng(b), Q=Q)
        sig[pos: pos + 5 * Q] = pre
        rx = np.stack([sig, 0.8 * sig])
        rx = rx + 0.05 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
        iq[b] = np.asarray(to_planar(jnp.asarray(rx)))
    return np.ascontiguousarray(iq.reshape(BATCH, 4, L).transpose(1, 0, 2))


def _jax_detect(x, emit):
    xt, _, _ = to_time_tiled(jnp.asarray(x), ROWS)
    return minn_rtl_detect_fused_tm(xt, **KW, rows=ROWS, stream_len=L, batch=BATCH,
                                    emit_unclosed=emit)


def _rows(table, d: int, nd: int):
    """The rows of data slice d of a JAX table, as host arrays."""
    bb = BATCH // nd
    return SimpleNamespace(**{f: np.asarray(getattr(table, f))[d * bb: (d + 1) * bb]
                              for f in table._fields})


def _table(arrays: dict):
    return SimpleNamespace(**arrays)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    x, dsd = _stimulus(rng), _dsd_stimulus(np.random.default_rng(0))
    ranks = distributed.run_ranks(minn_rank, 4, (x, dsd, KW, ROWS, FRAMES), timeout_s=600)
    return x, dsd, ranks


def test_ranks_import_no_jax(runs):
    for out in runs[2]:
        assert out["modules"] == []


def test_global_mesh_and_halo_exchange(runs):
    """`make_global_stream_mesh` puts all four ranks on seq; `halo_exchange`
    extends each block by the 37 samples before it and the 5 after it in
    the whole stream, zeros past either end, in the block's dtype
    (`shard.py:45`)."""
    x, _, ranks = runs
    x16 = np.round(np.clip(x, -1, 1) * 2047).astype(np.int16)
    for r, out in enumerate(ranks):
        assert out["global_mesh"] == (1, 4, 0, r)
        for nd, ns in MESHES:
            for dtype, a in (("f32", x), ("i16", x16)):
                d, s, got = out["halo", nd, ns, dtype]
                bb, bl = BATCH // nd, L // ns
                padded = np.pad(a[:, d * bb: (d + 1) * bb], ((0, 0), (0, 0), (37, 5)))
                want = padded[..., s * bl: s * bl + bl + 42]
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want, err_msg=f"rank {r} {(nd, ns)} {dtype}")


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "i16"])
def test_sharded_detect_matches_unsharded_tm_kernel(runs, dtype, emit):
    x, _, ranks = runs
    xin = x if dtype == "f32" else np.round(np.clip(x, -1, 1) * 2047).astype(np.int16)
    ref = _jax_detect(xin, emit)
    assert (np.asarray(ref.count) >= 1).all()
    seen = 0
    for r, out in enumerate(ranks):
        for nd, ns in MESHES:
            for overlap in (False, True):
                d, table = out["detect", nd, ns, dtype, overlap, emit]
                assert_tables_equal(_rows(ref, d, nd), _table(table),
                                    f"rank {r} mesh {(nd, ns)} overlap {overlap}", PEAK_RTOL)
                seen += 1
    assert seen == 16


def test_sharded_detect_matches_jax_sharded(runs):
    """The port on meshes (1, 4) and (2, 2) against JAX's channel-leading
    sharded detect on its 8-device mesh (2, 4), kernel_block 512."""
    _, dsd, ranks = runs
    mesh = make_stream_mesh(n_data=2, n_seq=4)
    ref = sharded_minn_rtl_detect_fused(jnp.asarray(dsd), mesh, **KW, kernel_block=512,
                                        channel_leading=True, interpret=True)
    assert (np.asarray(ref.count) >= 1).all()
    for r, out in enumerate(ranks):
        for nd, ns in MESHES:
            d, table = out["dsd", nd, ns]
            assert_tables_equal(_rows(ref, d, nd), _table(table), f"rank {r} mesh {(nd, ns)}",
                                PEAK_RTOL)


@pytest.mark.parametrize("cfg", range(len(FRAMES)))
def test_sharded_receive_matches_jax_frames(runs, cfg):
    """Table, frames, starts and valid of `sharded_minn_rtl_receive`
    against JAX's unsharded table and `extract_frames_batched`, and
    against JAX's `sharded_extract_frames` on the 8-device mesh."""
    x, _, ranks = runs
    frame_len, offset, max_frames = FRAMES[cfg]
    ref = _jax_detect(x, False)
    fkw = dict(frame_len=frame_len, timing_offset=offset, max_frames=max_frames)
    one = extract_frames_batched(jnp.asarray(x.transpose(1, 0, 2)), ref, **fkw)
    mesh = make_stream_mesh(n_data=2, n_seq=4)
    shd = sharded_extract_frames(jnp.asarray(x), ref, mesh, **fkw)
    for a, b in zip(one, shd):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(one[2]).sum() >= BATCH
    for r, out in enumerate(ranks):
        for nd, ns in MESHES:
            d, table, frames = out["receive", nd, ns, cfg]
            what = f"rank {r} mesh {(nd, ns)}"
            assert_tables_equal(_rows(ref, d, nd), _table(table), what, PEAK_RTOL)
            bb = BATCH // nd
            for name, want, got in zip(("frames", "starts", "valid"), one, frames):
                want = np.asarray(want)[d * bb: (d + 1) * bb]
                assert got.dtype == want.dtype, (what, name)
                np.testing.assert_array_equal(got, want, err_msg=f"{what} {name}")
