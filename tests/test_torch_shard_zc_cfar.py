"""The port's sharded ZC detectors (`parallel.shard.sharded_zc_cfar_detect`
and `sharded_zc_detect`) against the JAX package, over four gloo ranks on
the CPU.

One module-scoped `run_ranks` of 4 ranks (`tests/torch_shard_ranks.py`,
which imports no JAX) runs on meshes (1, 4) and (2, 2), with the stimuli
of tests/test_sharded_detect.py:212-385:

* `sharded_zc_cfar_detect` on 2 streams of 8,192 magnitudes (0.05 |N(0,
  1)| with three 5-sample peaks, one a stream on a (1, 4) seam), made
  dyadic (multiples of 2^-10) so that every window sum is exact on both
  sides; W = 256, h = 64.  Held to JAX's `sharded_zc_cfar_detect` on its
  8-device mesh (2, 4) and to JAX's unsharded `zc_cfar_detect_pallas`
  (interpret mode);
* `sharded_zc_detect` from 2-branch complex IQ: the 256-sample PSS of the
  small system (W = 256, 2 streams of 6,144) and the 2,048-sample PSS of
  the 30.72 MHz system (W = 1,024, 2 streams of 16,384), whose matched
  filter is kernel E's (on the CPU its plain version, the complex64 FFT
  convolution), and a 2,311-sample Zadoff-Chu template, longer than
  kernel E's `MAX_TAPS` (W = 512, 2 streams of 12,288), whose matched
  filter is the torch FFT convolution.  Each held to JAX's
  `sharded_zc_detect` on the mesh (2, 4) (``mf_mode`` 'xla', and 'mxu'
  for the small template: the Pallas matmul DFT in interpret mode) and to
  JAX's unsharded `zc_cfar_detect_pallas` on
  `zc_normalized_correlation_per_branch`'s magnitudes truncated to L.

Tolerances, as tests/test_sharded_detect.py's: every integer and boolean
field equal; peak values within 1e-6 relative for the CFAR detect and
within 1e-4 of the largest peak for the detect from IQ (FFT roundoff and
float32 vs float64 window sums differ between the two packages).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels.pallas_zc import zc_cfar_detect_pallas  # noqa: E402
from ofdm_sync_tpu.ops.metrics import zc_normalized_correlation_per_branch  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_pss_symbol  # noqa: E402
from ofdm_sync_tpu.parallel import shard as jshard  # noqa: E402
from ofdm_sync_tpu.params import SYS_30M72, SystemParams  # noqa: E402
from ofdm_sync_tpu_torch.parallel import distributed  # noqa: E402
from ofdm_sync_tpu_torch.testing import TABLE_FIELDS, assert_tables_equal  # noqa: E402
from test_torch_sc import no_jax_cache_writes  # noqa: E402,F401
from torch_shard_ranks import zc_cfar_rank  # noqa: E402

MESHES = [(1, 4), (2, 2)]
BATCH = 2
CFAR_L, CFAR_W = 8192, 256
CFAR_KW = dict(corr_window=CFAR_W, threshold_value=int(4.0 * (1 << 15) / CFAR_W),
               min_corr_mag=0.3, hysteresis=64, max_events=8)
#: a Zadoff-Chu template of odd root 7 longer than kernel E's MAX_TAPS
ZC_LONG = np.exp(-1j * np.pi * 7 * np.arange(2311) * np.arange(1, 2312) / 2311)
#: the detect-from-IQ cases: (template, W, L, JAX's mf modes)
ZC_CASES = [(np.asarray(build_pss_symbol(SystemParams(n_fft=256, num_active=144, cp_len=64))),
             256, 6144, ("xla", "mxu")),
            (np.asarray(build_pss_symbol(SYS_30M72)), 1024, 16384, ("xla",)),
            (ZC_LONG, 512, 12288, ("xla",))]
ZC_KW = dict(min_corr_mag=0.1, hysteresis=64, max_events=8)
CFAR_RTOL, ZC_RTOL = 1e-6, 1e-4


def _magnitudes(rng):
    """tests/test_sharded_detect.py:221-226, rounded to multiples of 2^-10."""
    x = 0.05 * np.abs(rng.standard_normal((BATCH, CFAR_L)))
    for b in range(BATCH):
        for pos in (CFAR_L // 4 - 1 + b, CFAR_L // 2 + 100, 3 * CFAR_L // 4):
            x[b, pos - 2: pos + 3] = [0.5, 2.0, 5.0, 2.0, 0.5]
    return (np.round(x * 1024) / 1024).astype(np.float32)


def _iq(rng, ref, L):
    """tests/test_sharded_detect.py:282-290: the template in both branches
    (the second at 0.8) near the first (1, 4) seam, 0.01 complex noise;
    (complex (batch, 2, L), channel-leading float32 (4, batch, L))."""
    R = ref.shape[-1]
    rx = np.zeros((BATCH, 2, L), complex)
    for b in range(BATCH):
        pos = L // 4 - R // 2 + 128 * b
        rx[b, :, pos: pos + R] = np.stack([ref, 0.8 * ref])
    rx += 0.01 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    rx = rx.astype(np.complex64)
    x = np.stack([rx.real, rx.imag], axis=2).reshape(BATCH, 4, L).transpose(1, 0, 2)
    return rx, np.ascontiguousarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    mag = _magnitudes(rng)
    stim, port_cases = [], []
    for ref, W, L, _ in ZC_CASES:
        rx, x = _iq(rng, ref, L)
        stim.append(rx)
        port_cases.append((x, ref, dict(ZC_KW, corr_window=W)))
    ranks = distributed.run_ranks(zc_cfar_rank, 4, (mag, CFAR_KW, port_cases), timeout_s=600)
    return mag, stim, ranks


def _fields(table) -> dict:
    return {f: np.asarray(getattr(table, f)) for f in TABLE_FIELDS}


def _rows(arrays, d, nd):
    bb = BATCH // nd
    return SimpleNamespace(**{f: a[d * bb: (d + 1) * bb] for f, a in arrays.items()})


def _jmesh():
    return jshard.make_stream_mesh(n_data=2, n_seq=4)


def test_ranks_import_no_jax(runs):
    for out in runs[2]:
        assert out["modules"] == []


def test_sharded_zc_cfar_matches_jax(runs):
    mag, _, ranks = runs
    ref_s = _fields(jshard.sharded_zc_cfar_detect(jnp.asarray(mag), _jmesh(), **CFAR_KW))
    ref_u = _fields(zc_cfar_detect_pallas(jnp.asarray(mag), **CFAR_KW, block=1024,
                                          interpret=True))
    assert (ref_u["count"] >= 3).all()
    assert_tables_equal(SimpleNamespace(**ref_u), SimpleNamespace(**ref_s), "JAX", CFAR_RTOL)
    for r, out in enumerate(ranks):
        for nd, ns in MESHES:
            d, got = out["cfar", nd, ns]
            for ref, name in ((ref_s, "JAX sharded"), (ref_u, "JAX unsharded")):
                assert_tables_equal(_rows(ref, d, nd), SimpleNamespace(**got),
                                    f"rank {r} mesh {(nd, ns)} vs {name}", CFAR_RTOL)


@pytest.mark.parametrize("case", range(len(ZC_CASES)), ids=["pss256", "pss2048", "zc2311"])
def test_sharded_zc_detect_matches_jax(runs, case):
    _, stim, ranks = runs
    ref, W, L, jax_modes = ZC_CASES[case]
    rx = stim[case]
    kw = dict(ZC_KW, corr_window=W)
    mags = np.stack([np.abs(np.asarray(zc_normalized_correlation_per_branch(
        jnp.asarray(rx[b]), ref)))[:L] for b in range(BATCH)]).astype(np.float32)
    refs = {"unsharded": _fields(zc_cfar_detect_pallas(jnp.asarray(mags), **kw, block=2048,
                                                       interpret=True))}
    assert (refs["unsharded"]["count"] >= 1).all()
    for mode in jax_modes:
        refs[f"sharded {mode}"] = _fields(jshard.sharded_zc_detect(
            jnp.asarray(rx), _jmesh(), reference=ref, mf_mode=mode, **kw))
    for name, want in refs.items():
        assert_tables_equal(SimpleNamespace(**refs["unsharded"]), SimpleNamespace(**want),
                            f"JAX {name}", ZC_RTOL)
    for r, out in enumerate(ranks):
        for nd, ns in MESHES:
            d, got = out["zc", nd, ns, case]
            for name, want in refs.items():
                assert_tables_equal(_rows(want, d, nd), SimpleNamespace(**got),
                                    f"rank {r} mesh {(nd, ns)} vs JAX {name}", ZC_RTOL)
