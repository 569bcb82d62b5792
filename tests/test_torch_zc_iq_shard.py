"""The from-IQ ZC detector's shard mode (#9's ``base_index`` /
``stream_len_global`` / ``shard_init``) against the JAX TPU kernel.

Each shard of a stream runs `zc_iq_cfar_detect` primed with the trailing
`zc_tm_halo_rows` samples of its left neighbour's mf and (zero-padded) IQ;
on the CPU the port runs its plain versions (kernel D over [halo; shard],
the gate carry from the halo's last h decisions, kernel B carried), the JAX
side `pallas_zc_tm.zc_iq_cfar_detect_tm` in Pallas interpret mode with the
same halos.  Stimulus follows tests/test_sharded_zc_tm.py (R = W = 128, h =
16, Lc = 4096 in 4 shards, integer IQ and an exact integer matched filter,
templates on the seams).  Tables equal field by field, ``peak_value``
within 1e-4 of the largest peak (JAX sums its windows in float32, the port
in float64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels.pallas_zc_tm import (  # noqa: E402
    to_time_tiled,
    zc_iq_cfar_detect_tm,
    zc_tm_halo_rows as jax_halo_rows,
)
from ofdm_sync_tpu_torch.kernels import zc_fused as Z  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import launch_counts, reset_launch_counts  # noqa: E402
from ofdm_sync_tpu_torch.kernels.streaming import zc_iq_planar  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402

RF = W = 128
H_YST = 16
ROWS = 512
N_SEQ = 4
LC = 8 * ROWS
L = LC - RF + 1
BLOCK = LC // N_SEQ
KW = dict(corr_window=W, threshold_value=int(3.0 * (1 << 15) / W), threshold_frac_bits=15,
          min_corr_mag=0.25, hysteresis=H_YST, max_events=8)
PEAK_RTOL = 1e-4

_n = np.arange(RF)
_T = np.exp(-1j * np.pi * 25 * _n * (_n + 1) / RF)
T_I = np.round(12.0 * _T.real).astype(np.float32)
T_Q = np.round(12.0 * _T.imag).astype(np.float32)
REF_NORM = float(np.sqrt(np.sum(T_I.astype(np.float64) ** 2 + T_Q.astype(np.float64) ** 2)))
SEAM_EVENTS = [(0, BLOCK - RF // 2), (1, 2 * BLOCK - RF), (2, 3 * BLOCK - 2 * RF), (3, BLOCK - 1)]


def _stimulus(seed, batch, events):
    """Integer IQ (4, batch, L) and its exact planar matched filter (4,
    batch, LC), as tests/test_sharded_zc_tm.py builds them."""
    rng = np.random.default_rng(seed)
    iq = np.round(4.0 * rng.standard_normal((4, batch, L))).astype(np.float32)
    for b, pos in events:
        pos = max(0, min(L - RF - 1, pos))
        for c, plane in ((0, T_I), (1, T_Q), (2, T_I), (3, T_Q)):
            iq[c, b, pos: pos + RF] += 2.0 * plane
    nfft = 1 << int(np.ceil(np.log2(LC)))
    x = (iq[0::2] + 1j * iq[1::2]).astype(np.complex128)
    K = np.fft.fft(np.conj((T_I + 1j * T_Q)[::-1]), nfft)
    conv = np.fft.ifft(np.fft.fft(x, nfft, axis=-1) * K, axis=-1)[..., :LC]
    mf = np.zeros((4, batch, LC), np.float32)
    mf[0::2] = np.round(conv.real)
    mf[1::2] = np.round(conv.imag)
    return mf, iq


def _shards(mf, iq):
    """Per shard: (base, mf slice, IQ slice zero-padded to LC, mf halo, IQ
    halo), the halos the left neighbour's last Wh samples (zeros for shard
    0)."""
    Wh = Z.zc_tm_halo_rows(RF, W, H_YST)
    iqp = np.zeros(mf.shape, np.float32)
    iqp[..., :L] = iq
    out = []
    for s in range(N_SEQ):
        lo = s * BLOCK
        halo = (lambda a: np.zeros(a.shape[:2] + (Wh,), a.dtype) if s == 0  # noqa: E731
                else a[..., lo - Wh: lo])
        out.append((lo, mf[..., lo: lo + BLOCK], iqp[..., lo: lo + BLOCK], halo(mf), halo(iqp)))
    return out


def _jax_shard(mf_s, iq_s, mf_h, iq_h, base, batch):
    mft, _, _ = to_time_tiled(jnp.asarray(mf_s), ROWS)
    iqt, _, _ = to_time_tiled(jnp.asarray(iq_s), ROWS)
    return zc_iq_cfar_detect_tm(mft, iqt, ref_len=RF, ref_norm=REF_NORM, stream_len=BLOCK,
                                batch=batch, rows=ROWS, interpret=True, emit_unclosed=True,
                                base_index=jnp.int32(base), stream_len_global=LC,
                                shard_init=(jnp.asarray(mf_h), jnp.asarray(iq_h)), **KW)


def _port_shard(mf_s, iq_s, mf_h, iq_h, base, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return Z.zc_iq_cfar_detect(t(mf_s), t(iq_s).to(dtype), ref_len=RF, ref_norm=REF_NORM,
                               emit_unclosed=True, base_index=base, stream_len_global=LC,
                               shard_init=(t(mf_h), t(iq_h).to(dtype)), **KW)


def test_halo_rows_match_jax():
    for R, Wc, h in ((128, 128, 16), (2048, 2048, 256), (37, 101, 0), (1, 1, 1), (513, 7, 300)):
        assert Z.zc_tm_halo_rows(R, Wc, h) == jax_halo_rows(R, Wc, h)


@pytest.mark.parametrize("seam", [True, False])
def test_shards_match_tm_kernel(seam):
    """Every shard's table equals the JAX kernel's shard-mode table."""
    batch = 4
    events = SEAM_EVENTS if seam else [(0, 400), (1, 900), (2, 1800), (3, 2600), (3, 3400)]
    mf, iq = _stimulus(7 if seam else 8, batch, events)
    reset_launch_counts()
    found = np.zeros(batch, int)
    for base, mf_s, iq_s, mf_h, iq_h in _shards(mf, iq):
        jt = _jax_shard(mf_s, iq_s, mf_h, iq_h, base, batch)
        tt = _port_shard(mf_s, iq_s, mf_h, iq_h, base)
        assert_tables_equal(jt, tt, f"shard at {base}", peak_rtol=PEAK_RTOL)
        found += tt.count.numpy()
    assert (found >= 1).all()
    assert set(launch_counts().values()) == {0}  # the CPU runs the plain versions


def test_int16_iq_equals_float32():
    """int16 IQ and halos (the ADC codes) give the float32 tables exactly."""
    batch = 3
    mf, iq = _stimulus(9, batch, [(0, BLOCK - RF // 2), (2, 2000)])
    for base, mf_s, iq_s, mf_h, iq_h in _shards(mf, iq):
        t32 = _port_shard(mf_s, iq_s, mf_h, iq_h, base)
        t16 = _port_shard(mf_s, iq_s, mf_h, iq_h, base, torch.int16)
        assert_tables_equal(t32, t16, f"int16 shard at {base}")


def test_primed_metric_equals_one_shot():
    """Kernel D's primed IQ mode over each shard: mag and above equal the
    one-shot plain run over the same global range, and gate_init holds the
    last above index within h of the seam."""
    batch = 4
    mf, iq = _stimulus(10, batch, SEAM_EVENTS)
    kw = {k: v for k, v in KW.items() if k not in ("hysteresis", "max_events")}
    mag1, above1 = zc_iq_planar(torch.from_numpy(mf), torch.from_numpy(iq), ref_len=RF,
                                ref_norm=REF_NORM, **kw)
    for base, mf_s, iq_s, mf_h, iq_h in _shards(mf, iq):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        o = Z.zc_metric(t(mf_s), t(iq_s), ref_len=RF, ref_norm=REF_NORM, **kw, base_index=base,
                        hist_init=(t(mf_h), t(iq_h)), hysteresis=H_YST)
        assert torch.equal(o.mag, mag1[:, base: base + BLOCK])
        assert torch.equal(o.above, above1[:, base: base + BLOCK])
        idx = torch.arange(max(base - H_YST, 0), base)
        la = torch.where(above1[:, max(base - H_YST, 0): base], idx, -1).amax(-1) if base else \
            torch.full((batch,), -1)
        assert torch.equal(o.gate_init, torch.stack([la, (la >= 0).long()], -1).int())
