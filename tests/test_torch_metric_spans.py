"""A plain-torch model of the span walk of kernels C and D (`aa_metric.cu`,
`zc_cfar.cu`).

Each kernel cuts a stream into spans of 1024-sample tiles.  A span starts
its walk a halo before its first sample -- round4(2L) for C, round4(R - 1 +
W - 1) for D in IQ mode, round4(W - 1) in magnitude mode -- or, at the
stream's head, at the start of the history; the samples before the walk's
start read as zero (the kernels' zeroed rings).  Tile by tile it carries
the window sums as running float64 values: C adds the increments pre[n] -
pre[n-L] (and pim, pw) formed from x[n], x[n-L] and x[n-2L]; D adds the
energy increments p[n] - p[n-R] of each branch, forms the magnitude in
float32 op for op as the plain version (zero where the energy is still
partial), and adds the local-sum increments mag[n] - mag[n-W].

`aa_span_model` and `zc_span_model` below are that decomposition.  On
integer-valued stimulus made with NumPy from a seed, with short spans so
that windows cross many seams, lengths off the tile size and primed heads,
they must give the one-shot plain versions (`kernels.streaming`) bit for
bit: P_re, P_im, R of C; D's magnitude, and D's above where the magnitudes
are dyadic (magnitude mode).  In IQ mode an above bit may differ only on
the 1e-6 knife edge (the local sums of non-integer magnitudes are summed in
another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu_torch.kernels.streaming import (  # noqa: E402
    aa_metric_planar,
    zc_cfar_planar,
    zc_iq_planar,
    zc_iq_planar_primed,
)
from ofdm_sync_tpu_torch.ops.windows import running_sum_stream  # noqa: E402

TILE = 1024
CFAR = dict(threshold_frac_bits=15, min_corr_mag=0.25)


def r4(n: int) -> int:
    return -(-n // 4) * 4


def _padded(x, hist, pad_left, pad_right=TILE):
    """float64 (..., pad_left + L + pad_right): the stream at pad_left, the
    right-aligned history before it, zeros elsewhere."""
    xp = torch.zeros(x.shape[:-1] + (pad_left + x.shape[-1] + pad_right,), dtype=torch.float64)
    xp[..., pad_left: pad_left + x.shape[-1]] = x.double()
    if hist is not None and hist.shape[-1]:
        h = hist[..., -pad_left:].double()
        xp[..., pad_left - h.shape[-1]: pad_left] = h
    return xp


def aa_span_model(x, lag: int, span_tiles: int, hist=None):
    """Kernel C's walk: x (C, batch, L) -> (P_re, P_im, R) float32."""
    C, B, L = x.shape
    halo = r4(2 * lag)
    P = halo + 2 * lag + TILE
    xp = _padded(x, hist, P)
    out = torch.zeros((3, B, L), dtype=torch.float32)
    span = span_tiles * TILE
    for s0 in range(0, L, span):
        s1, w0 = min(s0 + span, L), s0 - halo
        xs = xp.clone()
        xs[..., : P + w0] = 0.0  # the zeroed ring before the walk's start
        i, q = xs[0::2], xs[1::2]
        S = torch.zeros((3, B), dtype=torch.float64)
        for t0 in range(w0, s1, TILE):
            n = torch.arange(t0, t0 + TILE) + P
            a, aq = i[..., n], q[..., n]
            d, dq = i[..., n - lag], q[..., n - lag]
            e, eq = i[..., n - 2 * lag], q[..., n - 2 * lag]
            inc = torch.stack([((a * d + aq * dq) - (d * e + dq * eq)).sum(0),
                               ((aq * d - a * dq) - (dq * e - d * eq)).sum(0),
                               ((a * a + aq * aq) - (d * d + dq * dq)).sum(0)])
            c = S[..., None] + torch.cumsum(inc, dim=-1)
            S = c[..., -1]
            lo, hi = max(t0, s0), min(t0 + TILE, s1)
            if lo < hi:
                out[..., lo:hi] = c[..., lo - t0: hi - t0].float()
    return out


def _gate_mags(mag, local, base_n, W, T):
    return ((base_n >= W)
            & (mag * torch.tensor(float(1 << CFAR["threshold_frac_bits"]))
               >= local.float() * torch.tensor(float(T)))
            & (mag >= torch.tensor(CFAR["min_corr_mag"], dtype=torch.float32)))


def zc_span_model(x, W: int, T: int, span_tiles: int, *, iq=None, R=0, ref_norm=1.0,
                  hist=None, iq_hist=None, base=0, gate_h=None):
    """Kernel D's walk.  Magnitude mode (iq None): x corr_mag (batch, L),
    hist (batch, Hh).  IQ mode: x mf (C, batch, L), iq (C, batch, L_iq),
    halos hist / iq_hist (C, batch, Hh).  Returns (mag, above) and, with
    gate_h, the gate carry [la, flag] from the halo's last gate_h samples."""
    L = x.shape[-1]
    Hh = 0 if hist is None else hist.shape[-1]
    hist_r = r4(Hh)
    halo = r4(R - 1 + W - 1) if iq is not None else r4(W - 1)
    P = max(halo, hist_r) + R + W + TILE
    xp = _padded(x, hist, P).float()
    ip = None if iq is None else _padded(iq, iq_hist, P, P + x.shape[-1] - iq.shape[-1] + TILE)
    B = x.shape[-2]
    mag_out = torch.zeros((B, L), dtype=torch.float32)
    above_out = torch.zeros((B, L), dtype=torch.bool)
    la = torch.full((B,), -1, dtype=torch.int64)
    span = span_tiles * TILE
    for s0 in range(0, max(L, 1), span):
        s1 = min(s0 + span, L)
        head = gate_h is not None and s0 == 0
        w0 = -hist_r if head else max(s0 - halo, -hist_r)
        e_from = -(1 << 40) if w0 <= -hist_r else w0 + R - 1
        mags = torch.zeros((B, P + L + TILE), dtype=torch.float32)  # mag' by P + n
        SE = torch.zeros((x.shape[0] // 2 if iq is not None else 1, B), dtype=torch.float64)
        SL = torch.zeros(B, dtype=torch.float64)
        if iq is not None:
            xs = ip.clone()
            xs[..., : P + w0] = 0.0
            pw = xs[0::2] ** 2 + xs[1::2] ** 2  # (BR, B, N), exact
        for t0 in range(w0, s1, TILE):
            n = torch.arange(t0, t0 + TILE)
            if iq is not None:
                c = SE[..., None] + torch.cumsum(pw[..., n + P] - pw[..., n + P - R], dim=-1)
                SE = c[..., -1]
                inv = torch.reciprocal(torch.tensor(ref_norm, dtype=torch.float32)
                                       * torch.sqrt(c.float().clamp_min(1e-12)))
                mfx = xp[..., n + P]
                re, im = mfx[0] * inv[0], mfx[1] * inv[0]
                for k in range(1, inv.shape[0]):
                    re = re + mfx[2 * k] * inv[k]
                    im = im + mfx[2 * k + 1] * inv[k]
                mag = torch.sqrt(re * re + im * im)
                mag = torch.where(n >= e_from, mag, torch.zeros_like(mag))
            else:
                mag = torch.where(n >= w0, xp[..., n + P], torch.zeros(()))
            mags[..., n + P] = mag
            lc = SL[..., None] + torch.cumsum(mag.double() - mags[..., n + P - W].double(), -1)
            SL = lc[..., -1]
            above = _gate_mags(mag, lc, base + n, W, T)
            if head:
                tail = (n < 0) & (n >= -gate_h) & (n >= -Hh)
                la = torch.maximum(la, torch.where(above & tail, base + n, -1).amax(-1))
            lo, hi = max(t0, s0), min(t0 + TILE, s1)
            if lo < hi:
                mag_out[..., lo:hi] = mag[..., lo - t0: hi - t0]
                above_out[..., lo:hi] = above[..., lo - t0: hi - t0]
    gate = torch.stack([la, (la >= 0).long()], -1).int() if gate_h is not None else None
    return mag_out, above_out, gate


def _ints(seed, shape, scale=8.0):
    return torch.from_numpy(np.round(scale * np.random.default_rng(seed).standard_normal(shape))
                            .astype(np.float32))


def _knife_only(above, ref_above, mag, W, T, base=0, hist=None):
    """Above bits that differ must lie where |mag * 2^frac - local * T| is
    within 1e-6 of local * T (the plain local sum)."""
    ext = mag if hist is None else torch.cat([hist, mag], -1)
    local = running_sum_stream(ext, W)[..., ext.shape[-1] - mag.shape[-1]:]
    e_s = local * float(T)
    margin = (mag * float(1 << CFAR["threshold_frac_bits"]) - e_s).abs()
    assert not ((above != ref_above) & (margin > 1e-6 * e_s.abs())).any()


@pytest.mark.parametrize("lag,L,span_tiles,primed", [
    (37, 3 * 4096 + 123, 4, False),
    (128, 2 * 4096 + 77, 2, True),
    (512, 5 * 2048 + 5, 2, False),
    (512, 4 * 4096 + 1, 4, True),
    (2048, 3 * 4096 + 999, 4, True),
])
def test_aa_span_walk_equals_one_shot(lag, L, span_tiles, primed):
    """Kernel C's walk == the one-shot plain metric, bit for bit."""
    B = 2
    x = _ints(lag + L, (4, B, L))
    hist = _ints(lag, (4, B, 2 * lag + 50)) if primed else None
    want = aa_metric_planar(x.permute(1, 0, 2).reshape(B, 2, 2, L), lag,
                            hist=None if hist is None else hist.permute(1, 0, 2)
                            .reshape(B, 2, 2, -1))
    got = aa_span_model(x, lag, span_tiles, hist=hist)
    for k, ref in enumerate((want.P_re, want.P_im, want.R)):
        assert torch.equal(got[k], ref), k


@pytest.mark.parametrize("R,W,L,span_tiles,branches", [
    (37, 128, 3 * 4096 + 123, 4, 1),
    (128, 37, 2 * 4096 + 7, 2, 2),
    (512, 2048, 4 * 4096 + 333, 4, 2),
    (2048, 512, 5 * 2048 + 1, 2, 3),
    (2048, 2048, 3 * 4096 + 17, 4, 2),
])
def test_zc_iq_span_walk_equals_one_shot(R, W, L, span_tiles, branches):
    """Kernel D's IQ walk: mag bit-equal, above off the knife edge equal."""
    B, T = 2, int(4.0 * (1 << 15) / W)
    iq = _ints(R + W, (2 * branches, B, L - R + 1))
    mf = _ints(R + W + 1, (2 * branches, B, L), scale=40.0 * np.sqrt(R))
    cfar = dict(corr_window=W, threshold_value=T, **CFAR)
    mag, above = zc_iq_planar(mf, iq, ref_len=R, ref_norm=3.0 * np.sqrt(R), **cfar)
    got_mag, got_above, _ = zc_span_model(mf, W, T, span_tiles, iq=iq, R=R,
                                          ref_norm=3.0 * np.sqrt(R))
    assert torch.equal(got_mag, mag)
    _knife_only(got_above, above, mag, W, T)
    assert int(above.sum()) > 0


@pytest.mark.parametrize("R,W,h", [(37, 128, 16), (512, 2048, 256), (2048, 512, 300)])
def test_zc_iq_primed_span_walk(R, W, h):
    """Kernel D's primed IQ walk (the halo through the datapath, the gate
    carry from its last h decisions) == the plain version over [halo;
    shard]."""
    B, T, base, L = 3, int(4.0 * (1 << 15) / W), 1_000_003, 3 * 4096 + 11
    Hh = R - 1 + W + h + 9
    mf, mf_h = _ints(R, (4, B, L), 40.0 * np.sqrt(R)), _ints(R + 1, (4, B, Hh), 40.0 * np.sqrt(R))
    iq, iq_h = _ints(W, (4, B, L)), _ints(W + 1, (4, B, Hh))
    mf_h[:, [0, 2], Hh - max(h // 2, 1)] *= 100.0  # a peak within h of the seam
    cfar = dict(corr_window=W, threshold_value=T, **CFAR)
    mag, above, gate = zc_iq_planar_primed(mf, iq, mf_h, iq_h, ref_len=R,
                                           ref_norm=3.0 * np.sqrt(R), base_index=base,
                                           hysteresis=h, **cfar)
    got_mag, got_above, got_gate = zc_span_model(mf, W, T, 4, iq=iq, R=R,
                                                 ref_norm=3.0 * np.sqrt(R), hist=mf_h,
                                                 iq_hist=iq_h, base=base, gate_h=h)
    assert torch.equal(got_mag, mag)
    _knife_only(got_above, above, mag, W, T)
    assert torch.equal(got_gate, gate)
    assert int(gate[:, 1].sum()) > 0


@pytest.mark.parametrize("W,L,span_tiles,primed", [
    (37, 3 * 4096 + 123, 4, False),
    (128, 2 * 4096 + 77, 2, True),
    (512, 5 * 2048 + 5, 2, True),
    (2048, 4 * 4096 + 1, 4, True),
])
def test_zc_magnitude_span_walk_equals_one_shot(W, L, span_tiles, primed):
    """Kernel D's magnitude walk on dyadic magnitudes: above bit-equal."""
    B, T, base = 2, int(4.0 * (1 << 15) / W), 77_777 if primed else 0
    g = torch.Generator().manual_seed(W + L)
    mag = (torch.rand((B, L), generator=g) * 51).round() / 1024
    mag[:, ::997] += 1.0
    hist = (torch.rand((B, W + 3), generator=g) * 51).round() / 1024 if primed else None
    want = zc_cfar_planar(mag, corr_window=W, threshold_value=T, **CFAR, base_index=base,
                          hist=hist)
    _, got, _ = zc_span_model(mag, W, T, span_tiles, hist=hist, base=base)
    assert torch.equal(got, want)
    assert int(want.sum()) > 0
