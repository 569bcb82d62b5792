"""Kernel C's exact int16 path: int32 factored increments, int64 window sums.

On the CPU: an integer model of the path (`_exact_model`: the tile's range
rule, int32 increments summed along a thread's 8 samples, int64 window sums
scanned over the tile, one int64 -> float32 conversion each, then track, M
and above as `aa_detect_step` forms them) against the plain version
(`aa_metric_planar` -> `aa_detect_step`), bit for bit, with codes inside the
12-bit range, on its edge and beyond it; and the helper that picks the path
(`aa_fused.exact_route`).  On a card (`gpu`): the exact path against the
float path on the same codes (as float32, and as int16 with a zero history),
every output `torch.equal`, tiles out of range counted in ``failed_tiles``;
at the benchmark's sweep shape; on rows that cannot be copied 16 bytes at a
time.  No JAX here, so on a card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_aa_exact.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu_torch.kernels import aa_fused as AA  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import (  # noqa: E402
    launch_counts,
    mode_launch_counts,
    reset_launch_counts,
)
from ofdm_sync_tpu_torch.kernels.streaming import aa_detect_step, aa_metric_planar  # noqa: E402

THR = 0.15
TILE, ITEMS = 1024, 8
#: the exact path's range: codes in [-2^11, 2^11)
LO, HI = -2048, 2048


def _codes(branches, batch, n, L, seed, *, clip=2047, planted=()):
    """(2*branches, batch, n) int16 codes: noise and [A][A] preambles (two
    equal halves of L codes) every ~5L samples, loud enough to reach the
    clip; ``planted``: (stream, sample, code) set in every plane."""
    rng = np.random.default_rng(seed)
    x = np.round(40.0 * rng.standard_normal((2 * branches, batch, n)))
    for b in range(batch):
        for p in range(300 + 97 * b, n - 2 * L, 5 * L + 11):
            half = np.round(1500.0 * rng.standard_normal((2 * branches, L)))
            x[:, b, p: p + 2 * L] += np.concatenate([half, half], axis=1)
    x = np.clip(x, -clip - (clip == 2047), clip)  # 2047: the range [-2048, 2047]
    for b, k, v in planted:
        x[:, b, k] = v
    return torch.from_numpy(x.astype(np.int16))


def _delay(v, k):
    return torch.nn.functional.pad(v, (k, 0))[..., : v.shape[-1]]


def _exact_model(x16, L, base):
    """What the exact path computes, in integers: (P_re, P_im, R, track,
    above, wide tiles).  A tile whose increments read a code outside
    [-2048, 2048) (x[t0 - 2L, t0 + 1024)) takes the wide route (int64);
    every other tile forms the increments in int32, sums them along a
    thread's 8 samples in int32 (checked here to equal the int64 sums: no
    int32 overflow), and the window sums run in int64."""
    x = x16.to(torch.int64)
    n = x.shape[-1]
    i, q = x[0::2], x[1::2]  # (branches, batch, n)
    id_, qd, ie, qe = _delay(i, L), _delay(q, L), _delay(i, 2 * L), _delay(q, 2 * L)
    wide = torch.stack([(id_ * (i - ie) + qd * (q - qe)).sum(0),
                        (id_ * (q + qe) - qd * (i + ie)).sum(0),
                        ((i - id_) * (i + id_) + (q - qd) * (q + qd)).sum(0)])  # (3, batch, n)
    i32 = [t.to(torch.int32) for t in (i, q, id_, qd, ie, qe)]
    i, q, id_, qd, ie, qe = i32
    narrow = torch.stack([(id_ * (i - ie) + qd * (q - qe)).sum(0, dtype=torch.int32),
                          (id_ * (q + qe) - qd * (i + ie)).sum(0, dtype=torch.int32),
                          ((i - id_) * (i + id_) + (q - qd) * (q + qd)).sum(0, dtype=torch.int32)])
    tiles = -(-n // TILE)
    bad = ((x16 < LO) | (x16 >= HI)).any(0)  # (batch, n): a code out of range
    pad = tiles * TILE - n
    bad_tile = torch.nn.functional.pad(bad, (0, pad)).view(-1, tiles, TILE).any(-1)
    last_bad = torch.full((bad.shape[0],), -(2**40), dtype=torch.int64)
    route = torch.zeros((bad.shape[0], tiles), dtype=torch.bool)  # True: wide
    for t in range(tiles):
        last_bad = torch.where(bad_tile[:, t], torch.tensor((t + 1) * TILE - 1), last_bad)
        route[:, t] = last_bad >= t * TILE - 2 * L
    per_sample = route.repeat_interleave(TILE, dim=1)[:, :n]
    exact = ~per_sample
    # int32 sums along each thread's 8 samples agree with int64 ones where exact
    grp = lambda v: torch.nn.functional.pad(v, (0, (-n) % ITEMS)).view(*v.shape[:-1], -1, ITEMS)
    s32 = grp(narrow).cumsum(-1, dtype=torch.int32).flatten(-2)[..., :n]
    s64 = grp(wide).cumsum(-1).flatten(-2)[..., :n]
    assert torch.equal(s32.to(torch.int64)[:, exact], s64[:, exact])
    incr = torch.where(exact, narrow.to(torch.int64), wide)
    sums = incr.cumsum(-1)  # the int64 window sums, exact
    P_re, P_im, R = (s.to(torch.float32) for s in sums)
    track, _, above = aa_detect_step(P_re, P_im, R, L, THR, base)
    return P_re, P_im, R, track, above, int(route.sum())


@pytest.mark.parametrize("codes", ["in_range", "edge", "full_scale"])
@pytest.mark.parametrize("base", [0, 5003])
@pytest.mark.parametrize("branches", [1, 2])
@pytest.mark.parametrize("L", [16, 37, 512])
def test_exact_model_equals_plain(L, branches, base, codes):
    """The integer model against `aa_metric_planar` -> `aa_detect_step`:
    P_re, P_im, R, track and above bit-equal.  In range (codes clipped to
    [-2048, 2047]) no tile takes the wide route; on the edge (+-2048 planted:
    -2048 in range, +2048 not) and at full scale (+-32767, -32768) some do."""
    n = 6 * TILE + 300
    planted = {"in_range": [(0, 777, -2048), (1, 4000, 2047)],
               "edge": [(0, 777, -2048), (1, 2 * TILE + 5, 2048)],
               "full_scale": [(0, 3 * TILE + 1, 32767), (1, 100, -32768), (1, 5000, -32767)]}
    x = _codes(branches, 2, n, L, seed=L + branches, planted=planted[codes],
               clip=32767 if codes == "full_scale" else 2047)
    st = aa_metric_planar(F._planar_view(x), L, base_index=base)
    track, _, above = aa_detect_step(st.P_re, st.P_im, st.R, L, THR, base)
    P_re, P_im, R, m_track, m_above, wide = _exact_model(x, L, base)
    for got, want in ((P_re, st.P_re), (P_im, st.P_im), (R, st.R), (m_track, track),
                      (m_above, above)):
        assert torch.equal(got, want)
    assert (wide == 0) == (codes == "in_range")
    assert int(above.sum()) > 0


def test_exact_model_sums_need_int64():
    """At the cell's lag the window sums of 12-bit codes pass 2^31 (so the
    model and the kernel carry them in int64), while a thread's 8
    increments stay below 2^28."""
    L = 512
    x = torch.full((4, 1, 3 * L), -2048, dtype=torch.int16)
    P_re, _, R, _, _, wide = _exact_model(x, L, 0)
    assert wide == 0 and float(P_re[0, -1]) == float(R[0, -1]) == 4 * L * 2048.0**2
    assert float(R[0, -1]) > 2**31


def test_exact_route():
    x = _codes(2, 2, 64, 8, seed=0)
    assert AA.exact_route(x, None, 512)
    assert not AA.exact_route(x.float(), None, 512)
    assert not AA.exact_route(x, torch.zeros((4, 2, 16)), 512)
    assert AA.exact_route(_codes(1, 2, 64, 8, seed=0), None, 512)
    assert not AA.exact_route(_codes(3, 2, 64, 8, seed=0), None, 512)  # more than two branches
    # the ring of codes fits a CTA up to lag 12,672 at two branches
    assert AA.exact_route(x, None, 12_672) and not AA.exact_route(x, None, 12_673)
    # the lean route takes three branches too, with C on its float path
    assert AA.gate_input_route(_codes(3, 2, 64, 8, seed=0), None, 512)


def test_cpu_runs_the_plain_version_and_leaves_failed_tiles():
    x = _codes(2, 2, 3000, 64, seed=1, clip=32767)
    fails = torch.zeros(1, dtype=torch.int32)
    reset_launch_counts()
    o = AA.aa_metric(x, half_len=64, threshold=THR, failed_tiles=fails)
    st = aa_metric_planar(F._planar_view(x), 64)
    assert torch.equal(o.P_re, st.P_re) and int(fails) == 0
    assert not any(launch_counts().values()) and mode_launch_counts() == {}


# ---------------------------------------------------------------------------
# on the card: the exact path against the float path on the same codes
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _all_modes(x, L, base, fails=None, hist=None):
    """Kernel C on x in metric mode, full detect mode and on the gate input
    alone: a dict of every output."""
    kw = dict(half_len=L, base_index=base, hist_init=hist)
    m = AA.aa_metric(x, **kw, failed_tiles=fails)
    d = AA.aa_metric(x, threshold=THR, **kw, failed_tiles=fails)
    g = AA._aa_metric(x, threshold=THR, gate_input=True, failed_tiles=fails, **kw)
    return {"P_re": m.P_re, "P_im": m.P_im, "R": m.R, "d.P_re": d.P_re, "d.P_im": d.P_im,
            "M": d.M, "track": d.track, "above": d.above, "g.track": g.track,
            "g.above": g.above}


def _check_exact(x, L, base, what, *, want_failed):
    """The exact path (three launches) against the float path on the same
    codes as float32 and as int16 with a zero history: every output equal;
    ``failed_tiles`` nonzero exactly where ``want_failed``."""
    fails = torch.zeros(1, dtype=torch.int32, device=x.device)
    reset_launch_counts()
    got = _all_modes(x, L, base, fails)
    modes = mode_launch_counts()
    assert modes.get("aa_metric/exact_i16") == launch_counts()["aa_metric"] == 3, (what, modes)
    zero_hist = torch.zeros((x.shape[0], x.shape[1], 1), device=x.device)
    for side, ref in (("float32", _all_modes(x.float(), L, base)),
                      ("int16, float path", _all_modes(x, L, base, hist=zero_hist))):
        for name, want in ref.items():
            assert torch.equal(got[name], want), (what, side, name)
    assert mode_launch_counts()["aa_metric/exact_i16"] == 3, what
    assert (int(fails) > 0) == want_failed, (what, int(fails))
    assert int(got["above"].sum()) > 0, what
    return int(fails)


@pytest.mark.gpu
@pytest.mark.parametrize("codes", ["in_range", "edge", "full_scale"])
@pytest.mark.parametrize("base", [0, 4099])
@pytest.mark.parametrize("branches", [1, 2])
@pytest.mark.parametrize("L", [16, 37, 512])
@pytest.mark.parametrize("n", [100_000, 100_003])
def test_cuda_exact_path_matches_float_path(cuda, n, L, branches, base, codes):
    """Several spans a stream (3 streams of n samples), codes in the 12-bit
    range, on its edge and at full scale; the plain version too.  Rows of
    100,000 codes start 16 bytes apart, so every span's tiles and its halo
    are staged with 16-byte copies; rows of 100,003 are loaded code by
    code."""
    planted = {"in_range": [(0, 777, -2048), (2, 60_000, 2047)],
               "edge": [(0, 777, -2048), (1, 30_005, 2048)],
               "full_scale": [(0, 40_001, 32767), (1, 100, -32768), (2, 99_000, -32767)]}
    x = _codes(branches, 3, n, L, seed=L + 10 * branches, planted=planted[codes],
               clip=32767 if codes == "full_scale" else 2047).to(cuda)
    staged = x.data_ptr() % 16 == 0 and (n * x.element_size()) % 16 == 0
    assert staged == (n == 100_000), (n, x.data_ptr() % 16)
    _check_exact(x, L, base, f"n={n} L={L} br={branches} base={base} {codes}",
                 want_failed=codes != "in_range")
    st = aa_metric_planar(F._planar_view(x.cpu()), L, base_index=base)
    track, _, above = aa_detect_step(st.P_re, st.P_im, st.R, L, THR, base)
    g = AA._aa_metric(x, half_len=L, threshold=THR, base_index=base, hist_init=None,
                      gate_input=True)
    assert torch.equal(g.track.cpu(), track) and torch.equal(g.above.cpu(), above)


@pytest.mark.gpu
def test_cuda_exact_path_unstaged_rows(cuda):
    """Rows that cannot be copied 16 bytes at a time: an odd length, and a
    base address 2 bytes past a 16-byte boundary."""
    L = 512
    x = _codes(2, 3, 40_001, L, seed=11).to(cuda)
    _check_exact(x, L, 0, "odd length", want_failed=False)
    y = _codes(2, 3, 40_000, L, seed=12)
    buf = torch.empty(y.numel() + 1, dtype=torch.int16, device=cuda)
    shifted = buf[1:].view(y.shape)
    shifted.copy_(y.to(cuda))
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    _check_exact(shifted, L, 0, "unaligned base", want_failed=False)


@pytest.mark.gpu
def test_cuda_exact_path_at_the_sweep_shape(cuda):
    """512 x 262,144 x 2 branches of 12-bit codes, L = 512, as the
    benchmark's [A][A] cell: the gate input of the exact path equal to the
    float path's, no tile off the exact route; then one code out of range."""
    batch, n, L = 512, 262_144, 512
    g = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn((4, batch, n), generator=g, device=cuda).mul_(32.0).round_()
    pre = torch.randn((4, 1, L), generator=g, device=cuda).mul_(600.0).round_()
    for k in range(4):
        pos = 1000 + k * 65_000
        x[:, 8:, pos: pos + 2 * L] += torch.cat([pre, pre], dim=-1)
    x = x.clamp_(-2048, 2047).to(torch.int16)
    fails = torch.zeros(1, dtype=torch.int32, device=cuda)
    kw = dict(half_len=L, threshold=THR, base_index=0, gate_input=True)
    reset_launch_counts()
    o = AA._aa_metric(x, hist_init=None, failed_tiles=fails, **kw)
    assert mode_launch_counts() == {"aa_metric/detect": 1, "aa_metric/gate_input": 1,
                                    "aa_metric/exact_i16": 1}
    f = AA._aa_metric(x.float(), hist_init=None, **kw)
    assert torch.equal(o.track, f.track) and torch.equal(o.above, f.above)
    assert int(fails) == 0 and int(o.above[8:].sum()) > 0
    x[3, 100, 131_000] = 4000
    o = AA._aa_metric(x, hist_init=None, failed_tiles=fails, **kw)
    f = AA._aa_metric(x.float(), hist_init=None, **kw)
    assert torch.equal(o.track, f.track) and torch.equal(o.above, f.above)
    assert 1 <= int(fails) <= 3  # the tile itself and those whose 2L look-back reaches it
