"""The [A][A] detector's peak capture: P_re, P_im and M formed again at each
event's peak from int16 codes, in integers.

On the CPU: the plain capture (`kernels.streaming.aa_peak_capture_plain`)
against the composition it replaces on the card (`aa_metric_planar` ->
`aa_detect_step` -> `extract_gate_events_capture` / `_carried`), bit for
bit, empty slots included; the route's choice (`aa_fused.gate_input_route`);
the lean route's pieces composed on the CPU against `aa_detect_fused` and,
where JAX is installed, against `aa_detect_fused_pallas` in interpret mode.
On a card (`gpu`): `aa_detect_fused`'s lean route (kernel C on the gate
input alone, kernel B plain, the peak capture) against the plain
composition on the CPU and against the route it replaces (kernel C in
detect mode, kernel B with capture) on the same codes, tables, P and M
bit-equal.  This file imports JAX only inside the test that compares with
it, so on a card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_aa_peak_capture.py
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
from ofdm_sync_tpu_torch.kernels.streaming import (  # noqa: E402
    aa_detect_step,
    aa_metric_planar,
    aa_peak_capture_plain,
)
from ofdm_sync_tpu_torch.ops.detect import extract_gate_events_carried  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402
from ofdm_sync_tpu_torch.utils.profiling import SPAN_PREFIX  # noqa: E402

THR = 0.15


def _codes(branches, batch, n, L, events, seed, amp=900.0, noise=64.0):
    """Channel-leading (2*branches, batch, n) int16 codes: noise, and at
    each (stream, position) an [A][A] preamble (two equal halves of L
    random codes a plane), cut where it leaves [0, n); clipped to int16."""
    rng = np.random.default_rng(seed)
    x = np.round(noise * rng.standard_normal((2 * branches, batch, n)))
    for b, pos in events:
        half = np.round(amp * rng.standard_normal((2 * branches, L)))
        pre = np.concatenate([half, half], axis=1)
        lo, hi = max(pos, 0), min(pos + 2 * L, n)
        x[:, b, lo:hi] += pre[:, lo - pos: hi - pos]
    return torch.from_numpy(np.clip(x, -32768, 32767).astype(np.int16))


def _scene(L, branches, seed, **kw):
    """Four streams: 0, a preamble cut by the stream's start (its peak's
    lagged window reaches before sample 0); 1, one that ends 3 samples before the
    stream (a gate still open at the end); 2, six preambles, more gates
    than 4 slots; 3, silence (no gate: every slot empty).  At short lags
    the noise opens gates of its own too."""
    n = 22 * L + 100
    events = [(0, -L // 2), (1, n - 2 * L - 3)] + [(2, 200 + 3 * L * k) for k in range(6)]
    x = _codes(branches, 4, n, L, events, seed, **kw)
    # stream 0: negated copies after the cut preamble turn P's sign, so |P|
    # dips right after the preamble's end (3L/2 - 1), where the lagged half
    # starts L/2 before sample 0: a peak there
    a, w = 3 * L // 2, L // 4
    x[:, 0, a: a + w] = -x[:, 0, a - L: a - L + w].clamp_min(-32767)
    x[:, 3] = 0
    return x


def _composed(x, L, base, gate, ginit=None):
    """The route the capture replaces, in plain PyTorch (on x's device):
    (table, captured, gate_out)."""
    st = aa_metric_planar(F._planar_view(x), L, base_index=base)
    track, M, above = aa_detect_step(st.P_re, st.P_im, st.R, L, THR, base)
    return extract_gate_events_carried(above, track, (st.P_re, st.P_im, M), base_index=base,
                                       gate_init=ginit, **gate)


def _gate(L, tie, emit):
    return dict(hysteresis=max(L // 4, 4), max_events=4, tie=tie, emit_unclosed=emit)


@pytest.mark.parametrize("base", [0, 4099])
@pytest.mark.parametrize("branches", [1, 2])
@pytest.mark.parametrize("L", [16, 64, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_capture_equals_the_composition(seed, L, branches, base):
    tie, emit = ("first", True) if seed == 0 else ("last", False)
    x = _scene(L, branches, seed)
    table, cap, _ = _composed(x, L, base, _gate(L, tie, emit))
    got = aa_peak_capture_plain(F._planar_view(x), table.peak_idx, L, base_index=base)
    assert got.dtype == torch.float32 and got.shape == cap.shape == (4, 3, 4)
    assert torch.equal(got, cap)
    # the scene holds what it is meant to
    n = x.shape[-1]
    peaks = table.peak_idx.to(torch.int64) - base
    early = (peaks[0] < 2 * L - 1) & table.valid[0]
    assert bool(early.any()) and bool((cap[0, 2] >= THR)[early].all())
    assert bool(table.overflow[2]) and int(table.count[3]) == 0 and not bool(cap[3].any())
    assert int(peaks[1].max()) < n
    if emit and not bool(table.overflow[1]):  # short lags: noise gates may fill the slots
        last = int(table.count[1]) - 1
        assert bool(table.valid[1, last]) and not bool(table.closed[1, last])


def test_plain_capture_reads_zero_outside_the_call():
    L, x = 16, _codes(2, 2, 400, 16, [(0, 100)], seed=3)
    st = aa_metric_planar(F._planar_view(x), L, base_index=1000)
    pidx = torch.tensor([[999, 1000, 1000 + 399, 1400], [2**31 - 1, -1, 1131, 0]],
                        dtype=torch.int32)
    got = aa_peak_capture_plain(F._planar_view(x), pidx, L, base_index=1000)
    assert not bool(got[0, :, 0].any()) and not bool(got[0, :, 3].any())
    assert not bool(got[1, :, :2].any()) and not bool(got[1, :, 3].any())
    for b, k, n in ((0, 1, 0), (0, 2, 399), (1, 2, 131)):
        assert torch.equal(got[b, :2, k], torch.stack([st.P_re[b, n], st.P_im[b, n]]))
        assert torch.equal(got[b, 2, k], st.M[b, n])


def test_plain_capture_takes_only_codes():
    x = _codes(1, 1, 64, 8, [], seed=0)
    with pytest.raises(TypeError):
        aa_peak_capture_plain(F._planar_view(x).float(), torch.zeros((1, 2), dtype=torch.int32),
                              8)


def test_gate_input_route():
    x = _codes(2, 2, 64, 8, [], seed=0)
    hist = torch.zeros((4, 2, 16))
    assert AA.gate_input_route(x, None, 512)
    assert not AA.gate_input_route(x.float(), None, 512)
    assert not AA.gate_input_route(x, hist, 512)
    assert AA.gate_input_route(x, None, 2**19) and not AA.gate_input_route(x, None, 2**19 + 1)
    assert AA.gate_input_route(_codes(4, 1, 64, 8, [], seed=0), None, 2**18)


@pytest.mark.parametrize("base", [0, 700])
def test_lean_pieces_on_cpu_equal_detect(base):
    """The lean route's three pieces composed on the CPU (the plain versions
    of C's gate-input mode, B and the capture) give `aa_detect_fused`'s
    table, P and M, with a gate carried in and out."""
    L = 64
    x = _scene(L, 2, seed=2)
    ginit = torch.tensor([[base - 3, 1], [-1, 0], [-1, 0], [base - 1, 1]], dtype=torch.int32)
    gate = dict(hysteresis=16, max_events=4, tie="first", emit_unclosed=True, base_index=base,
                emit_state=True)
    t, P, M, g = AA.aa_detect_fused(x, half_len=L, shard_init=(None, ginit), **gate)
    o = AA._aa_metric(x, half_len=L, threshold=THR, base_index=base, hist_init=None,
                      gate_input=True)
    assert o.P_re is None and o.P_im is None and o.M is None and o.R is None
    table, gate_out = F.gate_events(o.above, o.track, gate_init=ginit, **gate)
    cap = AA.aa_peak_capture(x, table.peak_idx, half_len=L, base_index=base)
    assert_tables_equal(t, table, "lean pieces")
    assert torch.equal(P, cap[:, :2]) and torch.equal(M, cap[:, 2])
    assert torch.equal(g, gate_out)


@pytest.mark.parametrize("L", [64, 128])
def test_lean_pieces_match_pallas(L):
    """The lean route's pieces on the CPU (the plain versions of C's
    gate-input mode, B and the capture) against JAX's
    `aa_detect_fused_pallas` in interpret mode on the same int16 codes
    (given as float32, which it reads): equal tables, P and M within
    tests/test_torch_aa_fused.py's tolerances (JAX sums the windows in
    float32)."""
    jnp = pytest.importorskip("jax.numpy")
    pallas_aa = pytest.importorskip("ofdm_sync_tpu.kernels.pallas_aa")
    x = _scene(L, 2, seed=8)
    gate = dict(hysteresis=L // 4, max_events=4, tie="first", emit_unclosed=True)
    o = AA._aa_metric(x, half_len=L, threshold=THR, base_index=0, hist_init=None,
                      gate_input=True)
    table = F.gate_events(o.above, o.track, **gate)
    cap = AA.aa_peak_capture(x, table.peak_idx, half_len=L)
    jt, jP, jM = pallas_aa.aa_detect_fused_pallas(
        jnp.asarray(x.numpy().astype(np.float32)), half_len=L, block=1024,
        channel_leading=True, threshold=THR, **gate)
    assert_tables_equal(jt, table, "lean pieces vs aa_detect_fused_pallas", peak_rtol=2e-4)
    np.testing.assert_allclose(cap[:, :2].numpy(), np.asarray(jP), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(cap[:, 2].numpy(), np.asarray(jM), rtol=2e-4, atol=1e-5)
    assert int(table.count.sum()) > 0


def test_capture_wrapper_checks_and_cpu_counts_nothing():
    x = _codes(2, 2, 256, 16, [(0, 40)], seed=4)
    pidx = torch.tensor([[71, 0], [300, 5]], dtype=torch.int32)
    reset_launch_counts()
    got = AA.aa_peak_capture(x, pidx, half_len=16)
    assert torch.equal(got, aa_peak_capture_plain(F._planar_view(x), pidx, 16))
    assert not any(launch_counts().values()) and mode_launch_counts() == {}
    with pytest.raises(TypeError):
        AA.aa_peak_capture(x.float(), pidx, half_len=16)
    with pytest.raises(ValueError):
        AA.aa_peak_capture(x, pidx[:1], half_len=16)
    with pytest.raises(ValueError):
        AA.aa_peak_capture(x, pidx, half_len=2**20)


def test_capture_span_under_the_profiler():
    x = _codes(1, 1, 128, 8, [], seed=0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        AA.aa_peak_capture(x, torch.zeros((1, 3), dtype=torch.int32), half_len=8)
    names = [e.name for e in prof.events() if e.name.startswith(SPAN_PREFIX)]
    assert names == [SPAN_PREFIX + "aa_peak_capture"]


# ---------------------------------------------------------------------------
# on the card: the lean route against the route it replaces
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _current_route(x, L, *, base=0, ginit=None, emit_state=False, **gate):
    """The route before the peak capture: kernel C in detect mode (P_re,
    P_im, M written) on its float path (the codes as float32) and kernel B
    capturing them at the peaks."""
    o = AA.aa_metric(x.float(), half_len=L, threshold=THR, base_index=base)
    return F.gate_events_capture(o.above, o.track, (o.P_re, o.P_im, o.M), valid_from=0,
                                 base_index=base, gate_init=ginit, emit_state=emit_state,
                                 **gate)


def _check_routes(x, L, what, *, base=0, plain_on_card=False, **gate):
    """The lean route against the plain composition (on the CPU, or with
    ``plain_on_card`` in plain PyTorch on the card) and against the route
    it replaces: tables, P and M bit-equal."""
    reset_launch_counts()
    t, P, M = AA.aa_detect_fused(x, half_len=L, base_index=base, **gate)
    counts, modes = launch_counts(), mode_launch_counts()
    ref, cap = _current_route(x, L, base=base, **gate)
    plain, pcap, _ = _composed(x if plain_on_card else x.cpu(), L, base, gate)
    torch.cuda.synchronize()
    assert modes.get("aa_metric/gate_input") == 1 and counts["aa_peak_capture"] == 1
    assert "gate_events/capture" not in modes, modes
    for want, wcap, side in ((plain, pcap, "plain"), (ref, cap, "current route")):
        assert_tables_equal(want, t, f"{what} vs {side}")
        assert torch.equal(P, wcap[:, :2].to(P.device)), (what, side)
        assert torch.equal(M, wcap[:, 2].to(M.device)), (what, side)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("base", [0, 4099])
@pytest.mark.parametrize("branches", [1, 2, 4])
@pytest.mark.parametrize("L", [16, 64, 512])
def test_cuda_lean_route_matches_current_route(cuda, L, branches, base):
    for seed, (tie, emit) in enumerate((("first", True), ("last", False))):
        x = _scene(L, branches, seed).to(cuda)
        t = _check_routes(x, L, f"L={L} br={branches} base={base} seed={seed}", base=base,
                          **_gate(L, tie, emit))
        assert bool(t.overflow[2]) and int(t.count[3]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("L", [64, 512])
def test_cuda_lean_route_full_scale_codes(cuda, L):
    """Codes at the ends of int16 (+-32767 and -32768) in every plane."""
    x = _scene(L, 2, seed=5, amp=60000.0).to(cuda)
    assert int(x.max()) == 32767 and int(x.min()) == -32768
    _check_routes(x, L, f"full scale L={L}", **_gate(L, "first", True))


@pytest.mark.gpu
def test_cuda_lean_route_carries_the_gate(cuda):
    """A gate carried in (no history) and out: gate_out equal too."""
    L, base = 64, 9000
    x = _scene(L, 2, seed=6).to(cuda)
    ginit = torch.tensor([[base - 3, 1], [-1, 0], [-1, 0], [base - 1, 1]], dtype=torch.int32,
                         device=cuda)
    gate = _gate(L, "first", True)
    t, P, M, g = AA.aa_detect_fused(x, half_len=L, base_index=base, shard_init=(None, ginit),
                                    emit_state=True, **gate)
    ref, cap, rg = _current_route(x, L, base=base, ginit=ginit, emit_state=True, **gate)
    plain, pcap, pg = _composed(x.cpu(), L, base, gate, ginit=ginit.cpu())
    torch.cuda.synchronize()
    for want, wcap, wg, side in ((plain, pcap, pg, "plain"), (ref, cap, rg, "current route")):
        assert_tables_equal(want, t, f"carried gate vs {side}")
        assert torch.equal(P, wcap[:, :2].to(cuda)) and torch.equal(M, wcap[:, 2].to(cuda))
        assert torch.equal(g, wg.to(cuda)), side


@pytest.mark.gpu
def test_cuda_lean_route_at_the_sweep_shape(cuda):
    """512 x 262,144 x 2 branches, L = 512, as the benchmark's [A][A] cell:
    four preambles a stream, and a few streams of noise alone."""
    batch, n, L = 512, 262_144, 512
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((4, batch, n), generator=g, device=cuda).mul_(32.0).round_()
    pre = torch.randn((4, 1, L), generator=g, device=cuda).mul_(600.0).round_()
    pre = torch.cat([pre, pre], dim=-1)
    for k in range(4):
        pos = 1000 + k * 65_000
        x[:, 8:, pos: pos + 2 * L] += pre
    x = x.clamp_(-2047, 2047).to(torch.int16)
    # the plain composition runs on the card here: on the CPU it would take
    # minutes at this shape
    t = _check_routes(x, L, "sweep shape", plain_on_card=True, hysteresis=128, max_events=8,
                      tie="first", emit_unclosed=True)
    assert int(t.count[8:].min()) == 4 and int(t.count[:8].max()) == 0
