"""The port's spans (`utils.profiling.span`): free with no profiler, recorded
once per call and nested under the caller under torch.profiler, closed on
an exception, all under one prefix, and invisible to the benchmark's trace
reader, which knows nothing of them.

The CPU tests drive the four entry points the benchmark's cells call on CPU
tensors.  The tests marked `gpu` hold the card path: each kernel wrapper's
``.prep`` holds its ``.alloc`` and is followed by its ``.launch``, inside
which the kernel is launched, no span leaves a device-side echo (which the
benchmark's trace reader would count as device work), and the device
windows of `utils.profiling` count no echo where a torch leaves one.  This file imports no JAX, so on a card
it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu_torch.kernels import matched_filter as MF  # noqa: E402
from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F  # noqa: E402
from ofdm_sync_tpu_torch.kernels import streaming_chunked as ST  # noqa: E402
from ofdm_sync_tpu_torch.kernels import zc_fused as ZF  # noqa: E402
from ofdm_sync_tpu_torch.utils import profiling  # noqa: E402
from ofdm_sync_tpu_torch.utils.profiling import SPAN_PREFIX  # noqa: E402

PACKAGE = Path(profiling.__file__).resolve().parents[1]
Q = 64
MINN = dict(quarter_len=Q, smooth_shift=3, threshold_value=3276, threshold_frac_bits=15)
PARAMS = ST.MinnRTLStreamParams(**MINN, hysteresis=2)
ENTRY_SPANS = ("minn_rtl_fused_stream_step", "minn_rtl_detect_fused", "matched_filter_ols",
               "zc_iq_cfar_detect")


def _codes(shape, seed=0, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.round(64 * rng.standard_normal(shape)).astype(np.float32)).to(
        dtype).to(device)


def _taps(T=62):
    n = np.arange(T)
    ref = np.exp(-1j * np.pi * 25 * n * (n + 1) / 63)
    return np.stack([ref.real[::-1], -ref.imag[::-1]]).astype(np.float32), float(np.sqrt(T))


def drive_entry_points(device="cpu", L=4096, batch=2):
    """One call of each entry point the benchmark's cells drive."""
    x = _codes((4, batch, L), device=device)
    state = ST.minn_rtl_fused_stream_init(PARAMS, batch, device=device)
    ST.minn_rtl_fused_stream_step(state, x, params=PARAMS)
    F.minn_rtl_detect_fused(x, **MINN, hysteresis=2, max_events=8, tie="last",
                            emit_unclosed=False)
    taps, norm = _taps()
    mf = MF.matched_filter_ols(x, taps)
    ZF.zc_iq_cfar_detect(mf, x, ref_len=taps.shape[-1], ref_norm=norm, corr_window=256,
                         hysteresis=16)


def _profile(fn, cuda=False):
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("caller"):
            fn()
        if cuda:
            torch.cuda.synchronize()
    return prof


def _host_spans(prof):
    return [e for e in prof.events() if e.name.startswith(SPAN_PREFIX)
            and e.device_type == torch.autograd.DeviceType.CPU]


def test_span_is_free_without_a_profiler(monkeypatch):
    """With no profiler session, no annotation is ever built: both
    annotation classes raise if touched, and every entry point runs."""
    def boom(*a, **k):
        raise AssertionError("an annotation was built with the profiler off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom, raising=False)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span(SPAN_PREFIX + "x") is profiling.NO_SPAN
    drive_entry_points()


def test_entry_points_record_their_spans_once_under_the_caller():
    prof = _profile(lambda: (drive_entry_points(), drive_entry_points()))
    spans = _host_spans(prof)
    assert all(e.cpu_parent is not None for e in spans)
    top = [e.name for e in spans if e.cpu_parent.name == "caller"]
    assert sorted(top) == sorted(2 * [SPAN_PREFIX + n for n in ENTRY_SPANS])
    # on the CPU the stream step runs its plain composition, the detector
    detect = [e for e in spans if e.name == SPAN_PREFIX + "minn_rtl_detect_fused"]
    assert sorted(e.cpu_parent.name for e in detect) == 2 * ["caller"] + 2 * [
        SPAN_PREFIX + "minn_rtl_step"]
    # kernel wrappers nest in the entry points that call them
    step = [e for e in spans if e.name == SPAN_PREFIX + "minn_rtl_step"]
    assert len(step) == 2
    assert {e.cpu_parent.name for e in step} == {SPAN_PREFIX + "minn_rtl_fused_stream_step"}
    metric = [e for e in spans if e.name == SPAN_PREFIX + "zc_metric"]
    assert {e.cpu_parent.name for e in metric} == {SPAN_PREFIX + "zc_iq_cfar_detect"}
    # the CPU path runs the plain versions: no prep, alloc or launch
    assert not [e for e in spans if e.name.endswith((".prep", ".alloc", ".launch"))]


def test_a_wrapper_that_raises_leaves_no_span_open():
    x = _codes((4, 2, 1024))
    state = ST.minn_rtl_fused_stream_init(PARAMS, 2, device="cpu")

    def run():
        with pytest.raises(ValueError):
            F.minn_rtl_step(x, state.hist, state.carry, state.gate[:1], base_index=0, **MINN,
                            hysteresis=2, stream_len_global=1 << 20)
        with pytest.raises(ValueError):
            ZF.zc_iq_cfar_detect(x, x, ref_len=0, ref_norm=1.0)
        ST.minn_rtl_fused_stream_step(state, x, params=PARAMS)

    spans = sorted(_host_spans(_profile(run)), key=lambda e: e.time_range.start)
    assert [e.name for e in spans if e.cpu_parent.name == "caller"] == [
        SPAN_PREFIX + n for n in ("minn_rtl_step", "zc_iq_cfar_detect",
                                  "minn_rtl_fused_stream_step")]
    failed = [e for e in spans if e.name == SPAN_PREFIX + "zc_metric"]
    assert len(failed) == 1 and failed[0].cpu_parent.name == SPAN_PREFIX + "zc_iq_cfar_detect"
    assert all(e.time_range.end >= e.time_range.start for e in spans)


def _span_calls():
    """(module file, argument source, value) of every ``span(...)`` call in
    the package, the argument evaluated in its module's namespace."""
    out = []
    for path in sorted(PACKAGE.rglob("*.py")):
        if path.name == "profiling.py" and path.parent.name == "utils":
            continue  # the definition
        tree = ast.parse(path.read_text())
        calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and getattr(n.func, "id", getattr(n.func, "attr", None)) == "span"]
        if not calls:
            continue
        mod = importlib.import_module(
            ".".join(path.relative_to(PACKAGE.parent).with_suffix("").parts))
        for c in calls:
            src = ast.unparse(c.args[0])
            out.append((path.name, src, eval(src, vars(mod))))
    return out


class _HostEvent:
    """A host event as the benchmark's trace reader sees one."""

    def __init__(self, name):
        self._name = name

    def name(self):
        return self._name

    def device_type(self):
        return torch.autograd.DeviceType.CPU


def test_every_span_name_has_the_prefix():
    """Every span of the package has the prefix, and the benchmark's trace
    reader takes none of their host events for a harness span or a launch
    (it tells those apart by name)."""
    from benchmark import harness, trace

    calls = _span_calls()
    names = {v for _, _, v in calls}
    for where, src, value in calls:
        assert isinstance(value, str) and value.startswith(SPAN_PREFIX), (where, src)
    assert {SPAN_PREFIX + n for n in ENTRY_SPANS} <= names
    from ofdm_sync_tpu_torch.kernels.launches import KERNEL_WRAPPERS

    for fn in KERNEL_WRAPPERS:  # every kernel wrapper, each role
        assert set(profiling.wrapper_spans(fn.__name__)) <= names, fn.__name__
    for name in names:
        assert trace._kind(_HostEvent(name), set(harness.SPAN_NAMES)) is None, name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _kineto(prof):
    """(host spans [(t0, t1, name)], launches {correlation id: t0}, kernels
    [(name, correlation id)]) of a profile, as the benchmark's reader tells
    them apart: by device and name."""
    spans, launches, kernels = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name.startswith(SPAN_PREFIX):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
            elif name.startswith("cu"):
                launches[e.correlation_id()] = e.start_ns()
        elif not name.startswith(SPAN_PREFIX) and name != "caller":
            kernels.append((name, e.correlation_id(), e.linked_correlation_id()))
    return spans, launches, kernels


def _inside(t, spans, name):
    return any(s0 <= t <= s1 for s0, s1, n in spans if n == name)


@pytest.mark.gpu
def test_cuda_wrappers_prep_alloc_launch(cuda):
    """F's, A's, B's, D's and E's wrappers record ``.prep`` holding
    ``.alloc``, then ``.launch``; every kernel's launch lies inside its
    wrapper's ``.launch``."""
    drive_entry_points(cuda)  # builds and loads the kernels
    torch.cuda.synchronize()
    prof = _profile(lambda: drive_entry_points(cuda, L=16384, batch=4), cuda=True)
    spans, launches, kernels = _kineto(prof)
    wrappers = {"minn_rtl_step": "minn_rtl_step", "minn_rtl_metric": "minn_rtl_metric",
                "gate_events": "gate_events", "zc_metric": "zc_cfar", "matched_filter_ols":
                "mf_ols"}
    for w in wrappers:
        ws = profiling.wrapper_spans(w)
        preps = [s for s in spans if s[2] == ws.prep]
        allocs = [s for s in spans if s[2] == ws.alloc]
        runs = [s for s in spans if s[2] == ws.launch]
        assert preps and len(preps) == len(allocs) == len(runs), w
        for (p0, p1, _), (a0, a1, _), (l0, l1, _) in zip(sorted(preps), sorted(allocs),
                                                         sorted(runs)):
            assert p0 <= a0 <= a1 <= p1 <= l0 <= l1, w
            assert _inside(l0, spans, ws.call) and _inside(p0, spans, ws.call), w
    for w, kernel in wrappers.items():
        mine = [k for k in kernels if kernel in k[0]]
        assert mine, (w, kernel)
        for name, corr, linked in mine:  # the launch's id is one of the two
            assert any(launches.get(c) is not None and _inside(
                launches[c], spans, profiling.wrapper_spans(w).launch) for c in (corr, linked)), name


@pytest.mark.gpu
@pytest.mark.parametrize("fallback", [False, True])
def test_cuda_device_windows_count_no_span_echo(cuda, monkeypatch, fallback):
    """With spans present, `kernel_ms` of one F step counts only F's kernel
    and `device_window` sees one device event per launch; also where the
    spans are `torch.profiler.record_function`s (a torch without
    `_RecordFunctionFast`), whose ranges reappear as device events.  The
    spans as this torch records them leave no device event: the benchmark's
    trace reader, which counts every device event, reads the same with them."""
    if fallback:
        monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast", raising=False)
    x = _codes((4, 16, 16384), device=cuda, dtype=torch.int16)
    state = ST.minn_rtl_fused_stream_init(PARAMS, 16, device=cuda)

    def step():
        return ST.minn_rtl_fused_stream_step(state, x, params=PARAMS)

    step()
    torch.cuda.synchronize()
    # several steps: a session's tracer may miss the first device events
    prof = _profile(lambda: [step() for _ in range(20)], cuda=True)
    work = [e for e in profiling._device_events(prof.events()) if e.name != "caller"]
    assert work and all("minn_rtl_step" in e.name for e in work)
    f_ms = sum(e.time_range.elapsed_us() for e in work) / len(work) / 1e3
    assert profiling.kernel_ms(step, reps=20) == pytest.approx(f_ms, rel=0.5)
    win = profiling.device_window(step, 20, 1)
    # at most one device event a launch (an echo would add three a step; the
    # window's time-range filter may miss an event, PERF.md section 7)
    assert 0 < win["device_events"] <= 20
    if win["device_events"] == 20:
        assert set(win["by_kernel"]) == {work[0].name}
    echoes = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name.startswith(SPAN_PREFIX)]
    # the fallback is the trap the filter closes: its spans do appear on the device
    assert bool(echoes) == fallback
