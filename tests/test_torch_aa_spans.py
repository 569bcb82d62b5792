"""The [A][A] batch detector's span and launch counters, in the style of
`test_torch_spans.py`: ``ofdm_sync.aa_detect_fused`` is recorded once a
call under torch.profiler with kernel C's and kernel B's wrapper spans
nested in it; the CPU path counts no launch; on the card one call on int16
codes counts C's ``detect``, ``gate_input`` and ``exact_i16`` modes, B in
its plain mode and one launch of the peak capture, and one call on float32
counts C's ``detect`` mode and B's ``capture`` mode.  This file imports no
JAX, so on a card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_aa_spans.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu_torch.kernels import aa_fused as AA  # noqa: E402
from ofdm_sync_tpu_torch.kernels.launches import (  # noqa: E402
    launch_counts,
    mode_launch_counts,
    reset_launch_counts,
)
from ofdm_sync_tpu_torch.utils import profiling  # noqa: E402
from ofdm_sync_tpu_torch.utils.profiling import SPAN_PREFIX  # noqa: E402

L = 64
DETECT = SPAN_PREFIX + "aa_detect_fused"


def _codes(shape, seed=0, dtype=torch.int16, device="cpu"):
    rng = np.random.default_rng(seed)
    x = np.round(64 * rng.standard_normal(shape)).astype(np.float32)
    x[..., 1000: 1000 + 2 * L] += np.tile(np.round(400 * rng.standard_normal(L)), 2)
    return torch.from_numpy(x).to(dtype).to(device)


def _detect(device="cpu", batch=2, n=4096):
    return AA.aa_detect_fused(_codes((4, batch, n), device=device), half_len=L, hysteresis=16)


def _spans(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            fn()
    return [e for e in prof.events() if e.name.startswith(SPAN_PREFIX)
            and e.device_type == torch.autograd.DeviceType.CPU]


def test_detect_span_holds_the_wrapper_spans():
    spans = _spans(lambda: (_detect(), _detect()))
    top = [e for e in spans if e.name == DETECT]
    assert len(top) == 2 and {e.cpu_parent.name for e in top} == {"caller"}
    for wrapper in ("aa_metric", "gate_events"):
        inner = [e for e in spans if e.name == profiling.wrapper_spans(wrapper).call]
        assert len(inner) == 2 and {e.cpu_parent.name for e in inner} == {DETECT}, wrapper
    # the CPU path runs the plain versions: no prep, alloc or launch
    assert not [e for e in spans if e.name.endswith((".prep", ".alloc", ".launch"))]


def test_detect_span_is_free_without_a_profiler(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("an annotation was built with the profiler off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom, raising=False)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    table, P, M = _detect()
    assert bool(table.valid.any()) and P.shape == (2, 2, 8) and M.shape == (2, 8)


def test_cpu_path_counts_no_launch():
    reset_launch_counts()
    _detect()
    assert not any(launch_counts().values()) and mode_launch_counts() == {}


@pytest.mark.gpu
def test_cuda_detect_counts_its_modes():
    """One call on the card.  On int16 codes (no history): kernel C once on
    the gate input alone, on its exact integer path (modes ``detect``,
    ``gate_input`` and ``exact_i16``), B once in
    its plain mode, then the peak capture once, nothing primed, with the
    capture's spans inside the detector's.  On float32: C
    once in detect mode, B once in capture mode.  The Minn detector's B
    counts no capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    _detect(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    table, _, _ = _detect(dev, batch=8, n=16384)
    torch.cuda.synchronize()
    counts, modes = launch_counts(), mode_launch_counts()
    assert counts["aa_metric"] == counts["gate_events"] == counts["aa_peak_capture"] == 1
    assert modes == {"aa_metric/detect": 1, "aa_metric/gate_input": 1,
                     "aa_metric/exact_i16": 1}
    assert bool(table.valid.any())
    spans = _spans(lambda: _detect(dev, batch=8, n=16384))
    cap = [e for e in spans if e.name == profiling.wrapper_spans("aa_peak_capture").call]
    assert len(cap) == 1 and cap[0].cpu_parent.name == DETECT

    reset_launch_counts()
    x = _codes((4, 8, 16384), dtype=torch.float32, device=dev)
    table, _, _ = AA.aa_detect_fused(x, half_len=L, hysteresis=16)
    torch.cuda.synchronize()
    counts, modes = launch_counts(), mode_launch_counts()
    assert counts["aa_metric"] == counts["gate_events"] == 1 and counts["aa_peak_capture"] == 0
    assert modes == {"aa_metric/detect": 1, "gate_events/capture": 1}
    assert bool(table.valid.any())
    from ofdm_sync_tpu_torch.kernels import minn_rtl_fused as F

    reset_launch_counts()
    F.minn_rtl_detect_fused(_codes((4, 8, 16384), device=dev), quarter_len=L, smooth_shift=3,
                            threshold_value=3276, threshold_frac_bits=15, hysteresis=2)
    torch.cuda.synchronize()
    assert "gate_events/capture" not in mode_launch_counts()
    assert launch_counts()["gate_events"] == 1
