"""The trace reader on a hand-made event list: a stage's device time by
correlation id, every device event counted, idle time split by span."""

import pytest
from torch.autograd import DeviceType

from benchmark import trace as T


class Event:
    """The fields of a kineto event the reader uses (no activity type, as
    on older torch builds)."""

    def __init__(self, name, on_device, t0, dur, corr=0):
        self._n, self._d, self._t0, self._dur, self._c = name, on_device, t0, dur, corr

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0

    def start_thread_id(self):
        return 1


class Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_parse():
    events = [
        Event("window", False, 0, 1000),
        Event("detect_call", False, 100, 100),
        Event("cudaLaunchKernel", False, 150, 5, corr=7),
        Event("kernel_a", True, 160, 300, corr=7),
        Event("detect_call", True, 160, 300),          # the annotation's device echo
        Event("cudaMemcpyAsync", False, 910, 5, corr=9),  # launched outside any stage
        Event("Memcpy DtoH", True, 950, 20, corr=9),
        Event("wait_due", False, 500, 400),
    ]
    t = T.parse(Prof(events), ("detect_call",), span_names=("wait_due",))
    assert t["stage_device_s"] == {"detect_call": pytest.approx(300e-9)}
    assert t["device_events"] == 2 and t["matched"] == 1
    assert t["busy_s"] == pytest.approx(320e-9) and t["window_s"] == pytest.approx(1000e-9)
    idle = dict(t["idle_gaps"])
    assert idle["wait_due"] == pytest.approx(400e-9)
    assert idle["detect_call"] == pytest.approx(60e-9)
    assert idle["none"] == pytest.approx((100 + 40 + 50 + 30) * 1e-9)
    assert [n for n, _ in t["device_ops"]] == ["kernel_a", "Memcpy DtoH"]


def test_traced_part_of_a_window(monkeypatch):
    """The profiler records only the first TRACE_S seconds; the window runs
    on, and its calls are all judged."""
    import torch

    from benchmark import harness as H
    from benchmark import run as R

    monkeypatch.setattr(H, "TRACE_S", 0.2)
    cell = H.Cell(H.load_spec(), "minn_rtl_fpga.sweep")
    cell.traffic.update(batch=2, samples=1 << 14, distinct=2)
    res = R.run_cell(cell, 11, 0.8, True, torch.device("cpu"))
    assert res["line"]["correct"]
    assert 0.2 <= res["trace"]["window_s"] < 0.6 <= res["window"]["window_s"]
    assert res["run"].stage_bound_s["detect_call"] > 0
