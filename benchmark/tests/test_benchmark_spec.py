"""BENCHMARK.json and the harness's boundaries, on the CPU: the file's
shape, the result line, a cell added by files and entries alone, and what
the benchmark may import and touch."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness as H

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(scope="module")
def spec():
    return H.load_spec(ROOT)


def test_spec_shape(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in spec["workloads"]] + \
        [c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    assert all(w["chips"] in (1, 4) for w in spec["workloads"])


def test_every_cell_resolves_and_reports(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        cell = H.Cell(spec, w["name"], ROOT)
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            # the metric's moves target is reported in the same cell
            assert m["moves"] in e2e and m["moves"] in names, (w["name"], m["name"])
    for m in spec["per_layer"]:
        for w in m.get("workloads", []):
            assert any(x["name"] == w for x in spec["workloads"])


def _line(trace: bool):
    checks = {"unexcused_events": (0, 0), "peak_value_gap": (1e-7, 1e-5)}
    return H.result_line(
        correct=H.passed(checks), attempted=100, failed=0,
        metrics={"sweep_rate": {"value": 1.2e11, "unit": "samples/s"},
                 "setup_s": {"value": 9.5, "unit": "s"}},
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                "memory_peak_bytes": 5 << 30, **({"busy_s": 9.7, "window_s": 10.0}
                                                 if trace else {})},
        checks=checks,
        breakdown={"device_ops": [["k", 1.0]], "idle_gaps": [["wait_due", 0.3]]}
        if trace else None)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line(spec, trace):
    line = json.loads(json.dumps(_line(trace)))
    # the contract's keys, then each number compared beside its limit under
    # a key of its own that comes last
    keys = LINE_KEYS | ({"breakdown"} if trace else set()) | {"checks"}
    assert set(line) == keys
    assert list(line)[-1] == "checks"
    assert line["checks"] == {"unexcused_events": {"value": 0, "limit": 0},
                              "peak_value_gap": {"value": 1e-7, "limit": 1e-5}}
    assert line["correct"] is True
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
    for d in ("platform", "kind", "count", "memory_peak_bytes"):
        assert d in line["device"]
    if trace:
        assert line["device"]["busy_s"] > 0 and len(line["breakdown"]["device_ops"]) <= 10


def test_failed_check_is_incorrect():
    assert not H.passed({"unexcused_events": (1, 0)})
    assert not H.passed({"peak_value_gap": (float("inf"), 1e-5)})


def test_new_cell_from_files_only(tmp_path, spec):
    """A configuration with a preamble kind and an input dtype of its own, a
    traffic mix, a metric reader and their entries added to a copy: the
    harness lists and resolves the cell and makes its inputs, and no file
    that was there changes."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    new_spec = json.loads(json.dumps(spec))
    cfg = json.loads((root / "benchmark/configs/minn_rtl_fpga.json").read_text())
    cfg["detector"]["quarter_len"] = 256
    cfg["preamble"] = {"kind": "aa_twice", "half_len": 256}
    cfg["input"]["dtype"] = "int32"
    (root / "benchmark/configs/minn_q256.json").write_text(json.dumps(cfg))
    (root / "benchmark/preambles/aa_twice.py").write_text(
        "import numpy as np\n\n"
        "def template(config):\n"
        "    n = config['preamble']['half_len']\n"
        "    a = np.exp(1j * np.pi * np.arange(n) ** 2 / n)\n"
        "    return np.concatenate([a, a])\n")
    traffic = json.loads((root / "benchmark/traffic/sweep.json").read_text())
    traffic["batch"] = 1024
    (root / "benchmark/traffic/wide.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/kernel_share.wide.py").write_text(
        "def read(run):\n    return run.roofline('detect_call')\n")
    (root / "benchmark/reference/minn_q256.py").write_text(
        "from benchmark.reference.minn_rtl_fpga import *  # noqa: F401,F403\n")
    new_spec["configs"].append({"name": "minn_q256", "source": "https://example.org/q256",
                                "file": "benchmark/configs/minn_q256.json", "reduced": [],
                                "why": "another quarter length"})
    new_spec["workloads"].append({"name": "minn_q256.wide", "config": "minn_q256",
                                  "traffic": "wide", "chips": 1, "why": "wider batches"})
    new_spec["end_to_end"][0]["workloads"].append("minn_q256.wide")
    new_spec["per_layer"].append({"name": "kernel_share.wide", "unit": "%", "better": "higher",
                                  "source": "device_trace", "layer": "detect wrappers",
                                  "moves": "sweep_rate", "workloads": ["minn_q256.wide"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new_spec))
    cell = H.Cell(H.load_spec(root), "minn_q256.wide", root)
    assert cell.traffic["batch"] == 1024 and cell.config["detector"]["quarter_len"] == 256
    assert [m["name"] for m in cell.per_layer] == ["kernel_share.wide"]
    assert {m["name"] for m in cell.end_to_end} == {"sweep_rate", "setup_s"}
    assert cell.entry_path.name == "minn_detect.py"
    assert cell.reader("kernel_share.wide").read(H.Run(trace=None)) is None
    code = ("from benchmark import harness as H, stimulus\n"
            "c = H.Cell(H.load_spec(), 'minn_q256.wide')\n"
            "x = stimulus.streams(c.config, c.traffic, stimulus.seeded(3, 'cpu'), 2, 1 << 14,"
            " 'cpu')\n"
            "print(stimulus.__file__, x.dtype, tuple(x.shape),"
            " stimulus.template(c.config).shape[0], sep='|')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    where, dt, shape, plen = out.stdout.strip().split("|")
    assert Path(where).resolve().is_relative_to(root.resolve())
    assert (dt, shape, plen) == ("torch.int32", "(4, 2, 16384)", "512")
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_reference_imports_nothing_of_the_program():
    files = list((BENCH / "reference").glob("*.py")) + list((BENCH / "work").glob("*.py")) + \
        list((BENCH / "preambles").glob("*.py")) + [BENCH / "stimulus.py"]
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "ofdm_sync_tpu_torch" not in tops and not tops & set(H.FORBIDDEN), path


def test_no_module_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(H.FORBIDDEN), path


def test_forbidden_modules_compares_whole_names():
    mods = ["ofdm_sync_tpu_torch", "ofdm_sync_tpu_torch.kernels", "jaxtyping", "torch"]
    assert H.forbidden_modules(mods) == []
    assert H.forbidden_modules(mods + ["jax.numpy", "ofdm_sync_tpu.ops", "flax"]) == [
        "flax", "jax.numpy", "ofdm_sync_tpu.ops"]


def test_no_fixed_scratch_paths():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "/tmp" not in text and "/dev/shm" not in text, path


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints nothing on stdout;
    it never falls back to the CPU."""
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "minn_rtl_fpga.sweep", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    if out.returncode == 0:
        pytest.skip("a card is present")
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_setup_loads_no_jax():
    """A cell's set-up and window (on the CPU, at a tiny size) leave no
    module of JAX or the JAX package in sys.modules."""
    code = (
        "import sys, torch\n"
        "from benchmark import harness as H, run as R\n"
        "c = H.Cell(H.load_spec(), 'minn_rtl_fpga.sweep')\n"
        "c.traffic.update(batch=2, samples=1 << 14, distinct=2)\n"
        "R.run_cell(c, 7, 0.2, False, torch.device('cpu'))\n"
        "print(H.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
