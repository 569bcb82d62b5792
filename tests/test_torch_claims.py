"""The port's claims check (`ofdm_sync_tpu_torch.claims`): every number
README.md's port section and PERF.md section 5 quote from the port's
committed bench lines holds against the latest `BENCH_torch_r*.json` /
`SCALING_torch_r*.json`; a changed number or a changed wording fails."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from ofdm_sync_tpu_torch import claims

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quoted_numbers_hold():
    n, errors = claims.check()
    assert n == len(claims.CLAIMS) >= 20
    assert not errors, errors


def test_command_exits_zero():
    p = subprocess.run([sys.executable, "-m", "ofdm_sync_tpu_torch.claims"], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "checked" in p.stdout


def _copy(tmp_path):
    for name in ("README.md", "PERF.md"):
        shutil.copy(os.path.join(ROOT, name), tmp_path / name)
    for pattern in claims.ARTIFACTS.values():
        shutil.copy(claims.latest(ROOT, pattern)[0], tmp_path)
    return tmp_path


@pytest.mark.parametrize("doc", ["README.md", "PERF.md"])
def test_a_changed_number_fails(tmp_path, doc):
    root = _copy(tmp_path)
    text = (root / doc).read_text()
    c = next(c for c in claims.CLAIMS if c.doc == doc and c.path == ("headline", "median_ms"))
    m = re.search(c.pattern, text)
    wrong = f"{float(m.group(1)) * 1.5:.3f}"
    (root / doc).write_text(text[: m.start(1)] + wrong + text[m.end(1):])
    _, errors = claims.check(str(root))
    assert len(errors) == 1 and "does not hold" in errors[0] and doc in errors[0]


def test_a_changed_wording_or_artifact_fails(tmp_path):
    root = _copy(tmp_path)
    text = (root / "README.md").read_text()
    (root / "README.md").write_text(text.replace("IQ samples/s on one card", "samples/s"))
    _, errors = claims.check(str(root))
    assert any("claim not found" in e for e in errors)
    path = claims.latest(str(root), claims.ARTIFACTS["scaling"])[0]
    line = json.load(open(path))
    line["card"]["sharded_overhead_ratio"] *= 2
    json.dump(line, open(path, "w"))
    _, errors = claims.check(str(root))
    assert sum("sharded_overhead_ratio" in e for e in errors) == 2


def test_point_and_range_bands():
    m = re.search(r"([\d.]+)", "1.174 ms")
    assert claims.band(m) == pytest.approx((1.1735, 1.1745))
    m = re.search(r"([\d.]+(?:e[+-]?\d+)?)", "1.15e+11 samples/s")
    assert claims.band(m) == pytest.approx((1.145e11, 1.155e11))
    m = re.search(r"([\d.]+)-([\d.]+)", "0.2-0.26")
    assert claims.band(m) == (0.2, 0.26)
