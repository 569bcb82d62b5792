"""The port's bench (`ofdm_sync_tpu_torch.bench`) on the CPU.

The bench itself times only on a card; here:

* without a card, both entry points exit non-zero before any timing and
  name the reason, printing no result line;
* the result line has the JAX `bench.py`'s keys (read from its source),
  ``device`` and no ``vs_baseline``; a failed check gives ``check_ok``
  false and no value;
* the headline and ZC check functions, on NumPy-seeded stimulus at a small
  size (the CPU runs the plain versions of the kernels), return tables
  equal to the JAX package's `minn_rtl_metric` + `extract_gate_events` and
  its from-IQ ZC XLA route (`conformance.onchip._zc_xla_table`) on the same
  arrays, ``peak_value`` within 1e-4 of max(1, |ref|) (JAX sums windows in
  float32, the port in float64);
* all five checks pass on the CPU at small shapes.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.conformance.onchip import _zc_xla_table  # noqa: E402
from ofdm_sync_tpu.ops.detect import extract_gate_events as j_extract  # noqa: E402
from ofdm_sync_tpu.ops.metrics import minn_rtl_metric, minn_rtl_valid_from  # noqa: E402
from ofdm_sync_tpu_torch import bench  # noqa: E402
from ofdm_sync_tpu_torch.bench_scaling import rank_stimulus  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_RTOL = 1e-4


def _jax_bench_keys() -> set:
    """The keys of the JSON line the JAX package's bench.py prints."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            return {k.value for k in node.keys}
    raise AssertionError("no result dict in bench.py")


@pytest.mark.parametrize("module", [["ofdm_sync_tpu_torch", "bench"], ["ofdm_sync_tpu_torch.bench"]])
def test_bench_without_a_card_exits_before_timing(module, tmp_path):
    out = tmp_path / "line.json"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", *module, "--out", str(out)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert "{" not in p.stdout and not out.exists()


def _section(per_s=1e9):
    return {"median_ms": 1.0, "p90_ms": 1.2, "n": 100, "per_s": per_s, "bound_ms": 0.5,
            "bound_by": "bytes", "share": 0.5, "launches": {"minn_rtl_metric": 100}}


def _measurement():
    head = {k: _section(2e11) for k in ("f32", "int16", "full_metric", "corr_energy")}
    head["profile"] = {"calls": 100, "busy_ms": "not measured: test"}
    lat = {"fused": {"p50_us": 400.0, "p90_us": 500.0, "n": 120, "marginal_us": 300.0,
                     "bound_us": 1.0, "bound_by": "bytes", "share": 0.0025,
                     "launches": {"minn_rtl_metric": 120, "gate_events": 120}},
           "plain": {"p50_us": 900.0, "p90_us": 950.0, "n": 120, "marginal_us": 800.0,
                     "launches": {}},
           "budget_us": bench.BLOCK_BUDGET_US}
    sec = {name: _section() for name in ("aa_fused", "aa_metric", "zc_cfar", "zc_iq_f32",
                                         "zc_iq_int16", "zc_mf_ols", "zc_mf", "zc_e2e_iq",
                                         "zc_freq_sliding")}
    return head, lat, sec


def test_result_line_has_the_jax_keys_and_no_baseline():
    device = {"platform": "gpu", "name": "a card", "count": 1, "nvidia_smi": "a card, 700 W"}
    checks = {name: "ok" for name in bench.CHECKS}
    line = bench.result_line(device, 7, checks, *_measurement())
    jax_keys = _jax_bench_keys()
    assert "vs_baseline" in jax_keys
    assert jax_keys - {"vs_baseline"} <= set(line)
    assert "vs_baseline" not in line
    assert line["device"] == device and line["seed"] == 7
    assert line["metric"] == "iq_samples_per_sec_per_chip" and line["value"] == 2e11
    assert line["checked"] and line["check_ok"] and line["checks"] == checks
    assert line["headline"]["median_ms"] == 1.0 and line["headline"]["n"] == 100
    assert len(line["kernels"]) == 10
    assert all(r["timed"] and all("share" in t for t in r["timed"].values())
               for r in line["kernels"])
    json.dumps(line)


def test_result_line_of_a_failed_check():
    device = {"platform": "gpu", "name": "a card", "count": 1, "nvidia_smi": "a card, 700 W"}
    checks = {name: "ok" for name in bench.CHECKS}
    checks["aa"] = "aa: table field count differs at [[3]]"
    line = bench.result_line(device, 0, checks)
    assert line["checked"] and not line["check_ok"]
    assert line["value"] is None and line["headline"] is None and line["kernels"] is None


def _jax_minn_tables(x: np.ndarray):
    """JAX's `minn_rtl_metric` + `extract_gate_events` on each stream of a
    (4, batch, L) planar array."""
    kw = dict(bench.MINN)
    out = []
    for b in range(x.shape[1]):
        rx = jnp.asarray(x[0::2, b] + 1j * x[1::2, b])
        st = minn_rtl_metric(rx, **kw)
        out.append(j_extract(st.above_threshold, st.corr_positive, hysteresis=bench.HYST,
                             max_events=bench.DETECT["max_events"],
                             valid_from=minn_rtl_valid_from(bench.Q), tie="last",
                             emit_unclosed=False))
    return jax.tree.map(lambda *a: np.stack(a), *out)


def test_headline_check_matches_jax():
    x, events = rank_stimulus(3, batch=4, L=8192, q=bench.Q)
    table = bench.check_minn_rtl(torch.from_numpy(x))
    assert int(table.count.sum()) >= len(events)
    assert_tables_equal(_jax_minn_tables(x), table, "headline check vs JAX", peak_rtol=PEAK_RTOL)


def test_zc_check_matches_jax():
    ref, taps, ref_norm = bench.zc_template()
    R = len(ref)
    rng = np.random.default_rng(4)
    batch, L = 3, 8192
    iq = np.round(8.0 * rng.standard_normal((4, batch, L))).astype(np.float32)
    for b, pos in ((0, 2500), (1, L // 2), (2, L - R - 300)):
        for c, part in ((0, ref.real), (1, ref.imag), (2, ref.real), (3, ref.imag)):
            iq[c, b, pos: pos + R] += np.round(24.0 * part).astype(np.float32)
    n = 1 << int(np.ceil(np.log2(L + R - 1)))
    xc = iq[0::2].astype(np.float64) + 1j * iq[1::2]
    conv = np.fft.ifft(np.fft.fft(xc, n) * np.fft.fft(np.conj(ref[::-1]), n))[..., : L + R - 1]
    mf = np.stack([conv.real, conv.imag], axis=1).reshape(4, batch, -1).astype(np.float32)
    table = bench.check_zc_iq(torch.from_numpy(mf), torch.from_numpy(iq), ref_norm)
    for b, pos in ((0, 2500), (1, L // 2), (2, L - R - 300)):
        peaks = table.peak_idx[b][table.valid[b]].tolist()
        assert any(abs(p - (pos + R - 1)) <= 2 for p in peaks), (b, peaks)
    jt = _zc_xla_table(jnp.asarray(mf), jnp.asarray(iq), ref_len=R, ref_norm=ref_norm,
                       kw=dict(bench.ZC_CFAR, hysteresis=bench.ZC_EVENTS["hysteresis"],
                               max_events=bench.ZC_EVENTS["max_events"]))
    assert_tables_equal(jt, table, "ZC check vs JAX", peak_rtol=PEAK_RTOL)


def test_every_check_passes_on_the_cpu(monkeypatch):
    monkeypatch.setattr(bench, "CHECKS", dict(minn_rtl=(4, 6000), zc_iq=(3, 9000), aa=(3, 9000),
                                              mf=(2, 9000), sharded=(4, 8192)))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    assert bench.run_checks(torch.device("cpu"), 5) == {name: "ok" for name in bench.CHECKS}
