"""The port's CLI ``waveform``, `utils.profiling`, the package surface
(`kernels` re-exports, the top-level parameter names) and a run without
matplotlib.

* ``waveform``: each kind writes its PNG and prints the JAX CLI's line;
* `profiling.trace` writes a Chrome trace; `Throughput` and `kernel_stats`
  measure a CPU function (tests/test_cli_and_demo.py:47-68);
* `ofdm_sync_tpu_torch.kernels` re-exports the counterparts of the JAX
  package's names lazily, and raises AttributeError for its TPU-only ones;
  the nine parameter names of `ofdm_sync_tpu/__init__.py` are exported;
* with matplotlib made unimportable, ``sc --no-plots`` and ``aa --no-plots``
  (on a small grid) run through the CLI in a fresh interpreter.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import ofdm_sync_tpu as jpkg  # noqa: E402
from ofdm_sync_tpu.__main__ import main as j_main  # noqa: E402
import ofdm_sync_tpu_torch as tpkg  # noqa: E402
from ofdm_sync_tpu_torch import kernels  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from ofdm_sync_tpu_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind", ["preamble", "qpsk", "frame", "aa_preamble"])
def test_waveform_matches_jax(tmp_path, capsys, kind):
    assert j_main(["waveform", kind, "--out", str(tmp_path / "j"), "--seed", "3"]) == 0
    jline = capsys.readouterr().out.replace(str(tmp_path / "j"), "<out>")
    assert t_main(["waveform", kind, "--out", str(tmp_path / "t"), "--seed", "3"]) == 0
    tline = capsys.readouterr().out.replace(str(tmp_path / "t"), "<out>")
    assert tline == jline and f"<out>/{kind}.png" in tline
    assert (tmp_path / "t" / f"{kind}.png").stat().st_size > 0
    if kind == "aa_preamble":
        assert "PAPR 3.69 dB" in tline   # the documented [A][A] figure


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as path:
        (torch.ones((64, 64)) * 2).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert path == str(tmp_path / "tr" / "trace.json") and events


def test_throughput_and_kernel_stats(capsys):
    x = torch.ones((4, 256))
    stats = profiling.Throughput(samples_per_call=4 * 256, warmup=1).measure(
        lambda v: (v * 2).sum(), x, iters=3)
    assert stats["samples_per_sec"] > 0 and stats["iters"] == 3
    stats2 = profiling.kernel_stats(lambda v: (v, v.sum()), x, samples_per_call=4 * 256,
                                    iters=2, label="test")
    assert stats2["iters"] == 2
    out = capsys.readouterr().out
    assert out.startswith("test: ") and "M IQ samples/s" in out and "ms/call)" in out


def test_kernel_reexports():
    from ofdm_sync_tpu_torch.kernels import minn_rtl_fused, streaming

    assert kernels.to_planar is streaming.to_planar
    assert kernels.aa_metric_planar is streaming.aa_metric_planar
    assert kernels.minn_rtl_detect_fused is minn_rtl_fused.minn_rtl_detect_fused
    for name in ("streaming", "streaming_chunked", "minn_rtl_fused", "aa_fused", "zc_fused",
                 "matched_filter"):
        assert getattr(kernels, name).__name__ == f"ofdm_sync_tpu_torch.kernels.{name}"
    for name in ("to_time_tiled", "from_time_tiled", "no_such_name"):
        with pytest.raises(AttributeError):
            getattr(kernels, name)
    x = torch.randn(3, 2, 50, dtype=torch.complex64)
    p = kernels.to_planar(x)
    assert p.shape == (3, 2, 2, 50) and p.dtype == torch.float32
    assert torch.equal(kernels.from_planar(p), x)


def test_kernels_package_imports_lazily():
    """A name of `kernels` loads its submodule on first access (the
    package's own import loads none that the top-level exports do not
    need), and no access builds the CUDA library."""
    code = ("import sys, ofdm_sync_tpu_torch.kernels as k\n"
            "mf = 'ofdm_sync_tpu_torch.kernels.matched_filter'\n"
            "assert mf not in sys.modules\n"
            "for name in k.__all__: getattr(k, name)\n"
            "assert mf in sys.modules\n"
            "assert k.build.build.cache_info().currsize == 0\n"
            "assert k.build.library.cache_info().currsize == 0\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_top_level_parameter_names():
    names = ("SystemParams", "SYS_30M72", "SYS_AA_10M", "SCDetectorParams",
             "MinnDetectorParams", "MinnRTLParams", "ZCParams", "ZCStreamingParams",
             "AADetectorParams")
    for name in names:
        assert hasattr(jpkg, name)
        assert getattr(tpkg, name).__module__ == "ofdm_sync_tpu_torch.params"


def test_runs_without_matplotlib(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import functools\n"
        "from ofdm_sync_tpu_torch.__main__ import main\n"
        "from ofdm_sync_tpu_torch.pipelines import aa\n"
        "aa.run_grid_test = functools.partial(aa.run_grid_test, snr_values=(10,), "
        "channels=(None,), full_scale_ratios=(1.0,), preamble_lengths=(256,))\n"
        "assert main(['sc', '--device', 'cpu', '--no-plots']) == 0\n"
        "assert main(['aa', '--device', 'cpu', '--no-plots']) == 0\n"
        "assert not [m for m in sys.modules if m.startswith('matplotlib.')]\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ALL SIMULATIONS COMPLETE" in r.stdout and "Total tests: 1" in r.stdout
    assert not (tmp_path / "plots").exists()
