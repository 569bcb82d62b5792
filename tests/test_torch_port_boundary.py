"""The port stands alone: its own parameters and data, no JAX import, the
card as its default device.

* every field of every parameter constant of `ofdm_sync_tpu_torch.params`
  equals the JAX package's;
* the port's `data/channels.npz` is a byte-for-byte copy of the JAX
  package's (same SHA-256);
* a fresh interpreter that imports every module of the port (the
  sharded path `ofdm_sync_tpu_torch.parallel` among them) and
  `chip_smoke.py` (and so everything it imports) has loaded neither `jax`,
  `ofdm_sync_tpu` nor `matplotlib`;
* the port's binding of the C++ oracle builds into the port's own
  `kernels/_build/`, never into the JAX package's `native/build/`;
* `resolve_device(None)` is the current CUDA device, and raises where
  there is none.
"""

import dataclasses
import hashlib
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import ofdm_sync_tpu.params as jparams  # noqa: E402
import ofdm_sync_tpu_torch.params as tparams  # noqa: E402
from ofdm_sync_tpu_torch import device as tdevice  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONSTANTS = ["SYS_30M72", "SYS_AA_10M", "SYS_DEMO_512"]
DETECTOR_PARAMS = ["SCDetectorParams", "MinnDetectorParams", "MinnRTLParams", "ZCParams",
                   "ZCStreamingParams", "AADetectorParams", "SystemParams"]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", CONSTANTS)
def test_system_constants_equal_jax(name):
    t, j = getattr(tparams, name), getattr(jparams, name)
    assert _fields(t) == _fields(j)
    assert (t.half, t.quarter) == (j.half, j.quarter)


@pytest.mark.parametrize("name", DETECTOR_PARAMS)
def test_detector_params_equal_jax(name):
    t, j = getattr(tparams, name)(), getattr(jparams, name)()
    assert _fields(t) == _fields(j)
    assert type(t).__module__ == "ofdm_sync_tpu_torch.params"


def test_channel_bank_is_a_copy():
    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    port = os.path.join(ROOT, "ofdm_sync_tpu_torch", "data", "channels.npz")
    assert sha(port) == sha(os.path.join(ROOT, "ofdm_sync_tpu", "data", "channels.npz"))
    from ofdm_sync_tpu_torch.ops import channel

    assert os.path.samefile(channel._DATA_DIR / "channels.npz", port)
    assert channel.load_measured_cir("cir1").shape[0] == 2


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the package (the ctypes binding of the C++ oracle,
    every pipeline and the sharded path among them), then chip_smoke (its
    imports), in a fresh interpreter: neither jax, the JAX package nor
    matplotlib (which the card's machine lacks) gets loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ofdm_sync_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'ofdm_sync_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'ofdm_sync_tpu', 'matplotlib')]\n"
        "assert len(mods) > 20, mods\n"
        "want = ['native', 'pipelines.sc', 'pipelines.minn', 'pipelines.minn_rtl',\n"
        "        'pipelines.park', 'pipelines.zc_freq', 'pipelines.combined_sc_minn',\n"
        "        'pipelines.cp_fft_demo', 'parallel', 'parallel.distributed',\n"
        "        'parallel.shard', 'parallel.dryrun']\n"
        "assert not {'ofdm_sync_tpu_torch.' + m for m in want} - set(mods), mods\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_resolve_device_defaults_to_the_card(monkeypatch):
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError):
        tdevice.resolve_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tdevice.resolve_device(None) == torch.device("cuda", 0)


def test_native_builds_in_the_ports_own_tree():
    from ofdm_sync_tpu_torch import native

    path = native.lib_path().resolve()
    port_build = os.path.join(ROOT, "ofdm_sync_tpu_torch", "kernels", "_build")
    assert str(path).startswith(port_build + os.sep)
    assert not str(path).startswith(os.path.join(ROOT, "native", "build"))
    assert native.SRC.resolve() == pathlib.Path(ROOT, "native", "src", "minn_rtl.cc").resolve()
    native.load_library()
    assert path.exists()
