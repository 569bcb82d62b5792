"""The flagship Minn-RTL receive chain, port vs JAX, end to end.

JAX runs its fused TPU kernel in Pallas interpret mode; the port runs the
plain versions of its CUDA kernels on the CPU.  Frame starts and valid
flags must be equal, CFO within 0.5 Hz, EVM within 0.05 percentage points.
These are the only Q = 512 interpret-mode runs of the port's tests.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu.models.detectors import MinnRTLDetector as JDetector  # noqa: E402
from ofdm_sync_tpu.ops.waveforms import build_minn_rtl_preamble  # noqa: E402
from ofdm_sync_tpu.params import MinnRTLParams, SYS_30M72  # noqa: E402
from ofdm_sync_tpu.pipelines import common as jcommon  # noqa: E402
from ofdm_sync_tpu.pipelines.fused_rx import run_fused_rx_minn_rtl as j_run  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from ofdm_sync_tpu_torch.models.detectors import MinnRTLDetector  # noqa: E402
from ofdm_sync_tpu_torch.pipelines.fused_rx import run_fused_rx_minn_rtl as t_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "ofdm_sync_tpu_torch"


def _jax_rx(channel, snr):
    rng = np.random.default_rng(0)
    pre = build_minn_rtl_preamble("qpsk_freq", rng, Q=512)
    setup = jcommon.build_setup(pre, rng, channel_name=channel, cir_mode="two",
                                snr_db=snr, cfo_hz=1000.0, two_frames=True)
    rx = np.concatenate([setup.rx, np.zeros((setup.rx.shape[0], 768), setup.rx.dtype)], -1)
    return rx, setup.extras["frame_len"]


def test_detect_fused_frames_matches_jax():
    """The same JAX-built cir1 stream through both detectors."""
    rx, flen = _jax_rx("cir1", 0.0)
    jres, jf, js, jv = JDetector(SYS_30M72, MinnRTLParams()).detect_fused_frames(
        rx, frame_len=flen, max_frames=4)
    tres, tf, ts, tv = MinnRTLDetector(SYS_30M72, MinnRTLParams()).detect_fused_frames(
        torch.from_numpy(rx), frame_len=flen, max_frames=4)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tf.numpy(), jf)
    assert int(tv.sum()) == 2
    assert [(e.gate_start, e.gate_end, e.peak_index, e.closed) for e in tres.events] == \
        [(e.gate_start, e.gate_end, e.peak_index, e.closed) for e in jres.events]


def _norm(text):
    """Printed report with the detector description (which names the
    kernel) and the numbers after the 2nd decimal left out."""
    text = re.sub(r"detector: .*", "detector: -", text)
    return text.splitlines()


def test_receive_chain_matches_jax(capsys):
    kw = dict(snr_db=30.0, cfo_hz=1000.0, seed=0)
    jr = j_run(**kw)
    jout = capsys.readouterr().out
    tr = t_run(**kw, device="cpu")
    tout = capsys.readouterr().out
    assert jr.detected and tr.detected
    assert len(jr.frames) == len(tr.frames) == 2
    assert tr.starts == [1336, 16696]
    for fj, ft in zip(jr.frames, tr.frames):
        assert ft.timing_error == fj.timing_error
        assert abs(ft.cfo_error_hz - fj.cfo_error_hz) < 0.5
        assert abs(ft.evm_pct - fj.evm_pct) < 0.05
    assert _norm(tout) == _norm(jout)


def test_cli_runs_the_chain(capsys):
    assert t_main(["fused_rx", "--family", "minn_rtl", "--snr", "30", "--channel",
                   "cir2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "CIR2, SNR +30 dB" in out and "Frame 1:" in out


def test_detector_detect_matches_jax(rng):
    """The non-fused `detect` path (metric + extract) at Q = 64."""
    params = MinnRTLParams(quarter_len=64)
    x = (rng.standard_normal((2, 3000)) + 1j * rng.standard_normal((2, 3000))) * 0.2
    A = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    pre = np.concatenate([-A, A, A, -A, -A]) / np.sqrt(2)
    x[:, 900: 900 + 320] += pre
    x = x.astype(np.complex64)
    _, jr = JDetector(SYS_30M72, params).detect(x)
    state, tr = MinnRTLDetector(SYS_30M72, params).detect(torch.from_numpy(x))
    # everything exact but the float peak value (1e-4 * max(1, |ref|))
    strip = lambda e: {k: v for k, v in vars(e).items() if k != "peak_value"}  # noqa: E731
    assert [strip(e) for e in tr.events] == [strip(e) for e in jr.events]
    for et, ej in zip(tr.events, jr.events):
        assert abs(et.peak_value - ej.peak_value) <= 1e-4 * max(1.0, abs(ej.peak_value))
    np.testing.assert_array_equal(tr.gate_mask, jr.gate_mask)
    assert len(tr.events) == 1 and state.corr_positive.shape == (3000,)


def test_port_sources_never_import_jax():
    bad = [str(p) for p in PKG.rglob("*.py")
           if re.search(r"^\s*(import jax|from jax)", p.read_text(), re.M)]
    assert not bad, bad
    bad = re.search(r"^\s*(import jax|from jax|import ofdm_sync_tpu\.(?!params))",
                    (ROOT / "chip_smoke.py").read_text(), re.M)
    assert bad is None


def test_port_import_loads_no_jax():
    code = ("import sys; import ofdm_sync_tpu_torch.pipelines.fused_rx, "
            "ofdm_sync_tpu_torch.kernels.build; "
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No card: non-zero exit and no result line.  Alone in a directory
    (no package beside it): the same."""
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a card")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, shutil.copy(ROOT / "chip_smoke.py", tmp_path))):
        p = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                           text=True, timeout=300)
        assert p.returncode != 0
        assert '"ok": true' not in p.stdout
