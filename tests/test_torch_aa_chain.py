"""The [A][A] receive chain and grid harness, port vs JAX and vs the
reference, end to end.

* `run_fused_rx`: JAX runs its fused TPU kernel in Pallas interpret mode,
  the port the plain versions of kernels C + B on the CPU.  Frame starts
  must be equal, CFO within 0.5 Hz, EVM within 0.05 percentage points, and
  the printed report equal up to the digits of its decimal numbers.
* `run_single_test` reproduces the reference's own recorded grid
  (tests/fixtures/reference_aa_grid.json) with the checks of
  tests/test_grid_parity.py:61-78: the 15 quick cells here, the other 120
  under `slow`.
* `run_grid_test_fused`: the port's quantized grid batch, fed to JAX's
  `aa_detect_fused_pallas`, gives the same per-config outcomes (the port's
  noise comes from a `torch.Generator`, JAX's from `jax.random` keys, so
  the batch itself is the port's).
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.kernels.pallas_aa import aa_detect_fused_pallas  # noqa: E402
from ofdm_sync_tpu.pipelines.fused_rx import run_fused_rx as j_run  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import aa  # noqa: E402
from ofdm_sync_tpu_torch.pipelines.fused_rx import run_fused_rx as t_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "reference_aa_grid.json"


def _numbers_out(text):
    """The report with every decimal number replaced (integers stay)."""
    return re.sub(r"-?\d+\.\d+", "#", text).splitlines()


@pytest.mark.parametrize("channel,frames", [(None, 1), (None, 2), ("cir1", 1), ("cir1", 2)])
def test_receive_chain_matches_jax(capsys, channel, frames):
    kw = dict(snr_db=10.0, channel_name=channel, num_frames=frames)
    jr = j_run(**kw)
    jout = capsys.readouterr().out
    tr = t_run(**kw, device="cpu")
    tout = capsys.readouterr().out
    assert jr.detected and tr.detected
    assert len(jr.frames) == len(tr.frames) == frames
    for fj, ft in zip(jr.frames, tr.frames):
        assert ft.timing_error == fj.timing_error
        assert abs(ft.cfo_error_hz - fj.cfo_error_hz) < 0.5
        assert abs(ft.evm_pct - fj.evm_pct) < 0.05
    assert len(tr.starts) == frames
    assert _numbers_out(tout) == _numbers_out(jout)


def test_cli_defaults_to_the_aa_chain(capsys):
    assert t_main(["fused_rx", "--snr", "10", "--num-frames", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[A][A] 1024, AWGN, SNR +10 dB" in out and "Frame 1:" in out


def test_cli_preamble_length(capsys):
    assert t_main(["fused_rx", "--family", "aa", "--preamble-len", "512", "--channel",
                   "cir2", "--device", "cpu"]) == 0
    assert "[A][A] 512, CIR2" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The reference's own grid
# ---------------------------------------------------------------------------

def _cells():
    rows = json.loads(FIXTURE.read_text())["results"]
    ids = [f"L{r['preamble_length']//2}-{r['channel']}-snr{r['snr_db']:+.0f}"
           f"-fs{r['full_scale_ratio']}" for r in rows]
    return rows, ids


_ROWS, _IDS = _cells()


def _quick_idx():
    """tests/test_grid_parity.py's stratified 15-cell sample: every
    (channel, SNR) pair once, rotating through the full-scale ratios and
    preamble lengths."""
    seen, picked = {}, {}
    for i, r in enumerate(_ROWS):
        key = (r["channel"], r["snr_db"])
        want = seen.setdefault(key, ([0.5, 1.0, 2.0][len(seen) % 3],
                                     [1024, 512, 256][(len(seen) // 3) % 3]))
        if (r["full_scale_ratio"], r["preamble_length"]) == want and key not in picked:
            picked[key] = i
    return sorted(picked.values())


_QUICK = _quick_idx()
assert len(_QUICK) == 15


def _check_cell(ref):
    got = aa.run_single_test(
        snr_db=ref["snr_db"],
        channel_name=None if ref["channel"] == "awgn" else ref["channel"],
        full_scale_ratio=ref["full_scale_ratio"],
        preamble_length=ref["preamble_length"],
        cfo_hz=ref["cfo_applied_hz"],
        seed=42,
        device="cpu",
    )
    assert bool(got.detected) == bool(ref["detected"])
    assert int(got.num_events) == int(ref["num_events"])
    if ref["detected"]:
        assert int(got.timing_error) == int(ref["timing_error"])
        assert abs(got.cfo_estimated_hz - ref["cfo_estimated_hz"]) < 0.5
    assert abs(got.clipping_pct - ref["clipping_pct"]) < 0.05
    assert abs(got.effective_bits - ref["effective_bits"]) < 0.02
    assert abs(got.metric_peak - ref["metric_peak"]) < 2e-3


@pytest.mark.parametrize("ref", [_ROWS[i] for i in _QUICK], ids=[_IDS[i] for i in _QUICK])
def test_grid_cell_matches_reference_quick(ref):
    _check_cell(ref)


@pytest.mark.slow
@pytest.mark.parametrize(
    "ref", [r for i, r in enumerate(_ROWS) if i not in set(_QUICK)],
    ids=[s for i, s in enumerate(_IDS) if i not in set(_QUICK)])
def test_grid_cell_matches_reference_full(ref):
    _check_cell(ref)


def test_run_grid_test_and_summary(capsys):
    results = aa.run_grid_test(snr_values=(0, 15), channels=(None,),
                               full_scale_ratios=(1.0,), preamble_lengths=(1024,),
                               device="cpu")
    aa.print_summary_table(results)
    out = capsys.readouterr().out
    assert len(results) == 2 and "[  2/2] L=512 awgn" in out
    assert "DETECTION RATE BY PREAMBLE LENGTH AND CHANNEL" in out
    assert results[1].detected and abs(results[1].timing_error) <= 2


# ---------------------------------------------------------------------------
# The fused sweep
# ---------------------------------------------------------------------------

def _jax_outcomes(iq, L):
    """JAX's fused kernel on the given batch, reduced as
    `pipelines/aa.py:_fused_sweep` reduces it."""
    fs_hz = aa.SYS.sample_rate_hz
    table, P_pk, M_pk = aa_detect_fused_pallas(
        jnp.asarray(iq), half_len=L, threshold=aa._GRID_PARAMS.threshold,
        hysteresis=aa._GRID_PARAMS.hysteresis, max_events=8, channel_leading=True)
    valid, M, P = np.asarray(table.valid), np.asarray(M_pk), np.asarray(P_pk)
    best = np.argmax(np.where(valid, M, -np.inf), axis=-1)
    rows = np.arange(len(best))
    peak = np.asarray(table.peak_idx)[rows, best]
    return {
        "detected": np.asarray(table.count) > 0,
        "frame_start": peak - 2 * L + 1,
        "cfo_est": np.arctan2(P[rows, 1, best].astype(np.float64),
                              P[rows, 0, best].astype(np.float64)) * fs_hz / (2 * np.pi * L),
        "metric_peak": M[rows, best],
        "num_events": np.asarray(table.count),
    }


@pytest.mark.parametrize("channel", [None, "cir1"])
def test_fused_sweep_matches_jax_kernel(channel):
    snr, fsr = (-5.0, 0.0, 5.0, 10.0, 15.0), (0.25, 0.5, 1.0, 1.5, 2.0)
    out = aa.run_grid_test_fused(channel_name=channel, snr_values=snr, full_scale_ratios=fsr,
                                 device="cpu")
    x, true_start, L = aa._grid_clean_stream(1024, channel, 42, torch.device("cpu"))
    iq = aa._grid_batch(x, snr, fsr, 500.0, 42)
    assert iq.shape == (4, 25, x.shape[-1]) and iq.dtype == torch.float32
    ref = _jax_outcomes(iq.numpy(), L)
    for k in ("detected", "frame_start", "num_events"):
        np.testing.assert_array_equal(out[k].reshape(-1), ref[k], err_msg=k)
    det = ref["detected"]
    np.testing.assert_allclose(out["cfo_est"].reshape(-1)[det], ref["cfo_est"][det], atol=0.5)
    np.testing.assert_allclose(out["metric_peak"].reshape(-1), ref["metric_peak"], atol=1e-4)
    np.testing.assert_array_equal(out["timing_error"], out["frame_start"] - true_start)
    # high SNR, unclipped: found at the true start
    assert bool(out["detected"][-1, -1]) and abs(int(out["timing_error"][-1, -1])) <= 100
    assert out["detected"].shape == (5, 5)


def test_fused_sweep_is_seeded():
    kw = dict(snr_values=(0.0, 10.0), full_scale_ratios=(1.0,), seed=3, device="cpu")
    a = aa.run_grid_test_fused(**kw)
    b = aa.run_grid_test_fused(**kw)
    for k in ("detected", "frame_start", "cfo_est", "metric_peak", "num_events"):
        np.testing.assert_array_equal(a[k], b[k])


def test_aa_pipelines_import_no_jax():
    code = ("import sys; import ofdm_sync_tpu_torch.pipelines.aa, "
            "ofdm_sync_tpu_torch.pipelines.fused_rx, ofdm_sync_tpu_torch.kernels.launches; "
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
