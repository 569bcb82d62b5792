"""The `aa_10m` configuration of the benchmark on the CPU at small sizes:
its plain reference (`benchmark/reference/aa_10m.py`) against the port's
`aa_detect_fused` (the plain path on CPU tensors) and against the JAX
package's `aa_detect_fused_pallas` (interpret mode); the cell's `correct`
for a sound run, for the bfloat16 control and for each planted fault; the
work count; the preamble recipe; and what the reference loads.

JAX is imported inside the one test that uses it, so on a card this file
runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_aa_reference.py
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import harness as H  # noqa: E402
from benchmark import run as R  # noqa: E402
from benchmark import stimulus  # noqa: E402
from benchmark.preambles import aa_zc  # noqa: E402
from benchmark.reference import aa_10m as REF  # noqa: E402
from benchmark.reference import gates as G  # noqa: E402
from benchmark.work import aa_counts as W  # noqa: E402
from benchmark.work.counts import bound_s  # noqa: E402
from ofdm_sync_tpu_torch.kernels import aa_fused as AA  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELL = "aa_10m.sweep"
CPU = torch.device("cpu")
SEED = 2**31 + 4242
#: a few streams of 2^15 samples, 4 preambles each, 2 distinct batches
SMALL = dict(batch=4, samples=1 << 15, distinct=2)


def small() -> H.Cell:
    cell = H.Cell(H.load_spec(ROOT), CELL, ROOT)
    cell.traffic.update(SMALL)
    return cell


def codes(seed: int, batch: int = 4, n: int = 1 << 15, device=CPU):
    cell = small()
    return stimulus.streams(cell.config, cell.traffic, stimulus.seeded(seed, device), batch, n,
                            device)


def detector_kw(det: dict) -> dict:
    return {k: det[k] for k in ("half_len", "threshold", "hysteresis", "max_events", "tie",
                                "emit_unclosed")}


def held(det, x, table, P, M):
    """(unexcused events, excused, peak-value gap, capture gap, CFO gap Hz,
    events) of one program table and its captures against the reference."""
    fs = small().config["system"]["sample_rate_hz"]
    ref, _, _, ref_m, _, amb = REF.detect_block(x, det, "float32")
    prog = {f: np.array(table[f]) for f in G.FIELDS}
    bad, exc, gap = G.compare(prog, G.to_numpy(ref), G.ambiguous_positions(amb),
                              det["hysteresis"])
    cap, cfo, n = REF.capture_gaps(torch.as_tensor(prog["peak_idx"]),
                                   torch.as_tensor(prog["valid"]), torch.as_tensor(P),
                                   torch.as_tensor(M), ref_m, fs, det["half_len"])
    return int(bad.sum()), exc, gap, cap, cfo, n, int(ref["valid"].sum())


@pytest.mark.parametrize("seed", [3, 2**31 + 77, 9_876_543_210])
@pytest.mark.parametrize("n", [1 << 14, 1 << 15])
def test_program_cpu_path_matches_reference(seed, n):
    det = small().config["detector"]
    x = codes(seed, n=n)
    table, P, M = AA.aa_detect_fused(x, **detector_kw(det))
    bad, _, gap, cap, cfo, compared, events = held(det, x, table._asdict(), P, M)
    assert events >= 4 * x.shape[1] - 1 and compared > 0
    assert bad == 0
    assert gap <= REF.LIMITS["peak_value_gap"]
    assert cap <= REF.LIMITS["capture_gap"] and cfo <= REF.LIMITS["cfo_gap_hz"]


def test_reference_matches_jax_pallas():
    """The reference against the JAX package's fused [A][A] kernel in
    interpret mode, on the same codes, under the cell's own limits (JAX sums
    its windows in float32, and its P at the peaks still lies within ~2e-7
    of the exact sums' float32 rounding on these codes)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from ofdm_sync_tpu.kernels.pallas_aa import aa_detect_fused_pallas

    det = small().config["detector"]
    x = codes(11, batch=4, n=1 << 14)
    tab, P, M = aa_detect_fused_pallas(jnp.asarray(x.numpy().astype(np.float32)),
                                       channel_leading=True, interpret=True,
                                       **detector_kw(det))
    table = {f: np.asarray(getattr(tab, f)) for f in G.FIELDS}
    bad, _, gap, cap, cfo, compared, events = held(det, x, table, np.array(P), np.array(M))
    assert events >= 15 and compared > 0
    assert bad == 0 and gap <= REF.LIMITS["peak_value_gap"]
    assert cap <= REF.LIMITS["capture_gap"] and cfo <= REF.LIMITS["cfo_gap_hz"]


def test_sound_run_is_correct():
    res = R.run_cell(small(), SEED, 0.3, False, CPU)
    assert res["line"]["correct"], res["checks"]
    assert res["line"]["failed"] == 0
    assert res["info"]["events"] > 0 and res["info"]["captures_compared"] > 0
    assert set(res["checks"]) == set(REF.LIMITS)


def test_control_is_incorrect():
    """The reference with P, R, |P|^2 and M stored in bfloat16 in the
    program's place breaks the limits."""
    cell = small()
    res = R.run_cell(cell, SEED, 0.3, False, CPU)
    verdict = REF.judge(cell.config, res["record"], control=True)
    assert not H.passed(verdict["checks"]), verdict["checks"]
    c = verdict["checks"]
    assert c["capture_gap"][0] > c["capture_gap"][1] and c["cfo_gap_hz"][0] > c["cfo_gap_hz"][1]


def _moved(fn):
    """Every valid event's peak index moved by one sample."""
    def wrapped(*a, **k):
        table, P, M = fn(*a, **k)
        return (table._replace(peak_idx=torch.where(table.valid, table.peak_idx + 1,
                                                    table.peak_idx)), P, M)
    return wrapped


def _half(fn):
    """The second half of the batch left out: its rows come back empty."""
    def wrapped(*a, **k):
        table, P, M = fn(*a, **k)
        half = table.valid.shape[0] // 2
        zero = lambda t: torch.cat([t[:half], torch.zeros_like(t[half:])])  # noqa: E731
        return table._replace(valid=zero(table.valid), count=zero(table.count)), P, M
    return wrapped


def _rotated(fn):
    """The captured P turned by 0.01 rad: each CFO off by ~48 Hz."""
    def wrapped(*a, **k):
        table, P, M = fn(*a, **k)
        c, s = np.cos(0.01), np.sin(0.01)
        return table, torch.stack([c * P[:, 0] - s * P[:, 1], s * P[:, 0] + c * P[:, 1]], 1), M
    return wrapped


@pytest.mark.parametrize("fault,check", [(_moved, "unexcused_events"),
                                         (_half, "unexcused_events"),
                                         (_rotated, "cfo_gap_hz")])
def test_planted_fault_is_incorrect(monkeypatch, fault, check):
    monkeypatch.setattr(AA, "aa_detect_fused", fault(AA.aa_detect_fused))
    res = R.run_cell(small(), SEED, 0.3, False, CPU)
    assert not res["line"]["correct"] and res["line"]["failed"] > 0
    value, limit = res["checks"][check]
    assert value > limit, res["checks"]


@pytest.mark.parametrize("batch,L,gated", [(3, 1000, 0), (2, 4096, 777)])
def test_work_count_by_hand(batch, L, gated):
    C, E = 4, 8
    nbytes, flops = W.aa_detect_work(batch, L, C, 2, gated, E=E)
    # int16 codes in; per stream 8 slots of 18 B and count + overflow (8 B);
    # P_re, P_im, M captured at each slot, float32
    assert nbytes == batch * L * C * 2 + batch * (E * 18 + 8) + batch * 3 * E * 4
    # (6 * 4 + 13) a sample of C, 2 a sample and 10 a gated sample of B
    assert flops == batch * L * 37 + 2 * batch * L + 10 * gated
    assert bound_s(nbytes, flops) == max(nbytes / 3.35e12, flops / 67e12)


def test_preamble_is_two_equal_halves_of_unit_power():
    cfg = json.loads((ROOT / "benchmark/configs/aa_10m.json").read_text())
    t = aa_zc.template(cfg)
    half = cfg["detector"]["half_len"]
    assert t.shape == (cfg["preamble"]["length"],) == (2 * half,)
    np.testing.assert_allclose(t[:half], t[half:], atol=1e-12)
    assert np.mean(np.abs(t) ** 2) == pytest.approx(1.0, abs=1e-12)
    # ZC on every 2nd bin of the active band: the spectrum of one half holds
    # (num_active / 2) bins of equal magnitude
    spec = np.abs(np.fft.fft(t[:half]))
    used = spec > 1e-6 * spec.max()
    assert used.sum() == cfg["system"]["num_active"] // 2
    np.testing.assert_allclose(spec[used], spec[used].mean(), rtol=1e-9)


def test_reference_and_config_load_no_jax_and_nothing_of_the_program():
    files = [ROOT / "benchmark/reference/aa_10m.py", ROOT / "benchmark/preambles/aa_zc.py",
             ROOT / "benchmark/work/aa_counts.py"]
    for path in files:
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops.add(node.module.split(".")[0])
        assert not tops & {"jax", "jaxlib", "ofdm_sync_tpu", "ofdm_sync_tpu_torch"}, path
    code = (
        "import json, sys, torch\n"
        "from benchmark.reference import aa_10m\n"
        "from benchmark import stimulus\n"
        "cfg = json.load(open('benchmark/configs/aa_10m.json'))\n"
        "x = stimulus.streams(cfg, {'noise_std_codes': 32.0, 'preambles_per_stream': 2,\n"
        "                           'snr_db': [0.0, 20.0], 'cfo_hz': 1000.0},\n"
        "                     stimulus.seeded(5, 'cpu'), 2, 1 << 13, 'cpu')\n"
        "aa_10m.detect_block(x, cfg['detector'], 'float32')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ofdm_sync_tpu', 'ofdm_sync_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.gpu
def test_small_aa_cell_on_card():
    """A short traced window of the [A][A] sweep at a small size on the card:
    kernels C and B build, the line is correct and the share is read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = R.run_cell(small(), SEED, 0.5, True, torch.device("cuda", 0))
    assert res["line"]["correct"], res["checks"]
    assert 0 < res["line"]["metrics"]["aa_detect.roofline"]["value"] <= 100
