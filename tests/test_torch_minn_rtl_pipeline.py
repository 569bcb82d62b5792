"""Port's Minn-RTL parity pipeline (`pipelines/minn_rtl.py`) vs the JAX
package and the reference: `run_simulation`, `run_sequence_comparison`,
`compare_q_values` and the CLI ``minn_rtl``.

The simulations reproduce tests/test_pipeline_parity.py:60-76 (events and
per-event errors exact, CFO within 0.05 Hz) and print the JAX pipeline's
report line for line.  The sweeps' integer outputs (peaks, timing errors,
the order of the sequences) equal the JAX package's, their floats agree
within 1e-4 relative (the metric's window sums round in another order).
"""

import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu.pipelines import minn_rtl as jminn_rtl  # noqa: E402
from ofdm_sync_tpu_torch.__main__ import main as t_main  # noqa: E402
from ofdm_sync_tpu_torch.pipelines import minn_rtl  # noqa: E402
from test_torch_sc import check_reference, no_jax_cache_writes  # noqa: E402,F401

REFERENCE = {  # tests/test_pipeline_parity.py:60-76
    "cir1": dict(events=[(4593, 4593), (19951, 19951)], per_event_errors=[84, 82],
                 cfo_est_hz=1069.26),
    None: dict(events=[(4408, 4408), (19768, 19768)], per_event_errors=[-1, -1],
               cfo_est_hz=967.90),
}


@pytest.mark.parametrize("channel", list(REFERENCE))
def test_simulation_reproduces_reference(channel):
    check_reference(minn_rtl.run_simulation(channel, device="cpu"), REFERENCE[channel])


def test_report_matches_jax(capsys):
    minn_rtl_j = jminn_rtl.run_simulation("cir1", None)
    jout = capsys.readouterr().out
    r = minn_rtl.run_simulation("cir1", device="cpu")
    assert capsys.readouterr().out.splitlines() == jout.splitlines()
    assert r["events"] == minn_rtl_j["events"]


def _close_rel(a, b, what):
    assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), what


def test_sequence_comparison_matches_jax(capsys):
    seqs = ("gold", "zc_time", "bpsk_freq")
    want = jminn_rtl.run_sequence_comparison(None, seqs)
    jout = capsys.readouterr().out
    got = minn_rtl.run_sequence_comparison(None, seqs, device="cpu")
    assert capsys.readouterr().out.splitlines() == jout.splitlines()
    assert [(r["seq_type"], r["peak_idx"], r["timing_error"]) for r in got] == [
        (r["seq_type"], r["peak_idx"], r["timing_error"]) for r in want]
    for g, w in zip(got, want):
        for key in ("peak_val", "noise_floor", "noise_max", "par", "pmr"):
            _close_rel(g[key], w[key], key)


def test_q_comparison_matches_jax():
    want = jminn_rtl.compare_q_values([128])
    got = minn_rtl.compare_q_values([128], device="cpu")
    assert list(got) == list(want)
    for Q in want:
        assert (got[Q]["timing_error"], got[Q]["preamble_len"]) == (
            want[Q]["timing_error"], want[Q]["preamble_len"])
        for key in ("peak", "par", "pmr", "overhead_pct"):
            _close_rel(got[Q][key], want[Q][key], key)


def test_cli(capsys):
    assert t_main(["minn_rtl", "--device", "cpu", "--no-plots"]) == 0
    out = capsys.readouterr().out
    assert "Event 0: peak=4593 detected=4593 expected=4509 error=84 samples" in out
    assert "Event 1: peak=19768 detected=19768 expected=19769 error=-1 samples" in out
    assert "SEQUENCE COMPARISON - FLAT AWGN" in out and "Q VALUE COMPARISON" in out
    assert "ALL MINN RTL SIMULATIONS COMPLETE" in out
