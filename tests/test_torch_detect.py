"""Port vs JAX: closed-form gate/peak extraction (`ops.detect`).

The same boolean `above` and float32 `track` arrays, made with NumPy from a
seed, go through `ofdm_sync_tpu.ops.detect.extract_gate_events` and the
port's `extract_gate_events` (the plain version of the CUDA gate/event
kernel).  Tables must be equal field by field, `peak_value` included: both
pick the same element of the same array.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.ops import detect as jdet  # noqa: E402
from ofdm_sync_tpu_torch.kernels.minn_rtl_fused import gate_events  # noqa: E402
from ofdm_sync_tpu_torch.ops import detect as tdet  # noqa: E402
from ofdm_sync_tpu_torch.testing import assert_tables_equal  # noqa: E402


def _random_gates(seed, n, density, levels=None):
    rng = np.random.default_rng(seed)
    above = rng.random(n) < density
    if levels:  # quantized track: many exact ties for the tie rules
        track = rng.integers(0, levels, n).astype(np.float32)
    else:
        track = rng.standard_normal(n).astype(np.float32)
    return above, track


@pytest.mark.parametrize(
    "seed,n,density,h,E,tie,emit,valid_from,levels",
    [
        (0, 3000, 0.02, 2, 8, "last", False, 0, None),
        (1, 3000, 0.02, 2, 8, "first", True, 0, None),
        (2, 5000, 0.05, 0, 4, "last", True, 37, 20),      # h = 0 and overflow
        (3, 5000, 0.3, 3, 8, "first", False, 100, 10),    # dense -> overflow
        (4, 2000, 0.01, 7, 128, "last", True, 5, 5),      # full capacity
        (5, 1000, 0.0, 2, 8, "last", True, 0, None),      # nothing above
        (6, 1, 1.0, 2, 3, "first", True, 0, None),        # one sample
    ],
)
def test_extract_gate_events_matches_jax(seed, n, density, h, E, tie, emit,
                                         valid_from, levels):
    above, track = _random_gates(seed, n, density, levels)
    kw = dict(hysteresis=h, max_events=E, valid_from=valid_from, tie=tie,
              emit_unclosed=emit)
    ref = jdet.extract_gate_events(jnp.asarray(above), jnp.asarray(track), **kw)
    out = tdet.extract_gate_events(torch.from_numpy(above), torch.from_numpy(track), **kw)
    assert_tables_equal(ref, out, "extract_gate_events")


def test_extract_gate_events_overflow_flag():
    above, track = _random_gates(7, 4000, 0.3, None)
    out = tdet.extract_gate_events(torch.from_numpy(above), torch.from_numpy(track),
                                   hysteresis=1, max_events=4)
    assert bool(out.overflow) and int(out.count) == 4


def test_extract_gate_events_empty_stream():
    kw = dict(hysteresis=2, max_events=5)
    ref = jdet.extract_gate_events(jnp.zeros((0,), bool), jnp.zeros((0,), jnp.float32), **kw)
    out = tdet.extract_gate_events(torch.zeros(0, dtype=torch.bool), torch.zeros(0), **kw)
    assert_tables_equal(ref, out, "empty")


def test_extract_gate_events_batched_rows_match_single():
    """Leading batch axes: each row's table equals the 1-D call."""
    rows = [_random_gates(10 + i, 2500, 0.03, 8) for i in range(3)]
    above = torch.from_numpy(np.stack([a for a, _ in rows]))
    track = torch.from_numpy(np.stack([t for _, t in rows]))
    kw = dict(hysteresis=2, max_events=6, tie="last", emit_unclosed=False)
    batched = tdet.extract_gate_events(above, track, **kw)
    for i in range(3):
        ref = jdet.extract_gate_events(jnp.asarray(rows[i][0]), jnp.asarray(rows[i][1]), **kw)
        assert_tables_equal(ref, batched.select(i), f"row {i}")


def test_gate_events_wrapper_cpu_is_plain_and_uncounted():
    """On CPU tensors the kernel-B wrapper runs the plain version and
    counts no launch."""
    above, track = _random_gates(11, 3000, 0.02, None)
    a, t = torch.from_numpy(above)[None], torch.from_numpy(track)[None]
    before = gate_events.launches
    out = gate_events(a, t, hysteresis=2, max_events=8, tie="last", emit_unclosed=False)
    ref = tdet.extract_gate_events(a, t, hysteresis=2, max_events=8, tie="last",
                                   emit_unclosed=False)
    assert_tables_equal(ref, out, "wrapper")
    assert gate_events.launches == before


@pytest.mark.parametrize("h,valid_from", [(2, 0), (0, 50), (9, 3)])
def test_gate_open_mask_matches_jax(h, valid_from):
    above, _ = _random_gates(12, 3000, 0.02, None)
    ref = np.asarray(jdet.gate_open_mask(jnp.asarray(above), h, valid_from))
    out = tdet.gate_open_mask(torch.from_numpy(above), h, valid_from).numpy()
    np.testing.assert_array_equal(out, ref)


def test_gate_events_table_roundtrip_numpy():
    above, track = _random_gates(13, 2000, 0.02, None)
    ref = jdet.extract_gate_events(jnp.asarray(above), jnp.asarray(track), hysteresis=2)
    t = tdet.GateEvents.from_numpy(ref)
    assert t.gate_start.dtype == torch.int32 and t.valid.dtype == torch.bool
    for f, a in t.to_numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("name,args", [("largest_true_run", ()), ("earliest_long_run_end", (3,))])
def test_run_helpers_on_an_empty_stream(name, args):
    """Pinned difference: on a stream of no samples JAX's run helpers raise
    (an argmax of nothing), the port's return an empty mask and -1."""
    with pytest.raises(ValueError, match="argmax of an empty sequence"):
        getattr(jdet, name)(jnp.zeros(0, bool), *args)
    out = getattr(tdet, name)(torch.zeros(0, dtype=torch.bool), *args)
    if name == "largest_true_run":
        assert out.dtype == torch.bool and out.shape == (0,)
    else:
        assert out.ndim == 0 and int(out) == -1
