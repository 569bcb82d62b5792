"""An FFT matched filter's roundoff at the last outputs of a stream, on the
port's plain complex64 path and JAX's XLA route alike.

The last of the L + R - 1 correlation outputs has one IQ sample in its
normalizing window.  Where that sample is zero on a branch, the branch's
energy is clamped to 1e-12 and the float32 FFT's roundoff in the mf output
(the exact value is 0) is multiplied by ~2e4: the magnitude crosses the
CFAR threshold and a noise-only stream gets an event at its last output.
A complex128 convolution leaves no such event.  Seeded noise streams
(NumPy) are searched on the port's CPU path (`matched_filter_ols`, whose
CPU version is the complex64 FFT convolution, then `zc_iq_planar` and
`extract_gate_events`); JAX's from-IQ route (`ops.channel.fft_convolve_full`
in complex64, then `conformance.onchip._zc_xla_table`) gives the same
events on the same streams.  So the tail events of `chip_smoke.py` phase 12
(`ZC_TAIL`) are the reference's behaviour too, not a fault of the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ofdm_sync_tpu.conformance.onchip import _zc_xla_table  # noqa: E402
from ofdm_sync_tpu.ops.channel import fft_convolve_full  # noqa: E402
from ofdm_sync_tpu_torch import bench  # noqa: E402
from ofdm_sync_tpu_torch.kernels import matched_filter as MF  # noqa: E402
from ofdm_sync_tpu_torch.kernels.streaming import zc_iq_planar  # noqa: E402
from ofdm_sync_tpu_torch.ops.detect import extract_gate_events  # noqa: E402
from ofdm_sync_tpu_torch.testing import mf_reference  # noqa: E402

#: the search: 256 noise-only streams of 4096 samples x 2 branches, seed 0
BATCH, L, SEED = 256, 4096, 0
TAIL = 16


def _events(table) -> dict:
    a = {f: np.asarray(getattr(table, f)) for f in ("count", "peak_idx", "valid")}
    return {b: a["peak_idx"][b][a["valid"][b]].tolist() for b in range(a["count"].shape[0])
            if a["count"][b]}


def test_tail_events_are_jaxs_too():
    ref, taps, ref_norm = bench.zc_template()
    R = len(ref)
    Lc = L + R - 1
    iq = np.round(8.0 * np.random.default_rng(SEED).standard_normal((4, BATCH, L)))
    iq = iq.astype(np.float32)
    x = torch.from_numpy(iq)
    kw = dict(ref_len=R, ref_norm=ref_norm, **bench.ZC_CFAR)
    mag, above = zc_iq_planar(MF.matched_filter_ols(x, taps), x, **kw)
    port = _events(extract_gate_events(above, mag, **bench.ZC_EVENTS))
    # every event is a tail event of a stream whose last sample is zero on
    # a branch, and the search found at least one
    zero_last = np.flatnonzero(((iq[0::2, :, -1] == 0) & (iq[1::2, :, -1] == 0)).any(axis=0))
    assert port and sorted(port) == zero_last.tolist()
    assert all(Lc - TAIL <= p < Lc for peaks in port.values() for p in peaks)
    # complex128: none
    mag, above = zc_iq_planar(mf_reference(x, taps).float(), x, **kw)
    assert not _events(extract_gate_events(above, mag, **bench.ZC_EVENTS))
    # JAX's XLA route on the same streams: the same events
    xc = jnp.asarray(iq[0::2] + 1j * iq[1::2], jnp.complex64)
    y = fft_convolve_full(xc, jnp.asarray(np.conj(ref[::-1]), jnp.complex64))
    mf = jnp.stack([jnp.real(y), jnp.imag(y)], axis=1).reshape(4, BATCH, Lc)
    jt = _zc_xla_table(mf.astype(jnp.float32), jnp.asarray(iq), ref_len=R, ref_norm=ref_norm,
                       kw=dict(bench.ZC_CFAR, hysteresis=bench.ZC_EVENTS["hysteresis"],
                               max_events=bench.ZC_EVENTS["max_events"]))
    assert _events(jt) == port
