"""Comparison helpers and stimulus shared by the tests and `chip_smoke.py`."""

from __future__ import annotations

import numpy as np
import torch

TABLE_FIELDS = ("valid", "closed", "gate_start", "gate_close", "peak_idx",
                "peak_value", "count", "overflow")
EXACT_FIELDS = TABLE_FIELDS[:5] + TABLE_FIELDS[6:]


def table_arrays(table) -> dict[str, np.ndarray]:
    """Host arrays of any event table: the port's `GateEvents` (tensors on
    any device) or the JAX package's (jax arrays)."""
    out = {}
    for f in TABLE_FIELDS:
        a = getattr(table, f)
        out[f] = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    return out


def assert_tables_equal(ref, out, what: str = "", peak_rtol: float = 0.0) -> None:
    """Every field equal; ``peak_value`` within ``peak_rtol * max(1,
    |ref|max)`` (0: exact)."""
    r, o = table_arrays(ref), table_arrays(out)
    for f in EXACT_FIELDS:
        if r[f].shape != o[f].shape or not np.array_equal(r[f], o[f]):
            bad = (np.argwhere(r[f] != o[f])[:5].tolist()
                   if r[f].shape == o[f].shape else f"shape {r[f].shape} vs {o[f].shape}")
            raise AssertionError(f"{what}: table field {f} differs at {bad}")
    rv, ov = r["peak_value"], o["peak_value"]
    finite = np.isfinite(rv)
    tol = peak_rtol * max(1.0, float(np.abs(rv[finite]).max()) if finite.any() else 1.0)
    if rv.shape != ov.shape:
        raise AssertionError(f"{what}: peak_value shape {rv.shape} vs {ov.shape}")
    with np.errstate(invalid="ignore"):  # equal infinities (empty slots) differ by 0
        diff = np.where(rv == ov, 0.0, np.abs(rv - ov))
    if rv.size and not float(diff.max()) <= tol:
        raise AssertionError(f"{what}: peak_value differs beyond {tol}")


def rel_err(out, ref) -> float:
    """max |out - ref| / max(1, |ref|max) (0 for an empty ref)."""
    if not ref.numel():
        return 0.0
    return float((out.double() - ref.double()).abs().max()) / max(1.0, float(ref.abs().max()))


def mf_reference(x, taps) -> torch.Tensor:
    """The complex128 FFT convolution of the plane pairs of x (2*BR,
    batch, L) with the planar taps (2, T): planar (2*BR, batch, L + T - 1),
    the matched filter's reference."""
    from ofdm_sync_tpu_torch.ops.channel import fft_convolve_full

    xc = torch.complex(x[0::2].double(), x[1::2].double())
    t = torch.as_tensor(taps, device=x.device).double()
    y = fft_convolve_full(xc, torch.complex(t[0], t[1]))
    return torch.stack([y.real, y.imag], dim=1).reshape((x.shape[0],) + y.shape[1:])

def aa_stimulus(batch: int, n: int, half_len: int, device, *, seed: int = 0,
                events=(), branches: int = 2) -> torch.Tensor:
    """Channel-leading (2*branches, batch, n) float32 integer-valued noise
    round(8 N(0,1)) from a seeded `torch.Generator` on ``device``, with the
    [A][A] preamble of length 2*half_len (`build_aa_preamble`, scaled to
    integers round(72 x)) added on every branch at each ``(stream,
    position)`` of ``events``.  Integer values keep every product and
    window sum of kernel C and its plain version exact."""
    from ofdm_sync_tpu_torch.ops.waveforms import build_aa_preamble

    pre = build_aa_preamble(2 * half_len)[0]
    planes = [torch.as_tensor(np.round(72.0 * pre.real), dtype=torch.float32, device=device),
              torch.as_tensor(np.round(72.0 * pre.imag), dtype=torch.float32, device=device)]
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((2 * branches, batch, n), generator=g, device=device).mul_(8.0).round_()
    for b, pos in events:
        for c in range(2 * branches):
            x[c, b, pos: pos + 2 * half_len] += planes[c % 2][: n - pos]
    return x



def minn_stimulus(batch: int, L: int, Q: int, device, seed: int = 0, events=None):
    """(4, batch, L) integer-valued float32 noise round(8*N(0,1)) from a
    seeded generator on `device`, with 5Q preambles [-A,+A,+A,-A,-A]
    (scaled to small integers, built in NumPy) added at known positions
    (default: four, in streams 0-3).  Integer values keep every window sum
    exact in kernel A and its plain version.  Returns (x, events)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(Q) + 1j * rng.standard_normal(Q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    planes = [3.0 * np.round(24.0 * pre.real), 3.0 * np.round(24.0 * pre.imag)]
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((4, batch, L), generator=g, device=device).mul_(8.0).round_()
    if events is None:
        events = [(0, 3 * Q), (min(1, batch - 1), L // 3),
                  (min(2, batch - 1), L // 2), (min(3, batch - 1), L - 7 * Q)]
    for b, pos in events:
        for c in range(4):
            x[c, b, pos: pos + 5 * Q] += torch.as_tensor(planes[c % 2], dtype=torch.float32,
                                                          device=device)
    return x, events


def zc_iq_stimulus(batch: int, n: int, ref, device, *, seed: int = 0, events=()):
    """(4, batch, n) float32 integer-valued noise round(8 N(0,1)) from a
    seeded generator on `device`, with the template ``ref`` (complex)
    scaled to integers round(24 x) added on both branches at each (stream,
    position)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((4, batch, n), generator=g, device=device).mul_(8.0).round_()
    planes = [torch.as_tensor(np.round(24.0 * part), dtype=torch.float32, device=device)
              for part in (ref.real, ref.imag)]
    for b, pos in events:
        k = min(len(ref), n - pos)
        for c in range(4):
            x[c, b, pos: pos + k] += planes[c % 2][:k]
    return x


def mag_stimulus(batch: int, n: int, device, *, seed: int, events=()):
    """Correlation magnitudes: 0.05 |N(0,1)| from a seeded generator on
    `device`, with a peak of 1 and its sidelobes at each (stream,
    position)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, n), generator=g, device=device).abs_().mul_(0.05)
    for b, pos in events:
        for d, v in ((-3, 0.2), (-1, 0.6), (0, 1.0), (1, 0.5), (4, 0.25)):
            if 0 <= pos + d < n:
                x[b, pos + d] += v
    return x

#: the [A][A] golden vectors' stimulus (reference
#: docs/aa_preamble_sync_design.md section 12): sample rate, pad before the
#: 1024-sample preamble, zeros after it, the int12 scale
GOLDEN_FS_HZ, GOLDEN_PRE_PAD, GOLDEN_TAIL, GOLDEN_SCALE = 15_360_000.0, 500, 700, 1024.0


def aa_int12_stimulus(cfo_hz: float = 0.0) -> np.ndarray:
    """Planar int16 codes (1 branch, 2, 2224) of the C++ [A][A] model's
    golden stimulus (after tests/test_native_aa.py:_int12_stimulus):
    [500 zeros | the 1024-sample [A][A] preamble | 700 zeros], a CFO tone
    of ``cfo_hz`` from sample 0 at 15.36 MHz, each part rounded to
    round(x * 1024)."""
    from ofdm_sync_tpu_torch.ops.waveforms import build_aa_preamble

    stim = np.concatenate([np.zeros(GOLDEN_PRE_PAD), build_aa_preamble(1024)[0],
                           np.zeros(GOLDEN_TAIL)]).astype(complex)
    if cfo_hz:
        stim = stim * np.exp(2j * np.pi * cfo_hz * np.arange(stim.size) / GOLDEN_FS_HZ)
    q = np.round(stim.real * GOLDEN_SCALE) + 1j * np.round(stim.imag * GOLDEN_SCALE)
    return np.stack([q.real, q.imag]).astype(np.int16)[None]


def rtl_stimulus(rng: np.random.Generator, quarter_len: int, *, snr_db: float = 10.0,
                 L: int = 4000, positions=(900,)) -> np.ndarray:
    """Planar int16 ADC codes (2 branches, 2, L) for the C++ integer oracle,
    after tests/test_native_rtl.py:_stimulus: the qpsk_freq 5Q Minn-RTL
    preamble (built from seed 0) at each of ``positions`` on branch 0 and
    at 0.8x on branch 1, complex AWGN from ``rng`` at ``snr_db`` below the
    preamble's power, all quantized to 12 bits (`quantize_int`, the largest
    magnitude at 2046)."""
    from ofdm_sync_tpu_torch.ops.channel import quantize_int
    from ofdm_sync_tpu_torch.ops.waveforms import build_minn_rtl_preamble

    pre = build_minn_rtl_preamble("qpsk_freq", rng=np.random.default_rng(0), Q=quarter_len)
    sig = np.zeros(L, complex)
    for pos in positions:
        sig[pos: pos + pre.size] = pre
    rx = np.stack([sig, 0.8 * sig])
    noise_pow = np.mean(np.abs(pre) ** 2) / (10 ** (snr_db / 10))
    rx = rx + np.sqrt(noise_pow / 2) * (
        rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    re, im, _ = quantize_int(rx, 12)
    return np.stack([re, im], axis=1).astype(np.int16)


def rtl_channel_leading(iq: np.ndarray, device, dtype=torch.int16) -> torch.Tensor:
    """(branches, 2, L) planar codes -> the kernels' channel-leading
    (2*branches, batch=1, L) layout, rows [b0_i, b0_q, b1_i, b1_q, ...]."""
    b, _, L = iq.shape
    return torch.as_tensor(iq.reshape(2 * b, 1, L), device=device).to(dtype).contiguous()


def native_events(det) -> list[tuple]:
    """The C++ model's events as (gate start, close, peak index, peak value,
    closed) tuples."""
    return [(int(det.gate_start[k]), int(det.gate_close[k]), int(det.peak_idx[k]),
             float(det.peak_value[k]), bool(det.closed[k])) for k in range(det.count)]


def event_tuples(table) -> list[tuple]:
    """A single-stream `GateEvents` table's valid slots as (gate start,
    close, peak index, peak value, closed) tuples."""
    a = {k: v.reshape(-1) for k, v in table_arrays(table).items() if k not in ("count", "overflow")}
    return [(int(a["gate_start"][s]), int(a["gate_close"][s]), int(a["peak_idx"][s]),
             float(a["peak_value"][s]), bool(a["closed"][s]))
            for s in np.flatnonzero(a["valid"])]
