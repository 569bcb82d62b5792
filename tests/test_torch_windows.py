"""The port's two-level cumulative sum (`ops.windows.cumsum`, the core of
every windowed sum) against `torch.cumsum` in float64: exact on integer
input (partial sums below 2^53), within 1e-12 of the row's largest partial
sum on float input, for rows at, just past and well past `SCAN_BLOCK`,
with leading axes, complex, float32 and bool input."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu_torch.ops.windows import SCAN_BLOCK, cumsum, sliding_sum_valid  # noqa: E402


@pytest.mark.parametrize("n", [1, SCAN_BLOCK, SCAN_BLOCK + 1, 3 * SCAN_BLOCK + 5, 20 * SCAN_BLOCK])
def test_cumsum_matches_torch(n):
    g = torch.Generator().manual_seed(n)
    ints = torch.randint(-2048, 2048, (2, 3, n), generator=g, dtype=torch.int64)
    assert torch.equal(cumsum(ints), torch.cumsum(ints, dim=-1))
    assert torch.equal(cumsum(ints.to(torch.float32)), torch.cumsum(ints.double(), dim=-1))
    x = torch.randn((2, n), generator=g, dtype=torch.float64)
    z = torch.complex(x, torch.randn((2, n), generator=g, dtype=torch.float64))
    for v in (x, z, x.float()):
        want = torch.cumsum(v.to(torch.complex128 if v.is_complex() else torch.float64), dim=-1)
        got = cumsum(v)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))
    mask = torch.rand((n,), generator=g) < 0.3
    assert torch.equal(cumsum(mask), torch.cumsum(mask, dim=0))


def test_window_sums_exact_across_blocks():
    x = np.random.default_rng(0).integers(-100, 100, (2, 5 * SCAN_BLOCK + 7)).astype(np.float32)
    want = np.stack([np.convolve(r.astype(np.int64), np.ones(512, np.int64), "valid") for r in x])
    np.testing.assert_array_equal(sliding_sum_valid(torch.from_numpy(x), 512).numpy(), want)
