"""The port's multi-card dry run (`parallel.dryrun.dryrun_multichip`, the
counterpart of `__graft_entry__.dryrun_multichip`) over gloo on the CPU:
four ranks on the JAX factoring's mesh (2, 2) run one step of every
sharded entry point (the fused Minn-RTL detect both as one primed call and
split around its halo) and the receive chain, and print the one OK line."""

import pytest

torch = pytest.importorskip("torch")

from ofdm_sync_tpu_torch.parallel.dryrun import dryrun_multichip, mesh_shape  # noqa: E402


@pytest.mark.parametrize("n,want", [(1, (1, 1)), (2, (1, 2)), (3, (1, 3)), (4, (2, 2)),
                                    (6, (2, 3)), (8, (2, 4))])
def test_mesh_shape_factors_as_jax(n, want):
    assert mesh_shape(n) == want


def test_dryrun_multichip_four_ranks(capsys):
    line = dryrun_multichip(4, device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[-1] == line
    assert line.startswith("dryrun_multichip OK: mesh=(data=2, seq=2) on cpu over gloo")
    assert "RECEIVE CHAIN OK: 2 frames recovered" in line
    assert "split=[" in line
