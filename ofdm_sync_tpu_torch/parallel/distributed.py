"""Joining the process group, and launching ranks on one host (port of
`ofdm_sync_tpu.parallel.distributed`).

The port is SPMD in the PyTorch way: one process per rank, every rank
calling the same sharded function of `parallel.shard` on its own block.
Put the ``seq`` axis (halo exchanges and the event-table all-gather, both
latency-bound) on the fastest links, the cards of one host, and ``data``
(independent streams, no communication) across hosts:
`make_global_stream_mesh` does that by keeping ``seq`` minor.

Launch with ``torchrun --nproc-per-node N script.py``, where the script
calls::

    from ofdm_sync_tpu_torch.parallel import distributed, shard
    distributed.initialize()                  # rank, world, address from torchrun
    mesh = distributed.make_global_stream_mesh()
    table = shard.sharded_minn_rtl_detect_fused(x_local, mesh, ...)

Backends: NCCL where every rank of a host has a card of its own (the
default), gloo where ranks share a card or run on the CPU (pass
``backend="gloo"``; NCCL refuses two ranks on one device).  `run_ranks`
starts ranks on one host without torchrun, as the tests and
``chip_smoke.py`` do.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ofdm_sync_tpu_torch.parallel.shard import StreamMesh, make_stream_mesh


def _env_int(name: str, value: int | None) -> int:
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"pass {name.lower()} or set {name} (torchrun sets it)")
    return int(os.environ[name])


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    backend: str | None = None,
) -> str:
    """Join the process group (idempotent); returns its backend.

    Rank and world size come from the arguments or from torchrun's
    environment (``RANK``, ``WORLD_SIZE``; ``init_method`` None reads
    ``MASTER_ADDR`` / ``MASTER_PORT``).  ``backend`` None is NCCL, which
    needs a card for every rank of this host (``LOCAL_WORLD_SIZE``, default
    the world size) and selects card ``LOCAL_RANK``; with fewer cards it
    raises: pass ``backend="gloo"`` for ranks that share a card or run on
    the CPU."""
    if dist.is_initialized():
        return dist.get_backend()
    world_size = _env_int("WORLD_SIZE", world_size)
    rank = _env_int("RANK", rank)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if backend is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_world > cards:
            raise RuntimeError(
                f"{local_world} ranks on this host and {cards} CUDA device(s): NCCL needs a card "
                "for every rank; pass backend='gloo' for ranks that share a card or the CPU")
        backend = "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return backend


def make_global_stream_mesh(n_data: int | None = None, n_seq: int | None = None) -> StreamMesh:
    """(data, seq) mesh over every rank.  Defaults: ``seq`` spans the ranks
    of one host (``LOCAL_WORLD_SIZE``, else all ranks) and ``data`` the
    hosts; with one size given the other fills the world.  Every rank must
    call it, in the same order as its other group creations."""
    world = dist.get_world_size()
    if n_data is None and n_seq is None:
        n_seq = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_seq is None:
        n_seq = world // n_data
    return make_stream_mesh(n_data=world // n_seq if n_data is None else n_data, n_seq=n_seq)


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world_size: int, port: int, backend: str, args, results) -> None:
    try:
        initialize(f"tcp://localhost:{port}", world_size, rank, backend=backend)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, args: tuple = (), *, backend: str = "gloo",
              timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes on this host
    (start method ``spawn``: nothing of the parent's state is shared), each
    first joined to a process group on ``tcp://localhost:<free port>``;
    returns the ranks' return values in rank order.  ``fn`` and its
    arguments must pickle, and the child imports ``fn``'s module.  A rank
    that raises, dies or outlasts ``timeout_s`` fails the call with every
    rank's error; every process is stopped before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, port, backend, args, results),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    done, errors = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(done) + len(errors) < world_size and not errors:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                lost = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in done and r not in errors]
                if lost and results.empty():
                    time.sleep(1.0)  # a report may still be in the pipe
                    if results.empty():
                        errors.update({r: f"exit code {procs[r].exitcode}" for r in lost})
                if time.monotonic() > deadline:
                    errors.update({r: f"no result after {timeout_s} s" for r in range(world_size)
                                   if r not in done})
                continue
            (done if ok else errors)[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"rank {r}: {e}" for r, e in sorted(errors.items())))
    return [done[r] for r in range(world_size)]
