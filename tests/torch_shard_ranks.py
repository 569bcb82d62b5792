"""Rank functions of the sharded-path tests (`tests/test_torch_shard_*.py`).

Each runs in a process of its own, started by
`ofdm_sync_tpu_torch.parallel.distributed.run_ranks` on gloo over the CPU,
so this module imports torch and the port only, never JAX or the JAX
package: each rank reports the modules it has loaded.  A rank cuts its
(data, seq) block out of the whole stimulus it is given, runs every
configuration and returns host arrays.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ofdm_sync_tpu_torch.parallel import distributed, shard
from ofdm_sync_tpu_torch.testing import table_arrays


def _block(a: np.ndarray, mesh) -> torch.Tensor:
    """The rank's (C, B_loc, block) share of a (C, batch, n) array."""
    bb, bl = a.shape[1] // mesh.n_data, a.shape[2] // mesh.n_seq
    return torch.from_numpy(np.ascontiguousarray(
        a[:, mesh.data * bb: (mesh.data + 1) * bb, mesh.seq * bl: (mesh.seq + 1) * bl]))


def _frames(out) -> tuple:
    return tuple(t.numpy() for t in out)


def _foreign_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ofdm_sync_tpu"))


def minn_rank(rank: int, x: np.ndarray, dsd: np.ndarray, kw: dict, rows: int,
              frame_cfgs: list) -> dict:
    """Every Minn-RTL configuration on meshes (1, 4) and (2, 2): the
    sharded detect with the overlap split on and off, on float32 and int16
    (``x`` rounded as tests/test_sharded_tm.py rounds it), closed gates only
    and unclosed ones too; the receive chain and the frame re-emission; and
    the detect of test_sharded_detect.py's stimulus ``dsd``; the halo
    exchange; the default global mesh."""
    torch.set_num_threads(1)
    x16 = np.round(np.clip(x, -1, 1) * 2047).astype(np.int16)
    g = distributed.make_global_stream_mesh()
    out = {"global_mesh": (g.n_data, g.n_seq, g.data, g.seq)}
    for nd, ns in ((1, 4), (2, 2)):
        mesh = shard.make_stream_mesh(nd, ns)
        for dtype, a in (("f32", x), ("i16", x16)):
            blk = _block(a, mesh)
            out["halo", nd, ns, dtype] = (mesh.data, mesh.seq,
                                          shard.halo_exchange(blk, 37, 5, mesh).numpy())
            for overlap in (False, True):
                for emit in (False, True):
                    t = shard.sharded_minn_rtl_detect_fused(blk, mesh, **kw, overlap_halo=overlap,
                                                            rows=rows, emit_unclosed=emit)
                    out["detect", nd, ns, dtype, overlap, emit] = (mesh.data, table_arrays(t))
        blk = _block(x, mesh)
        for i, (frame_len, offset, max_frames) in enumerate(frame_cfgs):
            t, *fr = shard.sharded_minn_rtl_receive(
                blk, mesh, **kw, frame_len=frame_len, timing_offset=offset,
                max_frames=max_frames, overlap_halo=True, rows=rows)
            out["receive", nd, ns, i] = (mesh.data, table_arrays(t), _frames(fr))
        t = shard.sharded_minn_rtl_detect_fused(_block(dsd, mesh), mesh, **kw)
        out["dsd", nd, ns] = (mesh.data, table_arrays(t))
    out["modules"] = _foreign_modules()
    return out


def zc_aa_rank(rank: int, mf: np.ndarray, iq: np.ndarray, zc_kw: dict, aa: np.ndarray,
               aa_kw: dict) -> dict:
    """The sharded from-IQ ZC detect (float32 and int16 IQ) and the sharded
    [A][A] detect with capture, on meshes (1, 4) and (2, 2)."""
    torch.set_num_threads(1)
    out = {}
    for nd, ns in ((1, 4), (2, 2)):
        mesh = shard.make_stream_mesh(nd, ns)
        mf_b = _block(mf, mesh)
        for dtype in ("f32", "i16"):
            iq_b = _block(iq, mesh)
            if dtype == "i16":
                iq_b = iq_b.to(torch.int16)
            t = shard.sharded_zc_iq_detect(mf_b, iq_b, mesh, **zc_kw)
            out["zc", nd, ns, dtype] = (mesh.data, table_arrays(t))
        t, P, M = shard.sharded_aa_detect_fused(_block(aa, mesh), mesh, **aa_kw)
        out["aa", nd, ns] = (mesh.data, table_arrays(t), P.numpy(), M.numpy())
    out["modules"] = _foreign_modules()
    return out


def cuda_minn_rank(rank: int, x: np.ndarray, kw: dict, rows: int) -> dict:
    """The sharded Minn-RTL detect on mesh (1, 2) with the rank's block on
    the card (ranks share card 0 over gloo), the overlap split off and on;
    returns the tables and kernel A's and B's launches by mode."""
    from ofdm_sync_tpu_torch.kernels.launches import mode_launch_counts, reset_launch_counts

    mesh = shard.make_stream_mesh(1, 2)
    blk = _block(x, mesh).to(torch.device("cuda", 0))
    reset_launch_counts()
    out = {overlap: table_arrays(shard.sharded_minn_rtl_detect_fused(
        blk, mesh, **kw, overlap_halo=overlap, rows=rows)) for overlap in (False, True)}
    torch.cuda.synchronize()
    out["modes"] = mode_launch_counts()
    return out


def _rows(a: np.ndarray, mesh) -> torch.Tensor:
    """The rank's (B_loc, block) share of a (batch, n) array."""
    return _block(a[None], mesh)[0]


def _arrays(out) -> tuple:
    return tuple(t.numpy() for t in out)


def metrics_rank(rank: int, a: np.ndarray, b: np.ndarray, x: np.ndarray, rx: np.ndarray,
                 kw: dict, lag: int, n_fft: int) -> dict:
    """The sharded metrics on meshes (1, 4) and (2, 2): the blocked linear
    recurrence on (a, b) (batch, n); the Minn-RTL metric (channel-leading
    ``x`` and the one-stream complex ``rx`` (branches, n)), the [A][A] and
    the Schmidl-Cox metrics; `shard_batch` along both batch axes a test
    uses.  Each entry is (data, seq, arrays)."""
    torch.set_num_threads(1)
    out = {}
    for nd, ns in ((1, 4), (2, 2)):
        mesh = shard.make_stream_mesh(nd, ns)
        at = (mesh.data, mesh.seq)
        blk = _block(x, mesh)
        out["blr", nd, ns] = at + (shard.blocked_linear_recurrence(
            _rows(a, mesh), _rows(b, mesh), mesh).numpy(),)
        out["planar", nd, ns] = at + (_arrays(shard.sharded_minn_rtl_planar(blk, mesh, **kw)),)
        bl = rx.shape[-1] // ns
        one = torch.from_numpy(np.ascontiguousarray(rx[:, mesh.seq * bl: (mesh.seq + 1) * bl]))
        out["metric", nd, ns] = at + (_arrays(shard.sharded_minn_rtl_metric(one, mesh, **kw)),)
        out["aa", nd, ns] = at + (_arrays(shard.sharded_aa_metric(blk, mesh, lag)),)
        out["sc", nd, ns] = at + (_arrays(shard.sharded_sc_metric(blk, mesh, n_fft)),)
        out["batch", nd, ns] = at + (shard.shard_batch(torch.from_numpy(x), mesh, axis=1).numpy(),
                                     shard.shard_batch(torch.from_numpy(a), mesh).numpy())
    out["modules"] = _foreign_modules()
    return out


def _mutant(name: str, edits) -> object:
    """`shard.cross_shard_event_merge` with each (old, new) text edit made
    to its source (every occurrence; each must occur), compiled in the
    module's namespace."""
    import inspect

    src = inspect.getsource(shard.cross_shard_event_merge)
    for old, new in edits:
        if old not in src:
            raise ValueError(f"mutant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    ns = dict(vars(shard))
    exec(compile(src, f"<mutant {name}>", "exec"), ns)
    return ns["cross_shard_event_merge"]


def _merge_case(fn, case: dict, mesh) -> tuple:
    bl = case["above"].shape[-1] // mesh.n_seq
    table, extras = fn(_rows(case["above"], mesh), _rows(case["track"], mesh), mesh.seq * bl,
                       mesh, extras=tuple(_rows(e, mesh) for e in case["extras"]),
                       **case["kw"])
    return table_arrays(table), [e.numpy() for e in extras]


def xla_detect_rank(rank: int, streams: list, kw: dict, cases: list, mutants: dict) -> dict:
    """On meshes (1, 4) and (2, 2): `sharded_minn_rtl_detect` on each
    channel-leading stimulus of ``streams`` with ``emit_unclosed`` both
    ways, and `cross_shard_event_merge` on each random case (above, track,
    extras (batch, n), keywords); on mesh (1, 4) every case again through
    each mutant of the merge."""
    torch.set_num_threads(1)
    out = {}
    for nd, ns in ((1, 4), (2, 2)):
        mesh = shard.make_stream_mesh(nd, ns)
        for i, x in enumerate(streams):
            for emit in (False, True):
                t = shard.sharded_minn_rtl_detect(_block(x, mesh), mesh, **kw, emit_unclosed=emit)
                out["detect", nd, ns, i, emit] = (mesh.data, table_arrays(t))
        for i, case in enumerate(cases):
            out["merge", nd, ns, i] = (mesh.data,) + _merge_case(shard.cross_shard_event_merge,
                                                                 case, mesh)
        if (nd, ns) == (1, 4):
            for name, edits in mutants.items():
                fn = _mutant(name, edits)
                out["mutant", name] = [_merge_case(fn, case, mesh) for case in cases]
    out["modules"] = _foreign_modules()
    return out


def zc_cfar_rank(rank: int, mag: np.ndarray, cfar_kw: dict, zc_cases: list) -> dict:
    """On meshes (1, 4) and (2, 2): `sharded_zc_cfar_detect` on the
    magnitudes (batch, n), and `sharded_zc_detect` on each (channel-leading
    IQ, template, keywords) case."""
    torch.set_num_threads(1)
    out = {}
    for nd, ns in ((1, 4), (2, 2)):
        mesh = shard.make_stream_mesh(nd, ns)
        out["cfar", nd, ns] = (mesh.data, table_arrays(
            shard.sharded_zc_cfar_detect(_rows(mag, mesh), mesh, **cfar_kw)))
        for i, (x, ref, kw) in enumerate(zc_cases):
            t = shard.sharded_zc_detect(_block(x, mesh), mesh, reference=ref, **kw)
            out["zc", nd, ns, i] = (mesh.data, table_arrays(t))
    out["modules"] = _foreign_modules()
    return out


def cuda_rest_rank(rank: int, x: np.ndarray, kw: dict, mag: np.ndarray, cfar_kw: dict,
                   zx: np.ndarray, ref: np.ndarray, zc_kw: dict) -> dict:
    """On mesh (1, 2), the rank's blocks on the card (ranks share card 0
    over gloo): the Minn-RTL metric and detect with the blocked IIR and
    the per-sample merge, the ZC CFAR detect, the ZC detect from IQ
    through kernel E; returns the tables and each run's launches by mode."""
    from ofdm_sync_tpu_torch.kernels.launches import (
        launch_counts,
        mode_launch_counts,
        reset_launch_counts,
    )

    dev = torch.device("cuda", 0)
    mesh = shard.make_stream_mesh(1, 2)
    out = {}

    def run(key, fn):
        reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        out[key, "modes"] = {**mode_launch_counts(), **launch_counts()}
        return res

    metric = {k: v for k, v in kw.items() if k != "hysteresis"}
    blk = _block(x, mesh).to(dev)
    out["metric"] = _arrays(t.cpu() for t in run(
        "metric", lambda: shard.sharded_minn_rtl_planar(blk, mesh, **metric)))
    out["detect"] = table_arrays(run("detect", lambda: shard.sharded_minn_rtl_detect(
        blk, mesh, **kw)))
    out["cfar"] = table_arrays(run("cfar", lambda: shard.sharded_zc_cfar_detect(
        _rows(mag, mesh).to(dev), mesh, **cfar_kw)))
    out["zc"] = table_arrays(run("zc", lambda: shard.sharded_zc_detect(
        _block(zx, mesh).to(dev), mesh, reference=ref, **zc_kw)))
    return out
