"""The multi-card dry run (port of `__graft_entry__.dryrun_multichip`).

`dryrun_multichip(n_ranks)` spawns ``n_ranks`` ranks (`distributed.
run_ranks`), builds the (data, seq) mesh as the JAX package factors it and
runs one step of each sharded entry point at tiny shapes: the fused Minn-RTL
detect (one primed call a shard, and the halo-overlap split over two row
blocks a shard), the Minn-RTL metric with the blocked IIR, the ZC from-IQ detect
(tables merged), the ZC CFAR detect and the ZC detect from IQ with the
per-sample merge, and the Minn-RTL receive chain, whose two frames (the
second across a seam) must demodulate with an EVM below 10%.  It checks
shapes and finite values, not speed::

    python -c "from ofdm_sync_tpu_torch.parallel.dryrun import dryrun_multichip; \\
               dryrun_multichip(4)"               # the card; device="cpu" on a host

Ranks share the device over gloo by default; ``backend="nccl"`` takes one
card a rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ofdm_sync_tpu_torch.device import resolve_device
from ofdm_sync_tpu_torch.ops.estimate import (
    align_complex_gain,
    equalize,
    evm_rms_db,
    ls_channel_estimate,
)
from ofdm_sync_tpu_torch.ops.waveforms import build_minn_rtl_preamble, ofdm_fft_used
from ofdm_sync_tpu_torch.parallel import shard
from ofdm_sync_tpu_torch.parallel.distributed import run_ranks
from ofdm_sync_tpu_torch.params import SystemParams
from ofdm_sync_tpu_torch.pipelines import common

# the flagship Minn-RTL settings of `__graft_entry__` at a tiny quarter length
_Q = 16
_MINN = dict(quarter_len=_Q, smooth_shift=3, threshold_value=int(0.10 * (1 << 15)),
             threshold_frac_bits=15)
_HYST = 2
#: the ZC steps: a 64-sample template, a 2x-local-mean CFAR with no
#: absolute floor, so random stimulus fires events across the seams
_RF = 64
_ZC = dict(corr_window=64, threshold_value=int(2.0 * (1 << 15) / 64), min_corr_mag=0.0,
           hysteresis=8, max_events=4)
#: the receive chain's system: frame 2 at [924, 1164) crosses the seam at 1024
_RX_SYS = SystemParams(n_fft=64, num_active=48, cp_len=16, sample_rate_hz=1e6, tx_pre_pad=444)


def mesh_shape(n_ranks: int) -> tuple[int, int]:
    """(data, seq) as the JAX dry run factors its devices: (2, n/2) for an
    even n >= 4, else (1, n)."""
    n_data = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    return n_data, n_ranks // n_data


def _seq_block(x: torch.Tensor, mesh: shard.StreamMesh) -> torch.Tensor:
    """The rank's (..., B_loc, block) block of a whole (..., batch, n)
    array: its data slice (`shard.shard_batch`), then its seq block."""
    x = shard.shard_batch(x, mesh, axis=x.dim() - 2)
    block = x.shape[-1] // mesh.n_seq
    return x[..., mesh.seq * block: (mesh.seq + 1) * block].contiguous()


def _zc_template(n: int) -> np.ndarray:
    """A Zadoff-Chu sequence of odd root 7 and length n."""
    k = np.arange(n)
    return np.exp(-1j * np.pi * 7 * k * (k + 1) / n)


def _finite(*ts) -> None:
    for t in ts:
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite output of a sharded step")


def _receive(mesh, dev) -> dict:
    """The Minn-RTL receive chain on a two-frame stimulus (stream 0 of each
    data slice): both frames found within 4 samples and each demodulated
    (LS estimate on the pilot, equalized data, EVM < 10%)."""
    rng = np.random.default_rng(0)  # a seed with strong metric peaks at Q = 16
    sp, Q = _RX_SYS, _Q
    frame_len = 5 * Q + 2 * (sp.cp_len + sp.n_fft)
    preamble = build_minn_rtl_preamble("qpsk_freq", rng, Q=Q, sys=sp)
    setup = common.build_setup(preamble, rng, sys=sp, channel_name=None, cir_mode="two",
                               snr_db=30.0, cfo_hz=0.0, two_frames=True, device="cpu")
    L = mesh.n_seq * max(1024, 2048 // mesh.n_seq)
    rx = setup.rx[0].numpy()
    pl = np.zeros((2, mesh.n_data, L), np.float32)
    pl[0, :, : rx.size], pl[1, :, : rx.size] = rx.real, rx.imag
    table, frames, starts, valid = shard.sharded_minn_rtl_receive(
        _seq_block(torch.from_numpy(pl).to(dev), mesh), mesh, **dict(
            _MINN, threshold_value=int(0.3 * (1 << 15))), hysteresis=_HYST,
        frame_len=frame_len, timing_offset=-6 * Q, max_frames=4)
    frames, starts, valid = frames[0].cpu(), starts[0].cpu(), valid[0].cpu()
    pilot_at, data_at = 5 * Q + sp.cp_len, 5 * Q + 2 * sp.cp_len + sp.n_fft
    pilot, data = (torch.as_tensor(a, dtype=torch.complex64)
                   for a in (setup.pilot_used, setup.data_used))
    evms, found = [], []
    for ts in (sp.tx_pre_pad, sp.tx_pre_pad + 2 * frame_len):
        hits = [k for k in range(valid.shape[0]) if valid[k] and abs(int(starts[k]) - ts) <= 4]
        if not hits:
            raise AssertionError(f"receive chain: no frame within 4 of {ts}: starts "
                                 f"{starts.tolist()}, valid {valid.tolist()}")
        ant = torch.complex(frames[hits[0], 0], frames[hits[0], 1])
        h = ls_channel_estimate(ofdm_fft_used(ant[pilot_at: pilot_at + sp.n_fft], sp), pilot)
        eq = equalize(ofdm_fft_used(ant[data_at: data_at + sp.n_fft], sp), h)
        evms.append(float(evm_rms_db(align_complex_gain(eq, data)[0], data)[0]))
        found.append(int(starts[hits[0]]))
    if not all(e < 0.10 for e in evms):
        raise AssertionError(f"receive chain: EVM {evms} not below 10%")
    return dict(starts=found, evms=evms, count=int(table.count[0]))


def _rank(rank: int, n_data: int, n_seq: int, device: str, backend: str) -> dict:
    """One rank of the dry run: every step on its block; returns counts,
    the receive chain's starts and EVMs, and the kernels it launched."""
    from ofdm_sync_tpu_torch.kernels.launches import launch_counts

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else dev.index or 0)
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    mesh = shard.make_stream_mesh(n_data, n_seq)
    g = torch.Generator().manual_seed(1)
    out = {}

    # Minn-RTL: the fused detect and the metric with the blocked IIR; each
    # seq shard holds the fused halo (3Q + the smoothing memory + h)
    block = max(8 * _Q, ((3 * _Q + 256) // 128 + 1) * 128)
    batch = 2 * n_data
    x = _seq_block(torch.randn((4, batch, n_seq * block), generator=g).to(dev), mesh)
    table = shard.sharded_minn_rtl_detect_fused(x, mesh, **_MINN, hysteresis=_HYST,
                                                max_events=4)
    corr, smooth, energy, above = shard.sharded_minn_rtl_planar(x, mesh, **_MINN)
    _finite(corr, smooth, energy)
    out.update(minn_count=table.count.tolist(), minn_shape=tuple(smooth.shape),
               minn_above=int(above.sum()))

    # the fused detect's halo-overlap split, as the JAX dry run's time-major
    # step: two row blocks a seq shard, the interior run before the rows
    # that the halo primes
    rows = -(-shard.minn_halo_width(_Q, _MINN["smooth_shift"], _HYST) // 128) * 128
    g2 = torch.Generator().manual_seed(2)
    xs = _seq_block(torch.randn((4, batch, n_seq * 2 * rows), generator=g2).to(dev), mesh)
    split = shard.sharded_minn_rtl_detect_fused(xs, mesh, **_MINN, hysteresis=_HYST,
                                                max_events=4, overlap_halo=True, rows=rows)
    if split.count.shape != (batch // n_data,):
        raise AssertionError(f"split detect: table of {tuple(split.count.shape)} streams")
    out["split_count"] = split.count.tolist()

    # ZC: from IQ with the table merge, CFAR on magnitudes, and from IQ
    # through the matched filter with the per-sample merge
    L = n_seq * 1024
    mf, iq = (_seq_block(torch.randn((4, batch, L), generator=g).to(dev), mesh)
              for _ in range(2))
    ref = _zc_template(_RF)
    t_iq = shard.sharded_zc_iq_detect(mf, iq, mesh, ref_len=_RF, ref_norm=float(np.sqrt(_RF)),
                                      **_ZC, stream_len=L)
    mag = _seq_block(torch.randn((batch, L), generator=g).abs().to(dev), mesh)
    t_cfar = shard.sharded_zc_cfar_detect(mag, mesh, **_ZC)
    rx = 0.05 * torch.randn((4, batch, L), generator=g)
    pos = L // 2 - _RF // 2  # the template across the middle seam (or mid-stream)
    rx[0::2, :, pos: pos + _RF] += torch.as_tensor(ref.real, dtype=torch.float32)
    rx[1::2, :, pos: pos + _RF] += torch.as_tensor(ref.imag, dtype=torch.float32)
    t_zc = shard.sharded_zc_detect(_seq_block(rx.to(dev), mesh), mesh, reference=ref,
                                   **dict(_ZC, min_corr_mag=0.6))
    peaks = [t_zc.peak_idx[b, t_zc.valid[b]].tolist() for b in range(t_zc.count.shape[0])]
    if not all(any(abs(p - (pos + _RF - 1)) <= 1 for p in pk) for pk in peaks):
        raise AssertionError(f"ZC detect: the template's peak at {pos + _RF - 1} not found: "
                             f"{peaks}")
    out.update(zc_iq_count=t_iq.count.tolist(), zc_cfar_count=t_cfar.count.tolist(),
               zc_count=t_zc.count.tolist())

    out["receive"] = _receive(mesh, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out.update(rank=rank, data=mesh.data, seq=mesh.seq, launches=launch_counts())
    return out


def dryrun_multichip(n_ranks: int, *, backend: str = "gloo", device=None) -> str:
    """Spawn ``n_ranks`` ranks on ``device`` (the card by default; NCCL
    takes ``cuda:rank`` for rank r), run one step of every sharded entry
    point on the (data, seq) mesh of `mesh_shape`, check it, print the one
    ``dryrun_multichip OK: ...`` line and return it."""
    dev = resolve_device(device)
    n_data, n_seq = mesh_shape(n_ranks)
    ranks = run_ranks(_rank, n_ranks, (n_data, n_seq, str(dev), backend), backend=backend)
    r0 = ranks[0]
    for r in ranks:
        if r["receive"]["starts"] != r0["receive"]["starts"]:
            raise AssertionError(f"ranks disagree on the received frames: {ranks}")
    rx = r0["receive"]
    minn = [c for r in ranks if r["seq"] == 0 for c in r["minn_count"]]
    split = [c for r in ranks if r["seq"] == 0 for c in r["split_count"]]
    launches = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
    line = (f"dryrun_multichip OK: mesh=(data={n_data}, seq={n_seq}) on {dev} over {backend}, "
            f"Minn-RTL fused detect events per stream={minn}, split={split}, metric "
            f"{r0['minn_shape']} a "
            f"rank; ZC from-IQ events={sum(sum(r['zc_iq_count']) for r in ranks if r['seq'] == 0)}"
            f", CFAR events={sum(sum(r['zc_cfar_count']) for r in ranks if r['seq'] == 0)}, "
            f"from IQ with the per-sample merge events="
            f"{sum(sum(r['zc_count']) for r in ranks if r['seq'] == 0)}; RECEIVE CHAIN OK: 2 "
            f"frames recovered across the seq seam (starts={rx['starts']}, "
            f"EVM={[f'{100 * e:.2f}%' for e in rx['evms']]}); kernel launches "
            f"{ {k: n for k, n in launches.items() if n} }")
    print(line)
    return line
