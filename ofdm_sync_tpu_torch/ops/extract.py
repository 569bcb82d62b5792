"""Aligned frame re-emission (port of `ofdm_sync_tpu.ops.extract`).

The RTL detector re-emits the delayed sample stream with a frame-start
pulse aligned to each detected preamble (circular sample buffer + timer
queue, reference ref/minn_preamble_detector.sv:445-530).  Here the buffer
is the device-resident stream itself, the queue is the event table, and
re-emission is one gather of ``frame_len`` samples per valid event, on the
stream's device.  The JAX package has no Pallas kernel for this step.
"""

from __future__ import annotations

import torch

from ofdm_sync_tpu_torch.ops.detect import GateEvents


def extract_frames_batched(
    iq: torch.Tensor,
    table: GateEvents,
    *,
    frame_len: int,
    timing_offset: int = 0,
    max_frames: int = 4,
):
    """iq ``(batch, C, L)``, table fields ``(batch, E)`` -> frames
    ``(batch, max_frames, C, frame_len)``, starts ``(batch, max_frames)``
    int32 (clipped into the stream), valid ``(batch, max_frames)`` bool."""
    batch, C, L = iq.shape
    E = table.peak_idx.shape[-1]
    K = min(max_frames, E)
    dev = iq.device
    slot = torch.arange(K, device=dev)
    valid = table.valid[:, :K] & (slot < table.count.unsqueeze(-1))
    starts = (table.peak_idx[:, :K].to(torch.int64) + timing_offset).clamp(
        0, max(L - frame_len, 0))
    if frame_len > L:
        raise ValueError(f"frame_len {frame_len} exceeds the stream length {L}")
    idx = starts.unsqueeze(-1) + torch.arange(frame_len, device=dev)  # (batch, K, F)
    gathered = torch.gather(
        iq.unsqueeze(1).expand(batch, K, C, L), -1,
        idx.unsqueeze(2).expand(batch, K, C, frame_len))
    frames = torch.where(valid[..., None, None], gathered,
                         torch.zeros((), dtype=iq.dtype, device=dev))
    if K < max_frames:
        pad = max_frames - K
        frames = torch.cat([frames, frames.new_zeros((batch, pad, C, frame_len))], dim=1)
        starts = torch.cat([starts, starts.new_zeros((batch, pad))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((batch, pad))], dim=1)
    return frames, starts.to(torch.int32), valid


def extract_frames(
    iq: torch.Tensor,
    table: GateEvents,
    *,
    frame_len: int,
    timing_offset: int = 0,
    max_frames: int = 4,
):
    """Single stream: iq ``(C, L)`` planar rows, table fields ``(E,)``.

    For each of the first ``max_frames`` valid events, gathers
    ``frame_len`` samples starting at ``peak_idx + timing_offset`` (clipped
    into the stream).  Returns ``(frames (max_frames, C, frame_len),
    starts (max_frames,) int32, valid (max_frames,) bool)``; frames are
    zero where invalid."""
    t1 = GateEvents(*(f.unsqueeze(0) for f in table))
    frames, starts, valid = extract_frames_batched(
        iq.unsqueeze(0), t1, frame_len=frame_len, timing_offset=timing_offset,
        max_frames=max_frames)
    return frames[0], starts[0], valid[0]
