"""Device-resident streaming SLAM pipeline on one device (counterpart of
``da3slam_tpu/slam/pipeline.py``: ``run_pipeline`` and ``run_streaming_slam``).

The chunk loop runs over fixed-size windows with a carry that holds the
previous overlap frame's depth, confidence, intrinsics and global pose.  The
JAX package compiles the loop as one ``lax.scan``; here it is a Python loop
whose carry stays on the device: resize, model forward, depth scale,
registration and pose chaining queue on the device one window after another,
and the host waits for nothing until the outputs are fetched.  Whether a
window is the first is known on the host, so the scan's ``lax.cond`` is an
``if``.

The device holds the sequence once as uint8 frames; each step takes its
window's frames by index and normalises them on the fly.  The tail window is
re-anchored to keep the full chunk size (``slam/chunks.py``), which widens its
overlap with the previous window; the per-window ``anchor_idx`` keeps the
alignment pairing on the same physical frame.

The multi-device pipelines (``mesh=``) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from da3slam_tpu_torch.models.config import ModelConfig
from da3slam_tpu_torch.models.da3 import DA3Net, forward_fn
from da3slam_tpu_torch.ops.resize import resize_normalize
from da3slam_tpu_torch.slam.alignment import AlignmentConfig, align_chunk_single_overlap
from da3slam_tpu_torch.slam.chunks import make_chunk_indices


class PipelineOutput(NamedTuple):
    """Tensors on the model's device, or numpy arrays after a host spill."""

    depth: torch.Tensor | np.ndarray  # [C, N, H, W]
    conf: torch.Tensor | np.ndarray  # [C, N, H, W]
    extrinsics_global: torch.Tensor | np.ndarray  # [C, N, 3, 4] w2c
    intrinsics: torch.Tensor | np.ndarray  # [C, N, 3, 3]
    depth_scale: torch.Tensor | np.ndarray  # [C]
    fitness: torch.Tensor | np.ndarray  # [C]


def make_windows(n_frames: int, chunk_size: int, overlap: int) -> tuple[np.ndarray, np.ndarray]:
    """Window gather indices ``[C, chunk_size]`` plus per-window anchor
    indices ``[C]``: the position within window k of the frame that is
    window k-1's last frame (``overlap-1`` in steady state; larger for the
    re-anchored tail)."""
    ranges = make_chunk_indices(n_frames, chunk_size, overlap)
    idx = np.stack([np.arange(a, b) for a, b in ranges])
    anchors = np.zeros(len(ranges), np.int32)
    for k in range(1, len(ranges)):
        prev_last = ranges[k - 1][1] - 1
        anchors[k] = prev_last - ranges[k][0]
    return idx, anchors


def _align_step(carry, out, a_idx: int, is_first: bool, align_config: AlignmentConfig):
    """One window's alignment/anchoring against the running carry:
    ``(new_carry, (depth, conf, extrinsics_global, intrinsics, scale, fitness))``."""
    prev_depth, prev_conf, prev_K, prev_E_global = carry
    if is_first:
        # the first chunk defines the global frame
        ext_global, depth = out["extrinsics"], out["depth"]
        s = fitness = torch.ones((), dtype=torch.float32, device=depth.device)
    else:
        a = align_chunk_single_overlap(
            prev_depth=prev_depth,
            prev_conf=prev_conf,
            prev_K=prev_K,
            cur_depth=out["depth"],
            cur_conf=out["conf"],
            cur_K=out["intrinsics"],
            cur_extrinsics=out["extrinsics"],
            prev_overlap_global=prev_E_global,
            config=align_config,
            anchor_idx=a_idx,
        )
        ext_global, depth = a.extrinsics_global, a.depth_scaled
        s, fitness = a.depth_scale, a.fitness
    new_carry = (depth[-1], out["conf"][-1], out["intrinsics"][-1], ext_global[-1])
    return new_carry, (depth, out["conf"], ext_global, out["intrinsics"], s, fitness)


def _take(frames: torch.Tensor, idx_row: np.ndarray) -> torch.Tensor:
    """The window's frames: a slice where the indices are consecutive (every
    window of ``make_windows``), which needs no index tensor on the device."""
    lo = int(idx_row[0])
    if np.array_equal(idx_row, np.arange(lo, lo + len(idx_row))):
        return frames[lo:lo + len(idx_row)]
    return frames[torch.as_tensor(np.asarray(idx_row), dtype=torch.long, device=frames.device)]


@torch.no_grad()
def run_pipeline(
    net: DA3Net,
    frames: torch.Tensor,  # [T, H, W, 3] uint8 (or float), on the net's device
    window_idx: np.ndarray,  # [C, N] int
    anchor_idx: np.ndarray,  # [C] int
    cfg: ModelConfig,
    align_config: AlignmentConfig = AlignmentConfig(),
    dtype: torch.dtype = torch.bfloat16,
    process_hw: tuple[int, int] | None = None,
    carry=None,
    spill_dtype: torch.dtype | None = None,
) -> tuple[PipelineOutput, tuple]:
    """Run the SLAM loop over all windows without leaving the device.

    ``carry`` threads segmented runs: pass the carry returned by the previous
    segment to continue a sequence (None starts fresh: the first window then
    defines the global frame).  Returns ``(outputs, final_carry)``.

    ``spill_dtype`` (e.g. ``torch.float16``) casts the dense emitted maps,
    depth and conf, as each window emits them, halving the stacked output and
    any later device→host spill.  The alignment math (the carry) stays f32;
    poses, intrinsics and scales are tiny and stay f32.
    """
    window_idx, anchor_idx = np.asarray(window_idx), np.asarray(anchor_idx)
    hw = process_hw if process_hw is not None else (frames.shape[1], frames.shape[2])
    fresh_start = carry is None
    if fresh_start:
        H, W = hw
        dev = frames.device
        carry = (torch.zeros(H, W, device=dev), torch.zeros(H, W, device=dev),
                 torch.eye(3, device=dev), torch.eye(4, device=dev)[:3])
    emits = []
    for k, idx_row in enumerate(window_idx):
        chunk_images = resize_normalize(_take(frames, idx_row), hw)
        out = forward_fn(net, chunk_images, cfg, ref_idx=0, dtype=dtype)
        carry, (d, cf, ext, K, s, fit) = _align_step(
            carry, out, int(anchor_idx[k]), fresh_start and k == 0, align_config)
        if spill_dtype is not None:
            d, cf = d.to(spill_dtype), cf.to(spill_dtype)
        emits.append((d, cf, ext, K, s, fit))
    return PipelineOutput(*(torch.stack(parts) for parts in zip(*emits))), carry


def run_streaming_slam(
    net: DA3Net,
    frames,  # [T, H, W, 3] uint8: a numpy array or a tensor
    cfg: ModelConfig,
    chunk_size: int = 16,
    overlap: int = 1,
    process_hw: tuple[int, int] | None = None,
    align_config: AlignmentConfig = AlignmentConfig(),
    dtype: torch.dtype = torch.bfloat16,
    segment_windows: int | None = None,
    segment_spill: str = "host",
    spill_dtype: torch.dtype | None = None,
    mesh=None,
    parallel: str = "dp",
) -> PipelineOutput:
    """Window indexing + the pipeline, on the device the network lives on.

    ``segment_windows`` bounds device memory for arbitrarily long sequences:
    the loop runs ``segment_windows`` windows at a time, keeping only each
    segment's frame slice on the device and threading the carry between
    segments; results are those of the single run.  With numpy frames the next
    segment's slice is staged while this one computes: pinned host memory and a
    side stream (``inout/prefetch.py``).

    ``segment_spill`` says where segment outputs accumulate: "host" (the
    default: each segment's outputs move off the device, the true
    bounded-memory mode; the result holds numpy arrays) or "device" (outputs
    stay tensors).  Without segments the result holds tensors.

    ``spill_dtype`` (e.g. ``torch.float16``) emits the dense depth/conf maps
    in a compact dtype, halving the per-segment output buffer and the
    device→host spill.  None keeps the bit-exact f32 path.

    ``mesh`` would switch to a multi-device pipeline chosen by ``parallel``
    (``"dp"``, ``"pp"``, ``"sp"``); those are not ported yet.
    """
    if parallel not in ("dp", "pp", "sp"):
        raise ValueError(f"parallel must be 'dp', 'pp' or 'sp', got {parallel!r}")
    if mesh is not None:
        raise NotImplementedError("the multi-device pipelines are not ported yet "
                                  "(ROADMAP queue 1, item 14): pass mesh=None")
    device = next(net.parameters()).device
    idx, anchors = make_windows(frames.shape[0], chunk_size, overlap)
    on_device_frames = isinstance(frames, torch.Tensor)
    if not on_device_frames:
        frames = np.asarray(frames)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" and not on_device_frames \
        else None

    def stage(f_lo: int, f_hi: int):
        """Frames ``[f_lo, f_hi)`` on the device: ``(tensor, copy-done event or
        None)``.  A numpy slice is uploaded from pinned memory on the side
        stream, so staging segment k+1 right after queuing segment k puts the
        copy under that compute."""
        if on_device_frames:
            return frames[f_lo:f_hi].to(device), None
        if copy_stream is None:
            return torch.from_numpy(frames[f_lo:f_hi]), None
        from da3slam_tpu_torch.inout.prefetch import upload_pinned

        return upload_pinned(frames[f_lo:f_hi], device, copy_stream)

    def claim(staged) -> torch.Tensor:
        batch, done = staged
        if done is not None:
            from da3slam_tpu_torch.inout.prefetch import claim_upload

            claim_upload(batch, done, device)
        return batch

    def run_segment(seg_frames, seg_idx, seg_anchors, carry):
        return run_pipeline(net, seg_frames, seg_idx, seg_anchors, cfg, align_config, dtype,
                            process_hw, carry=carry, spill_dtype=spill_dtype)

    if segment_windows is None or segment_windows >= idx.shape[0]:
        out, _ = run_segment(claim(stage(0, frames.shape[0])), idx, anchors, None)
        return out

    if segment_spill not in ("host", "device"):
        raise ValueError(f"segment_spill must be 'host' or 'device', got {segment_spill!r}")
    starts = list(range(0, idx.shape[0], segment_windows))

    def stage_segment(s0: int):
        seg_idx = idx[s0:s0 + segment_windows]
        f_lo, f_hi = int(seg_idx.min()), int(seg_idx.max()) + 1
        return stage(f_lo, f_hi), seg_idx - f_lo, anchors[s0:s0 + segment_windows]

    outputs = []
    carry = None
    staged = stage_segment(starts[0])
    for k, s0 in enumerate(starts):
        seg_staged, seg_idx, seg_anchors = staged
        out, carry = run_segment(claim(seg_staged), seg_idx, seg_anchors, carry)
        if k + 1 < len(starts):  # stage the next segment while this one computes
            staged = stage_segment(starts[k + 1])
        # the host fetch (spill) below is what waits for the compute
        outputs.append(PipelineOutput(*(t.cpu().numpy() for t in out))
                       if segment_spill == "host" else out)
    cat = np.concatenate if segment_spill == "host" else torch.cat
    return PipelineOutput(*[cat(parts) for parts in zip(*outputs)])
