"""Device-resident streaming SLAM pipeline (counterpart of
``da3slam_tpu/slam/pipeline.py``).

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

With a mesh every rank runs the same program (SPMD) on the same frames and
returns the whole output: ``run_pipeline_dp`` splits the windows' forwards
over the ranks, ``run_pipeline_pp`` pipelines the encoder's depth over them
with windows as GPipe microbatches, ``run_pipeline_sp`` splits each window's
views over them with ring cross-view attention.  In all three the
alignment chain (``_align_step``, the same code as the one-device loop) runs
on every rank over the gathered forward outputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from da3slam_tpu_torch.models import camera, dpt
from da3slam_tpu_torch.models.config import ModelConfig
from da3slam_tpu_torch.models.da3 import DA3Net, forward_fn
from da3slam_tpu_torch.ops.resize import resize_normalize
from da3slam_tpu_torch.parallel import comm
from da3slam_tpu_torch.parallel.mesh import axis_size
from da3slam_tpu_torch.parallel.pp_forward import (
    EncoderRest,
    make_pp_encode,
    split_encoder_params,
)
from da3slam_tpu_torch.parallel.sp_forward import make_sharded_forward
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


def _setup(frames, window_idx, anchor_idx, process_hw, carry):
    """``(window_idx, anchor_idx, hw, fresh_start, carry)`` of a pipeline
    call; a fresh carry (None given) is zeros and identities on the frames'
    device."""
    window_idx, anchor_idx = np.asarray(window_idx), np.asarray(anchor_idx)
    hw = process_hw if process_hw is not None else (frames.shape[1], frames.shape[2])
    fresh_start = carry is None
    if fresh_start:
        H, W = hw
        dev = frames.device
        carry = (torch.zeros(H, W, device=dev), torch.zeros(H, W, device=dev),
                 torch.eye(3, device=dev), torch.eye(4, device=dev)[:3])
    return window_idx, anchor_idx, hw, fresh_start, carry


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
    window_idx, anchor_idx, hw, fresh_start, carry = _setup(frames, window_idx, anchor_idx,
                                                            process_hw, carry)
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


# the forward outputs the alignment chain reads
_ALIGN_KEYS = ("depth", "conf", "extrinsics", "intrinsics")


def _align_windows(outs: list[dict], anchor_idx: np.ndarray, fresh_start: bool, carry,
                   align_config: AlignmentConfig) -> tuple[PipelineOutput, tuple]:
    """Phase 2 of the multi-device pipelines: the sequential alignment chain
    over the windows' forward outputs."""
    emits = []
    for k, out in enumerate(outs):
        carry, emit = _align_step(carry, out, int(anchor_idx[k]), fresh_start and k == 0,
                                  align_config)
        emits.append(emit)
    return PipelineOutput(*(torch.stack(parts) for parts in zip(*emits))), carry


@torch.no_grad()
def run_pipeline_dp(
    net: DA3Net,
    frames: torch.Tensor,
    window_idx: np.ndarray,  # [C, N] int
    anchor_idx: np.ndarray,  # [C] int
    cfg: ModelConfig,
    mesh: DeviceMesh,
    align_config: AlignmentConfig = AlignmentConfig(),
    dtype: torch.dtype = torch.bfloat16,
    process_hw: tuple[int, int] | None = None,
    carry=None,
) -> tuple[PipelineOutput, tuple]:
    """Multi-device SLAM: the windows' forwards split over the mesh's ``dp``
    axis.

    Window k's forward does not depend on window k-1's alignment (only the
    pose chain does), so the forwards, the dominant cost, split over windows:

      phase 1: the windows, padded to a multiple of dp with repeats of the
               last, go in contiguous blocks to the dp ranks; each runs its
               own in sequence through ``forward_fn`` at the one-device
               loop's per-window shapes.  The outputs are all-gathered and
               the padding dropped.
      phase 2: every rank runs the sequential depth-scale/registration/pose
               chain over all windows (``_align_windows``), the one-device
               loop's arithmetic.

    At one rank the result is the one-device loop's, bit for bit.
    """
    window_idx, anchor_idx, hw, fresh_start, carry = _setup(frames, window_idx, anchor_idx,
                                                            process_hw, carry)
    dp, r, group = axis_size(mesh, "dp"), mesh.get_local_rank("dp"), mesh.get_group("dp")
    C = len(window_idx)
    pad = (-C) % dp
    widx = np.concatenate([window_idx, np.repeat(window_idx[-1:], pad, axis=0)])
    per = len(widx) // dp
    local = [forward_fn(net, resize_normalize(_take(frames, row), hw), cfg, ref_idx=0,
                        dtype=dtype)
             for row in widx[r * per:(r + 1) * per]]
    outs = {key: comm.all_gather(torch.stack([o[key] for o in local]), group)[:C]
            for key in _ALIGN_KEYS}
    return _align_windows([{key: outs[key][k] for key in _ALIGN_KEYS} for k in range(C)],
                          anchor_idx, fresh_start, carry, align_config)


class PPParams(NamedTuple):
    """This rank's share of the network for ``run_pipeline_pp``
    (``split_params_pp``)."""

    stage_blocks: nn.ModuleList  # this rank's stage of the encoder blocks
    enc_rest: EncoderRest  # patch embed / tokens / final norm, replicated
    heads: nn.ModuleDict  # {"dpt": ..., "camera": ...}, replicated


def split_params_pp(net: DA3Net, n_stages: int, mesh: DeviceMesh) -> PPParams:
    """This rank's stage of the encoder blocks (the mesh's ``pp`` coordinate)
    and the replicated rest and heads, sharing the network's modules.  Drop
    the network afterwards: each rank then holds ``depth / n_stages`` blocks
    (the weight-memory split that makes the giant tier smaller per device).
    Split once per model and reuse across segments."""
    blocks, rest = split_encoder_params(net, n_stages, mesh.get_local_rank("pp"))
    return PPParams(blocks, rest, nn.ModuleDict({"dpt": net.depth_head,
                                                 "camera": net.camera_head}))


@torch.no_grad()
def run_pipeline_pp(
    params: DA3Net | PPParams,
    frames: torch.Tensor,
    window_idx: np.ndarray,  # [C, N] int
    anchor_idx: np.ndarray,  # [C] int
    cfg: ModelConfig,
    mesh: DeviceMesh,
    align_config: AlignmentConfig = AlignmentConfig(),
    dtype: torch.dtype = torch.bfloat16,
    process_hw: tuple[int, int] | None = None,
    carry=None,
) -> tuple[PipelineOutput, tuple]:
    """Multi-device SLAM with the encoder pipelined over the mesh's ``pp``
    axis: the configuration for tiers whose weights should not sit whole on
    every device (the giant's 40 blocks in stages of 20).  Consecutive windows
    are the GPipe microbatches (``parallel/pp_forward.py``), so the stages
    work on successive windows at once; the DPT and camera heads and the
    alignment chain run after the pipeline, on every rank.

    ``params`` is the whole network (split per call) or a ``PPParams`` from
    ``split_params_pp`` (reused across segments).
    """
    window_idx, anchor_idx, hw, fresh_start, carry = _setup(frames, window_idx, anchor_idx,
                                                            process_hw, carry)
    n_stages = axis_size(mesh, "pp")
    if not isinstance(params, PPParams):
        params = split_params_pp(params, n_stages, mesh)
    encode_pp = make_pp_encode(cfg, mesh, n_stages, dtype)
    images_mb = torch.stack([resize_normalize(_take(frames, row), hw) for row in window_idx])
    taps, final = encode_pp(params.stage_blocks, params.enc_rest, images_mb)
    grid = (hw[0] // cfg.patch_size, hw[1] // cfg.patch_size)
    outs = []
    for m in range(len(window_idx)):
        depth, conf, _rays = dpt.apply_dpt(params.heads["dpt"], list(taps[m]), grid, hw, cfg)
        ext, K = camera.apply_camera_head(params.heads["camera"], final[m][:, 0, :], hw, 0)
        outs.append({"depth": depth, "conf": conf, "extrinsics": ext, "intrinsics": K})
    return _align_windows(outs, anchor_idx, fresh_start, carry, align_config)


@torch.no_grad()
def run_pipeline_sp(
    net: DA3Net,
    frames: torch.Tensor,
    window_idx: np.ndarray,  # [C, N] int
    anchor_idx: np.ndarray,  # [C] int
    cfg: ModelConfig,
    mesh: DeviceMesh,
    align_config: AlignmentConfig = AlignmentConfig(),
    dtype: torch.dtype = torch.bfloat16,
    process_hw: tuple[int, int] | None = None,
    carry=None,
) -> tuple[PipelineOutput, tuple]:
    """Multi-device SLAM with each window's views split over a mesh axis
    (``"sp"`` if the mesh has one, else its first): patch embed, intra-view
    attention, MLPs and the DPT head run on each rank's views, the cross-view
    attention as ring attention (``parallel/sp_forward.py``), so a window's
    latency shrinks with the ranks too.  The chunk size must divide by the
    axis."""
    window_idx, anchor_idx, hw, fresh_start, carry = _setup(frames, window_idx, anchor_idx,
                                                            process_hw, carry)
    names = mesh.mesh_dim_names
    fwd = make_sharded_forward(cfg, mesh, axis="sp" if "sp" in names else names[0], dtype=dtype)
    outs = [fwd(net, resize_normalize(_take(frames, row), hw)) for row in window_idx]
    return _align_windows(outs, anchor_idx, fresh_start, carry, align_config)


def run_streaming_slam(
    net: DA3Net | PPParams,
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

    ``mesh`` (a ``DeviceMesh``, ``parallel/mesh.py``; call this on every
    rank with the same frames and arguments) switches to a multi-device
    pipeline chosen by ``parallel``: ``"dp"`` (``run_pipeline_dp``) splits the
    windows' forwards over the mesh's ``dp`` axis, weights replicated;
    ``"pp"`` (``run_pipeline_pp``) pipelines the encoder's depth over its
    ``pp`` axis with windows as microbatches, the blocks split once over the
    ranks (or pass this rank's ``split_params_pp`` share as ``net``, having
    dropped the rest); ``"sp"`` (``run_pipeline_sp``) splits each window's
    views with ring cross-view attention.  Every rank returns the whole output.
    """
    if parallel not in ("dp", "pp", "sp"):
        raise ValueError(f"parallel must be 'dp', 'pp' or 'sp', got {parallel!r}")
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (parallel/mesh.py:make_mesh), "
                        f"got {type(mesh).__name__}")
    params = net
    if isinstance(net, PPParams):
        if mesh is None or parallel != "pp":
            raise ValueError("a PPParams share runs only with a mesh and parallel='pp'")
        net = net.enc_rest
    elif mesh is not None and parallel == "pp":
        # split once; every segment reuses this rank's stage
        params = split_params_pp(net, axis_size(mesh, "pp"), mesh)
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
        if mesh is None:
            return run_pipeline(net, seg_frames, seg_idx, seg_anchors, cfg, align_config, dtype,
                                process_hw, carry=carry, spill_dtype=spill_dtype)
        runner = {"dp": run_pipeline_dp, "pp": run_pipeline_pp, "sp": run_pipeline_sp}[parallel]
        out, carry = runner(params, seg_frames, seg_idx, seg_anchors, cfg, mesh, align_config,
                            dtype, process_hw, carry=carry)
        if spill_dtype is not None:  # cast before the spill
            out = out._replace(depth=out.depth.to(spill_dtype), conf=out.conf.to(spill_dtype))
        return out, carry

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
