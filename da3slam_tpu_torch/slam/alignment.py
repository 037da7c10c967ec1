"""Chunk-to-chunk alignment + global pose chaining (counterpart of
``da3slam_tpu/slam/alignment.py``).

  1. depth scale: confidence-gated median ratio on the overlap frame pair
  2. registration between the overlap frames' camera-coordinate clouds:
     projective ICP (``icp``), confidence-weighted Huber IRLS over pixelwise
     correspondences (``irls``) or closed-form weighted Umeyama (``umeyama``)
  3. anchoring: the current chunk's anchor pose from the previous overlap pose
  4. chaining: every frame's global w2c in one batched compose

All of it runs on the inputs' device and reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from da3slam_tpu_torch.core.geometry import backproject_depth, depth_scale_ratio
from da3slam_tpu_torch.core.transforms import (
    Sim3,
    highest_precision,
    orthonormalize_rotation,
    se3_compose,
    se3_inverse,
    sim3_inverse,
)
from da3slam_tpu_torch.ops.icp import run_icp
from da3slam_tpu_torch.ops.registration import irls_sim3, weighted_umeyama
from da3slam_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class AlignmentConfig:
    """Knobs mirroring configs/config1.yaml ``Align`` + the solver defaults."""

    conf_threshold: float = 0.2  # depth-scale confidence gate
    icp_threshold: float = 0.1  # correspondence gate
    icp_max_iterations: int = 12
    # source-cloud pixel stride (the target map stays full resolution)
    icp_stride: int = 4
    method: str = "icp"  # "icp" | "irls" | "umeyama"
    irls_delta: float = 0.1  # configs/config1.yaml IRLS block
    irls_max_iters: int = 5
    # convergence early exit (configs/config1.yaml IRLS.tol); None = fixed count
    irls_tol: float | None = None
    with_scale: bool = False  # SE(3)+depth-prescale (solver path) vs full Sim(3)

    @classmethod
    def from_config(cls, config: dict) -> "AlignmentConfig":
        """From a loaded YAML config: the ``Align`` block's keys are the
        fields' names (unknown keys are rejected); the ``IRLS`` block's
        ``delta`` / ``max_iters`` / ``tol`` fill the ``irls_*`` fields that
        ``Align`` leaves unset."""
        fields = {f"irls_{k}": v for k, v in (config.get("IRLS") or {}).items()}
        fields.update(config.get("Align") or {})
        return cls(**fields)


class ChunkAlignment(NamedTuple):
    extrinsics_global: torch.Tensor  # [N, 3, 4] w2c of the current chunk
    depth_scaled: torch.Tensor  # [N, H, W] current chunk depth after prescale
    prev_overlap_for_next: torch.Tensor  # [3, 4] last frame's global w2c
    transform: Sim3  # overlap registration (cur → prev camera frame)
    depth_scale: torch.Tensor  # scalar s multiplied into cur depth
    fitness: torch.Tensor
    inlier_rmse: torch.Tensor


def chain_extrinsics(
    E_local: torch.Tensor, E_anchor_global: torch.Tensor, anchor_idx: int = 0
) -> torch.Tensor:
    """Chain chunk-local w2c ``[N, 3, 4]`` onto the anchor frame's global w2c
    ``[3, 4]``: ``E_i_global = E_i_local ∘ E_anchor_local^{-1} ∘ E_anchor_global``."""
    rel = se3_compose(E_local, se3_inverse(E_local[anchor_idx])[None])
    return se3_compose(rel, E_anchor_global[None])


@highest_precision()
def align_chunk_single_overlap(
    prev_depth: torch.Tensor,  # [H, W] prev chunk's LAST frame
    prev_conf: torch.Tensor,
    prev_K: torch.Tensor,  # [3, 3]
    cur_depth: torch.Tensor,  # [N, H, W] full current chunk
    cur_conf: torch.Tensor,  # [N, H, W]
    cur_K: torch.Tensor,  # [N, 3, 3]
    cur_extrinsics: torch.Tensor,  # [N, 3, 4] chunk-local w2c
    prev_overlap_global: torch.Tensor,  # [3, 4] prev last frame's global w2c
    config: AlignmentConfig = AlignmentConfig(),
    anchor_idx: int = 0,
) -> ChunkAlignment:
    """Single-frame-overlap chunk alignment.

    ``anchor_idx`` is the index within the current chunk of the frame that is
    physically the previous chunk's last frame: ``overlap_size - 1`` in the
    steady state, larger for the re-anchored tail window.
    """
    cur_anchor_depth = cur_depth[anchor_idx]
    cur_anchor_conf = cur_conf[anchor_idx]
    cur_anchor_K = cur_K[anchor_idx]

    # 1) depth scale on a stride-st grid of the same physical frame
    st = max(int(config.icp_stride), 1)
    s_depth = depth_scale_ratio(
        prev_depth[::st, ::st],
        cur_anchor_depth[::st, ::st],
        prev_conf[::st, ::st],
        cur_anchor_conf[::st, ::st],
        conf_th=config.conf_threshold,
    )
    depth_scaled = cur_depth * s_depth
    # the chunk's rescale applies to its whole local world: extrinsic
    # translations follow the depth
    cur_extrinsics = torch.cat(
        [cur_extrinsics[..., :3], cur_extrinsics[..., 3:] * s_depth], dim=-1
    )

    # 2) overlap registration in camera coords (viewpoints nearly coincide)
    scaled_anchor_depth = cur_anchor_depth * s_depth
    tgt_map = backproject_depth(prev_depth, prev_K)
    src_map = backproject_depth(scaled_anchor_depth, cur_anchor_K)
    src_pts = src_map[::st, ::st].reshape(-1, 3)
    src_valid = scaled_anchor_depth[::st, ::st].reshape(-1) > 1e-6
    tgt_valid = prev_depth > 1e-6

    if config.method == "icp":
        with span("align.icp", iterations=config.icp_max_iterations) as attrs:
            icp, attrs["graph"] = run_icp(
                src_pts, tgt_map, prev_K,
                src_valid=src_valid, tgt_valid=tgt_valid,
                threshold=config.icp_threshold,
                max_iterations=config.icp_max_iterations,
                with_scale=config.with_scale,
            )
        T, fitness, rmse = icp.transform, icp.fitness, icp.inlier_rmse
    elif config.method == "umeyama":
        w = (src_valid & tgt_valid[::st, ::st].reshape(-1)).to(torch.float32)
        T = weighted_umeyama(src_pts, tgt_map[::st, ::st].reshape(-1, 3), w, config.with_scale)
        fitness = torch.ones((), device=cur_depth.device)
        rmse = torch.zeros((), device=cur_depth.device)
    elif config.method == "irls":
        # pixelwise correspondence (the same grid, both maps strided alike)
        w = torch.sqrt(prev_conf[::st, ::st].reshape(-1)
                       * cur_anchor_conf[::st, ::st].reshape(-1))
        w = w * src_valid * tgt_valid[::st, ::st].reshape(-1)
        res = irls_sim3(
            src_pts, tgt_map[::st, ::st].reshape(-1, 3), conf=w,
            delta=config.irls_delta, max_iters=config.irls_max_iters,
            with_scale=config.with_scale, tol=config.irls_tol,
        )
        T, rmse = res.transform, res.rmse
        fitness = torch.ones((), device=cur_depth.device)
    else:
        raise ValueError(f"unknown alignment method {config.method!r}")

    # 3) anchor: E_anchor_global = T^{-1} ∘ E_prev_global (the inverse taken
    #    in Sim(3)), with the rotation re-projected onto SO(3): it is the only
    #    state carried from chunk to chunk, and drift would compound
    Tinv = sim3_inverse(T)
    Tinv_mat = torch.cat([Tinv.s * Tinv.R, Tinv.t[:, None]], dim=-1)
    E_anchor_global = se3_compose(Tinv_mat, prev_overlap_global)
    E_anchor_global = torch.cat(
        [orthonormalize_rotation(E_anchor_global[..., :3]), E_anchor_global[..., 3:]], dim=-1
    )

    # 4) chain the rest of the chunk around the anchor frame
    extrinsics_global = chain_extrinsics(cur_extrinsics, E_anchor_global, anchor_idx)
    return ChunkAlignment(
        extrinsics_global=extrinsics_global,
        depth_scaled=depth_scaled,
        prev_overlap_for_next=extrinsics_global[-1],
        transform=T,
        depth_scale=s_depth,
        fitness=fitness,
        inlier_rmse=rmse,
    )
