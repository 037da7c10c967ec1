"""View-sharded (sequence-parallel) multi-view forward (counterpart of
``da3slam_tpu/parallel/sp_forward.py``).

The chunk's view axis is split over a mesh axis: patch embedding,
intra-view attention, MLPs and the DPT head run on each rank's own views;
the cross-view attention, the quadratic term, runs as ring attention over
the axis (``parallel/ring_attention.py``).  Depth, confidence, rays and
camera tokens are then all-gathered, and the small camera head runs on every
rank over all views, so the reference view's normalisation sees them all.
"""

from __future__ import annotations

import torch

from da3slam_tpu_torch.models import camera, dpt, vit
from da3slam_tpu_torch.models.config import ModelConfig
from da3slam_tpu_torch.models.da3 import DA3Net
from da3slam_tpu_torch.parallel import comm
from da3slam_tpu_torch.parallel.mesh import DeviceMesh, axis_size
from da3slam_tpu_torch.parallel.ring_attention import make_ring_cross_view_attention


def make_sharded_forward(
    cfg: ModelConfig,
    mesh: DeviceMesh,
    axis: str = "dp",
    ref_idx: int = 0,
    dtype: torch.dtype = torch.float32,
):
    """A forward with views sharded over ``mesh``'s ``axis``.

    Returned fn: ``(net, images [N, H, W, 3]) -> prediction dict`` of the
    whole chunk, called on every rank with the same images; N must divide by
    the axis size.  Rank r of the axis encodes views ``r·N/n .. (r+1)·N/n``.
    """
    n = axis_size(mesh, axis)
    r = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    ring = make_ring_cross_view_attention(mesh, axis)

    @torch.no_grad()
    def fwd(net: DA3Net, images: torch.Tensor) -> dict[str, torch.Tensor]:
        N, H, W, _ = images.shape
        if N % n:
            raise ValueError(f"{N} views do not divide over the {axis!r} axis of {n}")
        local = images[r * (N // n):(r + 1) * (N // n)]
        taps, final, grid = vit.encode(net, local, cfg, dtype, cross_attn_impl=ring)
        depth, conf, rays = dpt.apply_dpt(net.depth_head, taps, grid, (H, W), cfg)
        depth, conf, rays, cam_tokens = (comm.all_gather(t, group)
                                         for t in (depth, conf, rays, final[:, 0, :]))
        extrinsics, intrinsics = camera.apply_camera_head(net.camera_head, cam_tokens, (H, W),
                                                          ref_idx)
        return {"depth": depth, "conf": conf, "extrinsics": extrinsics,
                "intrinsics": intrinsics, "rays": rays}

    return fwd
