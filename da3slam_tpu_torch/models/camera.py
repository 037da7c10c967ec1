"""Camera head: per-view pose (w2c) + pinhole intrinsics from camera tokens
(counterpart of ``da3slam_tpu/models/camera.py``; ``pose_from_rays`` is not
ported yet).

Extrinsics ``[N, 3, 4]`` are w2c, OpenCV convention, local to the chunk with
the reference view at the identity; intrinsics ``[N, 3, 3]`` are zero-skew,
in pixels of the processed resolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from da3slam_tpu_torch.core.transforms import (
    highest_precision,
    quat_to_rotmat,
    se3_compose,
    se3_inverse,
)
from da3slam_tpu_torch.models.config import ModelConfig
from da3slam_tpu_torch.models.vit import Mlp

N_OUT = 11  # quat(4) + trans(3) + log-focal(2) + principal-offset(2)


class CameraHead(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.mlp = Mlp(cfg.embed_dim, cfg.camera_dim, cfg.camera_dim)
        self.out = nn.Linear(cfg.camera_dim, N_OUT)


@torch.no_grad()
def init_camera_head(head: CameraHead, generator: torch.Generator) -> None:
    for lin, std in ((head.mlp.fc1, 0.02), (head.mlp.fc2, 0.02), (head.out, 1e-3)):
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        nn.init.zeros_(lin.bias)
    head.out.bias[0] = 1.0  # identity quaternion


def ref_view_index(n_views: int, strategy: str) -> int:
    """Static reference-view selection (the local-frame anchor)."""
    if strategy in ("first", "default"):
        return 0
    if strategy == "middle":
        return n_views // 2
    if strategy == "last":
        return n_views - 1
    raise ValueError(f"unknown ref_view_strategy {strategy!r}")


@highest_precision()
def apply_camera_head(
    head: CameraHead,
    camera_tokens: torch.Tensor,
    image_hw: tuple[int, int],
    ref_idx: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """camera_tokens: ``[N, D]`` (final-norm camera token per view), run in f32.

    Returns ``(extrinsics [N, 3, 4] w2c, intrinsics [N, 3, 3])``.

    ``highest_precision`` holds only while this forward runs: its backward
    runs later, inside ``loss.backward()``, at whatever TF32 setting is then
    in force.  That is full f32 under torch's defaults (cuBLAS TF32 is off
    unless a caller turns it on; the head has no convolution).
    """
    x = camera_tokens.float()
    h = F.gelu(F.linear(x, head.mlp.fc1.weight, head.mlp.fc1.bias), approximate="tanh")
    h = F.gelu(F.linear(h, head.mlp.fc2.weight, head.mlp.fc2.bias), approximate="tanh")
    out = F.linear(h, head.out.weight, head.out.bias)

    quat, trans, log_f, pp_off = out[:, 0:4], out[:, 4:7], out[:, 7:9], out[:, 9:11]
    E_raw = torch.cat([quat_to_rotmat(quat), trans[:, :, None]], dim=-1)  # [N, 3, 4] w2c
    # the reference view becomes the world frame: E_i' = E_i ∘ E_ref^{-1}
    extrinsics = se3_compose(E_raw, se3_inverse(E_raw[ref_idx])[None])

    H, W = image_hw
    size = float(max(H, W))
    fx = torch.exp(log_f[:, 0]) * size
    fy = torch.exp(log_f[:, 1]) * size
    cx = (0.5 + 0.1 * torch.tanh(pp_off[:, 0])) * W
    cy = (0.5 + 0.1 * torch.tanh(pp_off[:, 1])) * H
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    K = torch.stack([
        torch.stack([fx, zeros, cx], -1),
        torch.stack([zeros, fy, cy], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)
    return extrinsics, K
