"""Camera head: per-view pose (w2c) + pinhole intrinsics from camera tokens,
and poses recovered from the DPT head's ray maps (counterpart of
``da3slam_tpu/models/camera.py``).

Extrinsics ``[N, 3, 4]`` are w2c, OpenCV convention, local to the chunk with
the reference view at the identity; intrinsics ``[N, 3, 3]`` are zero-skew,
in pixels of the processed resolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from da3slam_tpu_torch.core.geometry import pixel_grid
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


@highest_precision()
def pose_from_rays(
    rays: torch.Tensor, K: torch.Tensor, stride: int = 8, eps: float = 1e-6
) -> torch.Tensor:
    """Recover per-view w2c extrinsics ``[N, 3, 4]`` from predicted Plücker ray
    maps ``rays [N, H, W, 6]`` and intrinsics ``K [N, 3, 3]``.

    Every pixel predicts its viewing ray in the chunk frame as ``(d, m)``
    with unit direction ``d`` and moment ``m = c × d`` (``c`` the camera
    centre).  Then:

      * centre: least squares over the rays,
        ``Σ (I − d dᵀ) c = Σ d × m``  (a 3×3 solve per view)
      * rotation: Kabsch between the canonical camera-frame pixel rays
        ``K⁻¹ [u, v, 1]`` and the predicted world directions → R_c2w, with
        the reflection fix (the last singular direction's sign set to
        ``det(U Vᵀ)``).
    """
    N, H, W, _ = rays.shape
    d = rays[:, ::stride, ::stride, 0:3].reshape(N, -1, 3)
    m = rays[:, ::stride, ::stride, 3:6].reshape(N, -1, 3)
    eye = torch.eye(3, dtype=rays.dtype, device=rays.device)

    A = torch.sum(eye - d[..., :, None] * d[..., None, :], dim=1) + eps * eye  # [N, 3, 3]
    b = torch.sum(torch.linalg.cross(d, m, dim=-1), dim=1)  # [N, 3]
    c = torch.linalg.solve(A, b[..., None])[..., 0]

    # canonical camera rays at the same strided pixels
    pix = pixel_grid(H, W, rays.dtype, rays.device)[::stride, ::stride].reshape(-1, 3)  # [P, 3]
    fx, fy = K[:, 0, 0], K[:, 1, 1]
    cx, cy = K[:, 0, 2], K[:, 1, 2]
    r = torch.stack([
        (pix[None, :, 0] - cx[:, None]) / fx[:, None],
        (pix[None, :, 1] - cy[:, None]) / fy[:, None],
        torch.ones(N, pix.shape[0], dtype=rays.dtype, device=rays.device),
    ], dim=-1)
    r = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp_min(eps)

    # Kabsch per view: world dirs = R_c2w @ cam dirs
    Sigma = torch.einsum("npi,npj->nij", d, r)
    U, _, Vh = torch.linalg.svd(Sigma)
    det = torch.linalg.det(U @ Vh)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R_w2c = ((U * D[:, None, :]) @ Vh).transpose(-1, -2)
    t = -(R_w2c @ c[..., None])[..., 0]
    return torch.cat([R_w2c, t[..., None]], dim=-1)


def rays_from_pose(
    extrinsics: torch.Tensor, K: torch.Tensor, hw: tuple[int, int]
) -> torch.Tensor:
    """Inverse of :func:`pose_from_rays`, for testing and supervision: the
    exact Plücker ray map ``[N, H, W, 6]`` of given w2c poses."""
    H, W = hw
    pix = pixel_grid(H, W, extrinsics.dtype, extrinsics.device)  # [H, W, 3]
    Kinv_ray = torch.einsum("nij,hwj->nhwi", torch.linalg.inv(K), pix)
    c2w = se3_inverse(extrinsics)
    d = torch.einsum("nij,nhwj->nhwi", c2w[:, :3, :3], Kinv_ray)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)
    c = c2w[:, :3, 3]
    m = torch.linalg.cross(c[:, None, None].expand_as(d), d, dim=-1)
    return torch.cat([d, m], dim=-1)


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
