"""Closed-form point-set registration (counterpart of
``da3slam_tpu/ops/registration.py:weighted_umeyama``; ``irls_sim3`` is not
ported yet)."""

from __future__ import annotations

import torch

from da3slam_tpu_torch.core.transforms import Sim3, highest_precision


@highest_precision()
def weighted_umeyama(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: torch.Tensor,
    with_scale: bool = True,
    eps: float = 1e-8,
) -> Sim3:
    """Closed-form weighted Sim(3)/SE(3) ``dst ≈ s R src + t`` over ``[N, 3]``
    correspondences with ``[N]`` non-negative weights (zeros drop points),
    with the det-reflection fix."""
    w = weights.to(torch.float32)
    w = w / (torch.sum(w) + eps)

    mu_src = torch.sum(src * w[:, None], dim=0)
    mu_dst = torch.sum(dst * w[:, None], dim=0)
    X = src - mu_src
    Y = dst - mu_dst

    Sigma = (Y * w[:, None]).T @ X  # [3, 3]
    U, S, Vh = torch.linalg.svd(Sigma)
    det = torch.linalg.det(U @ Vh)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), torch.sign(det)])
    R = (U * d[None, :]) @ Vh

    if with_scale:
        var_src = torch.sum(w * torch.sum(X * X, dim=1))
        s = torch.sum(S * d) / (var_src + eps)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)

    t = mu_dst - s * (R @ mu_src)
    return Sim3(s, R, t)
