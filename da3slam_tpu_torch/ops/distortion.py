"""Lens distortion models and iterative undistortion (counterpart of
``da3slam_tpu/ops/distortion.py``).

Polynomial radial models (1-2 coefficients) and the 4-parameter OpenCV model
(radial + tangential) on normalised image coordinates (pre-intrinsics),
batched over any leading dims.  Undistortion is a fixed number of Newton
steps with the map's closed-form 2×2 Jacobian, all points at once; no step
reads back to the host.
"""

from __future__ import annotations

import torch


def _coefficients(params: torch.Tensor):
    """``params [..., n]`` → (k1, k2, p1, p2); absent terms are 0."""
    n = params.shape[-1]
    k1 = params[..., 0]
    zero = torch.zeros_like(k1)
    k2 = params[..., 1] if n >= 2 else zero
    p1, p2 = (params[..., 2], params[..., 3]) if n >= 4 else (zero, zero)
    return k1, k2, p1, p2, n >= 4


def apply_distortion(uv: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Distort normalised coords ``[..., 2]``.

    ``params``: 1 (k1), 2 (k1, k2) → radial; 4 (k1, k2, p1, p2) → OpenCV.
    """
    u, v = uv[..., 0], uv[..., 1]
    k1, k2, p1, p2, tangential = _coefficients(params)
    r2 = u * u + v * v
    radial = 1.0 + r2 * (k1 + r2 * k2)
    du, dv = u * radial, v * radial
    if tangential:
        du = du + (2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u))
        dv = dv + (p1 * (r2 + 2.0 * v * v) + 2.0 * p2 * u * v)
    return torch.stack([du, dv], dim=-1)


def _jacobian(uv: torch.Tensor, params: torch.Tensor):
    """The four entries of ∂ apply_distortion / ∂ uv at ``uv [..., 2]``."""
    u, v = uv[..., 0], uv[..., 1]
    k1, k2, p1, p2, _ = _coefficients(params)
    r2 = u * u + v * v
    radial = 1.0 + r2 * (k1 + r2 * k2)
    d_radial = 2.0 * (k1 + 2.0 * r2 * k2)  # ∂radial/∂u = d_radial·u
    j00 = radial + d_radial * u * u + 2.0 * p1 * v + 6.0 * p2 * u
    j01 = d_radial * u * v + 2.0 * p1 * u + 2.0 * p2 * v
    j10 = d_radial * u * v + 2.0 * p1 * u + 2.0 * p2 * v
    j11 = radial + d_radial * v * v + 6.0 * p1 * v + 2.0 * p2 * u
    return j00, j01, j10, j11


def undistort_points(
    uv_observed: torch.Tensor,
    params: torch.Tensor,
    max_iterations: int = 10,
) -> torch.Tensor:
    """Invert :func:`apply_distortion` by ``max_iterations`` Newton steps
    from ``uv_observed``, each a closed-form 2×2 solve whose determinant is
    held off 0 (``|det| < 1e-12`` → 1e-12)."""
    x = uv_observed
    for _ in range(max_iterations):
        r = apply_distortion(x, params) - uv_observed
        j00, j01, j10, j11 = _jacobian(x, params)
        det = j00 * j11 - j01 * j10
        det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
        dx = torch.stack([(j11 * r[..., 0] - j01 * r[..., 1]) / det,
                          (-j10 * r[..., 0] + j00 * r[..., 1]) / det], dim=-1)
        x = x - dx
    return x


def distort_pixels(pixels: torch.Tensor, K: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Distort pixel coordinates: pixels → normalised → distort → pixels."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    norm = torch.stack([(pixels[..., 0] - cx) / fx, (pixels[..., 1] - cy) / fy], dim=-1)
    d = apply_distortion(norm, params)
    return torch.stack([d[..., 0] * fx + cx, d[..., 1] * fy + cy], dim=-1)
