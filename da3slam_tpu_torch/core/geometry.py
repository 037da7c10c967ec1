"""Pinhole camera geometry: backprojection, projection and the depth-scale
median (counterpart of ``da3slam_tpu/core/geometry.py``), and the median as
numpy and JAX define it.

Pixel convention: ``u`` is the column index, ``v`` the row index, rays are
``K^-1 @ [u, v, 1]`` (no half-pixel offset).
"""

from __future__ import annotations

import torch

from da3slam_tpu_torch.core.transforms import highest_precision, se3_inverse


def pixel_grid(H: int, W: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel coordinates ``[H, W, 3]`` = (u, v, 1)."""
    v, u = torch.meshgrid(
        torch.arange(H, dtype=dtype, device=device),
        torch.arange(W, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([u, v, torch.ones_like(u)], dim=-1)


def _invert_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a zero-skew pinhole matrix ``[..., 3, 3]``."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    row0 = torch.stack([1.0 / fx, zeros, -cx / fx], -1)
    row1 = torch.stack([zeros, 1.0 / fy, -cy / fy], -1)
    row2 = torch.stack([zeros, zeros, ones], -1)
    return torch.stack([row0, row1, row2], dim=-2)


@highest_precision()
def backproject_depth(
    depth: torch.Tensor, K: torch.Tensor, extrinsics: torch.Tensor | None = None
) -> torch.Tensor:
    """Depth maps ``[..., H, W]`` → point maps ``[..., H, W, 3]``: camera
    coordinates, or world coordinates when w2c ``extrinsics`` are given."""
    H, W = depth.shape[-2], depth.shape[-1]
    pix = pixel_grid(H, W, depth.dtype, depth.device)
    Kinv = _invert_intrinsics(K)
    rays = torch.einsum("...ij,hwj->...hwi", Kinv, pix)
    cam = rays * depth[..., None]
    if extrinsics is None:
        return cam
    c2w = se3_inverse(extrinsics)
    Rw, tw = c2w[..., :3, :3], c2w[..., :3, 3]
    return torch.einsum("...ij,...hwj->...hwi", Rw, cam) + tw[..., None, None, :]


@highest_precision()
def project_points(
    points: torch.Tensor,
    K: torch.Tensor,
    extrinsics: torch.Tensor | None = None,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """3-D points ``[..., N, 3]`` (world coordinates, or camera coordinates
    without w2c ``extrinsics [..., 3, 4]``) → ``(uv [..., N, 2], z [..., N])``
    through ``K [..., 3, 3]``; the inverse of ``backproject_depth``."""
    if extrinsics is not None:
        R, t = extrinsics[..., :3, :3], extrinsics[..., :3, 3]
        cam = points @ R.transpose(-1, -2) + t[..., None, :]
    else:
        cam = points
    z = cam[..., 2]
    xy = cam[..., :2] / torch.clamp_min(z[..., None], eps)
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    u = fx[..., None] * xy[..., 0] + cx[..., None]
    v = fy[..., None] * xy[..., 1] + cy[..., None]
    return torch.stack([u, v], dim=-1), z


def normalize_pixel_tracks(
    tracks: torch.Tensor, hw: tuple[int, int], mode: str = "minus_one_to_one"
) -> torch.Tensor:
    """Pixel-coordinate tracks ``[..., 2]`` to a canonical range: ``[-1, 1]``
    with the corner pixels at the ends ("minus_one_to_one") or ``[0, 1]``
    ("zero_to_one")."""
    H, W = hw
    size = torch.tensor([W - 1.0, H - 1.0], dtype=tracks.dtype, device=tracks.device)
    unit = tracks / size
    if mode == "zero_to_one":
        return unit
    if mode == "minus_one_to_one":
        return unit * 2.0 - 1.0
    raise ValueError(f"unknown mode {mode!r}")


def denormalize_pixel_tracks(
    tracks: torch.Tensor, hw: tuple[int, int], mode: str = "minus_one_to_one"
) -> torch.Tensor:
    """Inverse of :func:`normalize_pixel_tracks`."""
    H, W = hw
    size = torch.tensor([W - 1.0, H - 1.0], dtype=tracks.dtype, device=tracks.device)
    if mode == "zero_to_one":
        return tracks * size
    if mode == "minus_one_to_one":
        return (tracks + 1.0) * 0.5 * size
    raise ValueError(f"unknown mode {mode!r}")


def depth_scale_ratio(
    depth_prev: torch.Tensor,
    depth_cur: torch.Tensor,
    conf_prev: torch.Tensor | None = None,
    conf_cur: torch.Tensor | None = None,
    conf_th: float = 0.2,
    min_points: int = 50,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Robust median depth-scale ``s`` with ``depth_prev ≈ s * depth_cur`` on
    confident pixels, as a 0-d tensor on the inputs' device (no host sync).

    The masked median sorts with invalid entries pushed to +inf and, for an
    even count, averages the two middle elements (``torch.median`` would
    return the lower one).  Fewer than ``min_points`` valid pairs, or a
    non-finite / non-positive median, give 1.0.
    """
    d_prev = depth_prev.reshape(-1)
    d_cur = depth_cur.reshape(-1)
    mask = (d_prev > eps) & (d_cur > eps) & torch.isfinite(d_prev) & torch.isfinite(d_cur)
    if conf_prev is not None and conf_cur is not None:
        mask &= (conf_prev.reshape(-1) > conf_th) & (conf_cur.reshape(-1) > conf_th)

    ratio = torch.where(mask, d_prev / d_cur.clamp_min(eps), torch.inf)
    n = ratio.shape[0]
    n_valid = mask.sum()
    sorted_ratio = torch.sort(ratio).values
    lo = torch.div(n_valid - 1, 2, rounding_mode="floor").clamp(0, n - 1)
    hi = torch.div(n_valid, 2, rounding_mode="floor").clamp(0, n - 1)
    mid = sorted_ratio.index_select(0, torch.stack([lo, hi]))  # tensor index: no host sync
    med = 0.5 * (mid[0] + mid[1])
    ok = (n_valid >= min_points) & torch.isfinite(med) & (med > 0)
    return torch.where(ok, med, torch.ones_like(med))


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of all elements, as ``jnp.median`` takes it: for an even count
    the mean of the two middle values (``torch.median`` returns the lower),
    and NaN if any element is NaN (``torch.sort`` puts NaN last).  No host
    wait, and no size limit (``torch.quantile`` refuses 2^24 elements)."""
    flat = x.reshape(-1)
    s = torch.sort(flat).values
    n = s.shape[0]
    med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
    return torch.where(torch.isnan(flat).any(), torch.nan, med)
