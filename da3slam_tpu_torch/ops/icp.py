"""ICP via projective data association (counterpart of ``da3slam_tpu/ops/icp.py``).

Both clouds in the SLAM overlap step come from depth maps of near-identical
viewpoints, so correspondences are found by projecting the moving cloud into
the target camera and reading the target's point map at that pixel
(KinectFusion-style).  Each iteration: associate (project + one gather) →
Huber-weighted point-to-plane Gauss-Newton step.  Fixed iteration count, no
data-dependent control flow, so nothing synchronises with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from da3slam_tpu_torch.core.transforms import (
    Sim3,
    highest_precision,
    orthonormalize_rotation,
    sim3_compose,
)


class ICPResult(NamedTuple):
    transform: Sim3  # maps source points into the target frame
    fitness: torch.Tensor  # inlier fraction of valid source points (Open3D-style)
    inlier_rmse: torch.Tensor  # RMS distance over inliers


def estimate_normals(point_map: torch.Tensor) -> torch.Tensor:
    """Per-pixel normals of an organised ``[H, W, 3]`` point map, from central
    differences along the pixel grid, oriented towards the camera."""
    du = torch.roll(point_map, -1, dims=1) - torch.roll(point_map, 1, dims=1)
    dv = torch.roll(point_map, -1, dims=0) - torch.roll(point_map, 1, dims=0)
    n = torch.linalg.cross(du, dv, dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    # orient towards the camera at the origin: n · p must be negative
    flip = torch.sign(torch.sum(n * point_map, dim=-1, keepdim=True))
    return -n * torch.where(flip == 0, torch.ones_like(flip), flip)


def bilinear_gather(point_map: torch.Tensor, uv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinearly sample a ``[H, W, C]`` map at continuous pixel coordinates
    ``[N, 2]`` (u = column, v = row).  Returns ``(values [N, C], in_bounds
    [N])``: a coordinate within half a pixel of the border counts as inside
    and reads the clamped edge; farther out ``in_bounds`` is False (the
    values are still the clamped edge's, as in the JAX package)."""
    H, W = point_map.shape[0], point_map.shape[1]
    u, v = uv[..., 0], uv[..., 1]
    # half-pixel slop so border pixels survive f32 projection round-trip noise
    in_bounds = (u >= -0.5) & (u <= W - 0.5) & (v >= -0.5) & (v <= H - 0.5)
    u = u.clamp(0.0, W - 1.0)
    v = v.clamp(0.0, H - 1.0)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = (u0 + 1).clamp_max(W - 1)
    v1 = (v0 + 1).clamp_max(H - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    top = point_map[v0, u0] * (1 - fu) + point_map[v0, u1] * fu
    bot = point_map[v1, u0] * (1 - fu) + point_map[v1, u1] * fu
    return top * (1 - fv) + bot * fv, in_bounds


@highest_precision()
def icp_point_to_point(
    src_points: torch.Tensor,
    tgt_point_map: torch.Tensor,
    tgt_K: torch.Tensor,
    src_valid: torch.Tensor | None = None,
    tgt_valid: torch.Tensor | None = None,
    threshold: float = 0.1,
    max_iterations: int = 50,
    with_scale: bool = False,
) -> ICPResult:
    """Align ``src_points`` ``[N, 3]`` onto the cloud behind ``tgt_point_map``
    ``[H, W, 3]`` (camera coords, intrinsics ``tgt_K``), from the identity.

    Returns ``ICPResult`` with ``transform`` s.t. ``tgt ≈ s R src + t``.
    """
    dev = src_points.device
    f32 = torch.float32
    n = src_points.shape[0]
    if src_valid is None:
        src_valid = torch.ones(n, dtype=torch.bool, device=dev)
    src_valid = src_valid & torch.isfinite(src_points).all(-1)
    src = torch.where(src_valid[:, None], src_points, torch.zeros_like(src_points))

    tgt_map = torch.nan_to_num(tgt_point_map, nan=0.0, posinf=0.0, neginf=0.0)
    if tgt_valid is None:
        tgt_valid = torch.isfinite(tgt_point_map).all(-1) & (tgt_point_map[..., 2] > 0)
    tgt_w = tgt_valid.to(f32)[..., None]

    fx, fy = tgt_K[0, 0], tgt_K[1, 1]
    cx, cy = tgt_K[0, 2], tgt_K[1, 2]
    tgt_normals = estimate_normals(tgt_map)
    H, W = tgt_map.shape[0], tgt_map.shape[1]
    # one stacked [point(3) | normal(3) | validity(1)] map, so each
    # association is a single gather
    stacked = torch.cat([tgt_map, tgt_normals, tgt_w], dim=-1).reshape(H * W, 7)

    def associate(T: Sim3):
        p = T.s * (src @ T.R.T) + T.t  # moved source
        z = p[..., 2].clamp_min(1e-8)
        u = fx * p[..., 0] / z + cx
        v = fy * p[..., 1] / z + cy
        # nearest pixel (round half to even, as jnp.round)
        ui = torch.round(u).long().clamp(0, W - 1)
        vi = torch.round(v).long().clamp(0, H - 1)
        in_bounds = (u >= -0.5) & (u <= W - 0.5) & (v >= -0.5) & (v <= H - 0.5)
        vals = stacked.index_select(0, vi * W + ui)  # [N, 7]
        q = vals[..., 0:3]
        nrm = vals[..., 3:6]
        nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True).clamp_min(1e-12)
        tgt_ok = vals[..., 6] > 0.5
        dist = torch.linalg.vector_norm(p - q, dim=-1)
        valid = (src_valid & in_bounds & tgt_ok & (p[..., 2] > 0)).to(f32)
        return p, q, nrm, dist, valid

    n_params = 7 if with_scale else 6
    eye = torch.eye(n_params, dtype=f32, device=dev)
    T = Sim3(torch.ones((), dtype=f32, device=dev), torch.eye(3, dtype=f32, device=dev),
             torch.zeros(3, dtype=f32, device=dev))
    for _ in range(max_iterations):
        # point-to-plane Gauss-Newton step with a Huber weight on the residual
        p, q, nrm, dist, valid = associate(T)
        r = torch.sum(nrm * (p - q), dim=-1)
        absr = r.abs()
        w = valid * torch.where(absr <= threshold, torch.ones_like(r),
                                threshold / absr.clamp_min(1e-12))
        # jacobian rows of r wrt the twist [σ?, ω, u]: δr = n·(σ p + ω×p + u)
        cross_pn = torch.linalg.cross(p, nrm, dim=-1)
        if with_scale:
            A = torch.cat([torch.sum(nrm * p, -1, keepdim=True), cross_pn, nrm], dim=-1)
        else:
            A = torch.cat([cross_pn, nrm], dim=-1)
        Aw = A * w[:, None]
        Hm = Aw.T @ A + 1e-6 * eye
        g = Aw.T @ (-r)
        xi = torch.linalg.solve_ex(Hm, g).result  # no error check: no host sync
        if with_scale:
            sigma, omega, upd = xi[0], xi[1:4], xi[4:7]
        else:
            sigma, omega, upd = torch.zeros((), dtype=f32, device=dev), xi[0:3], xi[3:6]
        zero = torch.zeros((), dtype=f32, device=dev)
        skew = torch.stack([
            torch.stack([zero, -omega[2], omega[1]]),
            torch.stack([omega[2], zero, -omega[0]]),
            torch.stack([-omega[1], omega[0], zero]),
        ])
        R_delta = orthonormalize_rotation(torch.eye(3, dtype=f32, device=dev) + skew)
        T_new = sim3_compose(Sim3(1.0 + sigma, R_delta, upd), T)
        has_corr = torch.sum(w) >= float(n_params)
        T = Sim3(
            torch.where(has_corr, T_new.s, T.s),
            torch.where(has_corr, T_new.R, T.R),
            torch.where(has_corr, T_new.t, T.t),
        )

    _, _, _, dist, valid = associate(T)
    w = valid * (dist < threshold)  # hard gate for Open3D-style diagnostics
    n_src = torch.sum(src_valid.to(f32)).clamp_min(1.0)
    n_inlier = torch.sum(w)
    fitness = n_inlier / n_src
    inlier_rmse = torch.sqrt(torch.sum(w * dist**2) / n_inlier.clamp_min(1.0))
    return ICPResult(T, fitness, inlier_rmse)
