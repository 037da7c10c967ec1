"""Plain float32 single-overlap chunk alignment and pose chaining: the
benchmark's reference for the solver's global trajectory.

Frozen copy of ``da3slam_tpu_torch/slam/alignment.py`` (its ICP, SE(3)
path), ``ops/icp.py`` and the parts of ``core/geometry.py`` and
``core/transforms.py`` they use, at commit b277bb1, with the operations in
the same order so that the same inputs round alike (projective ICP rounds
pixel coordinates, so a last-bit difference can move an association).
Imports torch only; the caller sets the matmul precision: TF32 off for the
reference, on for its control.
"""

from __future__ import annotations

import torch

_POLAR_STEPS = 8


def se3_inverse(E):
    R = E[..., :3, :3]
    t = E[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -(Rt @ t[..., None])[..., 0]
    return torch.cat([Rt, t_inv[..., None]], dim=-1)


def se3_compose(A, B):
    Ra, ta = A[..., :3, :3], A[..., :3, 3]
    Rb, tb = B[..., :3, :3], B[..., :3, 3]
    R = Ra @ Rb
    t = (Ra @ tb[..., None])[..., 0] + ta
    return torch.cat([R, t[..., None]], dim=-1)


def orthonormalize_rotation(R):
    """Newton's polar iteration with determinant scaling (8 steps)."""
    X = R
    for _ in range(_POLAR_STEPS):
        c0, c1, c2 = X[..., :, 0], X[..., :, 1], X[..., :, 2]
        cof = torch.stack([torch.linalg.cross(c1, c2, dim=-1),
                           torch.linalg.cross(c2, c0, dim=-1),
                           torch.linalg.cross(c0, c1, dim=-1)], dim=-1)
        det = torch.sum(c0 * cof[..., :, 0], dim=-1)[..., None, None]
        gamma = det.abs().pow(-1.0 / 3.0)
        X = 0.5 * (gamma * X + cof / (gamma * det))
    return X


def pixel_grid(H, W, dtype, device):
    v, u = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device), indexing="ij")
    return torch.stack([u, v, torch.ones_like(u)], dim=-1)


def backproject_depth(depth, K):
    """Depth ``[H, W]`` → camera-frame point map ``[H, W, 3]``."""
    H, W = depth.shape[-2], depth.shape[-1]
    pix = pixel_grid(H, W, depth.dtype, depth.device)
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    Kinv = torch.stack([torch.stack([1.0 / fx, zeros, -cx / fx], -1),
                        torch.stack([zeros, 1.0 / fy, -cy / fy], -1),
                        torch.stack([zeros, zeros, ones], -1)], dim=-2)
    rays = torch.einsum("...ij,hwj->...hwi", Kinv, pix)
    return rays * depth[..., None]


def depth_scale_ratio(depth_prev, depth_cur, conf_prev, conf_cur, conf_th,
                      min_points: int = 50, eps: float = 1e-6):
    """Median of ``depth_prev / depth_cur`` over confident positive pairs (the
    mean of the two middle values for an even count); 1 below ``min_points``."""
    d_prev = depth_prev.reshape(-1)
    d_cur = depth_cur.reshape(-1)
    mask = (d_prev > eps) & (d_cur > eps) & torch.isfinite(d_prev) & torch.isfinite(d_cur)
    mask &= (conf_prev.reshape(-1) > conf_th) & (conf_cur.reshape(-1) > conf_th)
    ratio = torch.where(mask, d_prev / d_cur.clamp_min(eps), torch.inf)
    n = ratio.shape[0]
    n_valid = mask.sum()
    sorted_ratio = torch.sort(ratio).values
    lo = torch.div(n_valid - 1, 2, rounding_mode="floor").clamp(0, n - 1)
    hi = torch.div(n_valid, 2, rounding_mode="floor").clamp(0, n - 1)
    mid = sorted_ratio.index_select(0, torch.stack([lo, hi]))
    med = 0.5 * (mid[0] + mid[1])
    ok = (n_valid >= min_points) & torch.isfinite(med) & (med > 0)
    return torch.where(ok, med, torch.ones_like(med))


def estimate_normals(point_map):
    du = torch.roll(point_map, -1, dims=1) - torch.roll(point_map, 1, dims=1)
    dv = torch.roll(point_map, -1, dims=0) - torch.roll(point_map, 1, dims=0)
    n = torch.linalg.cross(du, dv, dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    flip = torch.sign(torch.sum(n * point_map, dim=-1, keepdim=True))
    return -n * torch.where(flip == 0, torch.ones_like(flip), flip)


def icp(src_points, tgt_point_map, tgt_K, src_valid, tgt_valid, threshold, max_iterations):
    """Projective-association point-to-plane ICP with a Huber weight, SE(3),
    from the identity.  Returns ``(R, t)`` with ``tgt ≈ R src + t``."""
    dev = src_points.device
    f32 = torch.float32
    src_valid = src_valid & torch.isfinite(src_points).all(-1)
    src = torch.where(src_valid[:, None], src_points, torch.zeros_like(src_points))
    tgt_map = torch.nan_to_num(tgt_point_map, nan=0.0, posinf=0.0, neginf=0.0)
    tgt_w = tgt_valid.to(f32)[..., None]
    fx, fy = tgt_K[0, 0], tgt_K[1, 1]
    cx, cy = tgt_K[0, 2], tgt_K[1, 2]
    H, W = tgt_map.shape[0], tgt_map.shape[1]
    stacked = torch.cat([tgt_map, estimate_normals(tgt_map), tgt_w], dim=-1).reshape(H * W, 7)

    def associate(s, R, t):
        p = s * (src @ R.T) + t
        z = p[..., 2].clamp_min(1e-8)
        u = fx * p[..., 0] / z + cx
        v = fy * p[..., 1] / z + cy
        ui = torch.round(u).long().clamp(0, W - 1)
        vi = torch.round(v).long().clamp(0, H - 1)
        in_bounds = (u >= -0.5) & (u <= W - 0.5) & (v >= -0.5) & (v <= H - 0.5)
        vals = stacked.index_select(0, vi * W + ui)
        q = vals[..., 0:3]
        nrm = vals[..., 3:6]
        nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True).clamp_min(1e-12)
        valid = (src_valid & in_bounds & (vals[..., 6] > 0.5) & (p[..., 2] > 0)).to(f32)
        return p, q, nrm, valid

    eye = torch.eye(6, dtype=f32, device=dev)
    s = torch.ones((), dtype=f32, device=dev)
    R = torch.eye(3, dtype=f32, device=dev)
    t = torch.zeros(3, dtype=f32, device=dev)
    for _ in range(max_iterations):
        p, q, nrm, valid = associate(s, R, t)
        r = torch.sum(nrm * (p - q), dim=-1)
        absr = r.abs()
        w = valid * torch.where(absr <= threshold, torch.ones_like(r),
                                threshold / absr.clamp_min(1e-12))
        A = torch.cat([torch.linalg.cross(p, nrm, dim=-1), nrm], dim=-1)
        Aw = A * w[:, None]
        xi = torch.linalg.solve_ex(Aw.T @ A + 1e-6 * eye, Aw.T @ (-r)).result
        sigma, omega, upd = torch.zeros((), dtype=f32, device=dev), xi[0:3], xi[3:6]
        zero = torch.zeros((), dtype=f32, device=dev)
        skew = torch.stack([
            torch.stack([zero, -omega[2], omega[1]]),
            torch.stack([omega[2], zero, -omega[0]]),
            torch.stack([-omega[1], omega[0], zero]),
        ])
        R_delta = orthonormalize_rotation(torch.eye(3, dtype=f32, device=dev) + skew)
        s_a = 1.0 + sigma
        s_new = s_a * s
        R_new = R_delta @ R
        t_new = s_a[..., None] * (R_delta @ t[..., None])[..., 0] + upd
        has_corr = torch.sum(w) >= 6.0
        s = torch.where(has_corr, s_new, s)
        R = torch.where(has_corr, R_new, R)
        t = torch.where(has_corr, t_new, t)
    return s, R, t


def align_chunk(prev_depth, prev_conf, prev_K, cur_depth, cur_conf, cur_K, cur_extrinsics,
                prev_overlap_global, anchor_idx: int, cfg: dict) -> torch.Tensor:
    """The current chunk's global w2c ``[N, 3, 4]``: depth scale on the overlap
    frame, ICP between the overlap frames' camera clouds, the anchor pose from
    the previous overlap pose (rotation re-projected onto SO(3)), the chunk
    chained around it.  ``cfg`` holds ``Align``'s keys."""
    st = max(int(cfg.get("icp_stride", 4)), 1)
    cur_anchor_depth = cur_depth[anchor_idx]
    cur_anchor_K = cur_K[anchor_idx]
    s_depth = depth_scale_ratio(prev_depth[::st, ::st], cur_anchor_depth[::st, ::st],
                                prev_conf[::st, ::st], cur_conf[anchor_idx][::st, ::st],
                                cfg["conf_threshold"])
    cur_extrinsics = torch.cat([cur_extrinsics[..., :3], cur_extrinsics[..., 3:] * s_depth], dim=-1)
    scaled_anchor_depth = cur_anchor_depth * s_depth
    tgt_map = backproject_depth(prev_depth, prev_K)
    src_map = backproject_depth(scaled_anchor_depth, cur_anchor_K)
    src_pts = src_map[::st, ::st].reshape(-1, 3)
    src_valid = scaled_anchor_depth[::st, ::st].reshape(-1) > 1e-6
    s, R, t = icp(src_pts, tgt_map, prev_K, src_valid, prev_depth > 1e-6,
                  cfg["icp_threshold"], cfg["icp_max_iterations"])
    s_inv = 1.0 / s
    Rt = R.transpose(-1, -2)
    t_inv = -s_inv[..., None] * (Rt @ t[..., None])[..., 0]
    Tinv_mat = torch.cat([s_inv * Rt, t_inv[:, None]], dim=-1)
    anchor = se3_compose(Tinv_mat, prev_overlap_global)
    anchor = torch.cat([orthonormalize_rotation(anchor[..., :3]), anchor[..., 3:]], dim=-1)
    rel = se3_compose(cur_extrinsics, se3_inverse(cur_extrinsics[anchor_idx])[None])
    return se3_compose(rel, anchor[None])
