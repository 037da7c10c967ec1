"""SE(3) / Sim(3) transform algebra on batched torch tensors (counterpart of
``da3slam_tpu/core/transforms.py``; the subset the SLAM, loop-closure,
streaming and 3DGS paths use).

Conventions:
  * extrinsics are world-to-camera (w2c) ``[..., 3, 4]`` in OpenCV convention
  * a Sim(3) is the triple ``(s, R, t)`` acting as ``p' = s * R @ p + t``

Everything is shape-polymorphic over leading batch dims, runs on the
tensors' own device, and never synchronises with the host.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch


@contextlib.contextmanager
def highest_precision():
    """Full-f32 matmuls and convolutions on the card: TF32 off for cuBLAS
    *and* cuDNN while active (restored on exit).  Pose math and registration
    solves wear it (``@highest_precision()``); the model forward does not."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Sim3(NamedTuple):
    """Similarity transform p' = s * R @ p + t (batch dims allowed)."""

    s: torch.Tensor  # [...]
    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]


def se3_to_4x4(E: torch.Tensor) -> torch.Tensor:
    """Promote ``[..., 3, 4]`` w2c to homogeneous ``[..., 4, 4]``."""
    bottom = torch.zeros(E.shape[:-2] + (1, 4), dtype=E.dtype, device=E.device)
    bottom[..., 0, 3].fill_(1.0)  # a fill kernel; `= 1.0` would copy from the host
    return torch.cat([E, bottom], dim=-2)


def se3_from_4x4(E: torch.Tensor) -> torch.Tensor:
    """Truncate homogeneous ``[..., 4, 4]`` to ``[..., 3, 4]``."""
    return E[..., :3, :4]


def se3_inverse(E: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform; ``[..., 3, 4]`` or
    ``[..., 4, 4]`` in, the same shape out."""
    R = E[..., :3, :3]
    t = E[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -(Rt @ t[..., None])[..., 0]
    out = torch.cat([Rt, t_inv[..., None]], dim=-1)
    if E.shape[-2] == 4:
        out = se3_to_4x4(out)
    return out


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Compose two ``[..., 3, 4]`` rigid transforms: result = A @ B (as 4x4s)."""
    Ra, ta = A[..., :3, :3], A[..., :3, 3]
    Rb, tb = B[..., :3, :3], B[..., :3, 3]
    R = Ra @ Rb
    t = (Ra @ tb[..., None])[..., 0] + ta
    return torch.cat([R, t[..., None]], dim=-1)


_POLAR_STEPS = 8


def orthonormalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project near-rotation matrices ``[..., 3, 3]`` (det > 0) onto SO(3).

    Newton's iteration for the polar factor with determinant scaling,
    X ← (γX + (γX)^{-T}) / 2 with γ = |det X|^{-1/3} and the
    inverse-transpose from cofactors (cross products of the columns).  For
    det > 0 the polar factor is the SVD projection U·Vᵀ the JAX package
    computes; unlike ``torch.linalg.svd`` on CUDA, whose error check waits
    for the device, it never synchronises with the host.  The scaling
    makes the step count independent of conditioning: the ICP update
    I + [ω]× (singular values 1 and √(1+|ω|²)) reaches f32 precision in 6
    steps for any |ω| that f32 resolves against the identity (≲ 1e6).
    """
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


def sim3_compose(A: Sim3, B: Sim3) -> Sim3:
    """T = A ∘ B so that ``T(p) = A(B(p))``:
    (sA sB) (RA RB) p + (sA RA tB + tA)."""
    s = A.s * B.s
    R = A.R @ B.R
    t = A.s[..., None] * (A.R @ B.t[..., None])[..., 0] + A.t
    return Sim3(s, R, t)


def sim3_inverse(T: Sim3) -> Sim3:
    """Inverse: p = (1/s) R^T (p' - t)."""
    s_inv = 1.0 / T.s
    Rt = T.R.transpose(-1, -2)
    t_inv = -s_inv[..., None] * (Rt @ T.t[..., None])[..., 0]
    return Sim3(s_inv, Rt, t_inv)


def sim3_identity(dtype=torch.float32, device=None) -> Sim3:
    return Sim3(torch.ones((), dtype=dtype, device=device),
                torch.eye(3, dtype=dtype, device=device),
                torch.zeros(3, dtype=dtype, device=device))


def sim3_apply(T: Sim3, points: torch.Tensor) -> torch.Tensor:
    """Apply ``p' = s * R p + t`` to ``[..., N, 3]`` points (an unbatched Sim3
    takes any leading shape; a batched one needs matching leading dims)."""
    rotated = points @ T.R.transpose(-1, -2)
    return T.s[..., None, None] * rotated + T.t[..., None, :]


def sim3_accumulate(transforms: Sim3) -> Sim3:
    """Prefix-compose a stacked ``[K]`` Sim3 whose entry k maps chunk k+1 into
    chunk k; entry k of the ``[K+1]`` result maps chunk k into chunk 0 (entry 0
    the identity).  A sequential prefix product: the JAX package's
    ``associative_scan`` composes the same products in a tree order, which
    differs in f32 rounding only."""
    acc = [sim3_identity(transforms.R.dtype, transforms.R.device)]
    for k in range(transforms.s.shape[0]):
        acc.append(sim3_compose(acc[-1], Sim3(transforms.s[k], transforms.R[k], transforms.t[k])))
    return Sim3(*(torch.stack(parts) for parts in zip(*acc)))


def sim3_to_matrix(T: Sim3) -> torch.Tensor:
    """``[..., 4, 4]`` matrix with upper-left ``s*R`` and translation ``t``."""
    top = torch.cat([T.s[..., None, None] * T.R, T.t[..., None]], dim=-1)
    return se3_to_4x4(top)


def sim3_transform_w2c(E: torch.Tensor, T: Sim3) -> torch.Tensor:
    """Re-express w2c extrinsics ``[..., 3|4, 4]`` under a Sim(3) change of
    world frame (``T`` maps current world coordinates into reference ones):
    ``w2c_ref = w2c_cur @ [(1/s) R^T | -(1/s) R^T t]``, as ``[..., 3, 4]``."""
    Tinv = sim3_inverse(T)
    M = torch.cat([Tinv.s[..., None, None] * Tinv.R, Tinv.t[..., None]], dim=-1)
    E44 = se3_to_4x4(E) if E.shape[-2] == 3 else E
    return (E44 @ se3_to_4x4(M))[..., :3, :4]


def _skew(w: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` → the cross-product matrix ``[..., 3, 3]``."""
    x, y, z = w.unbind(-1)
    zeros = torch.zeros_like(x)
    return torch.stack([torch.stack([zeros, -z, y], -1),
                        torch.stack([z, zeros, -x], -1),
                        torch.stack([-y, x, zeros], -1)], dim=-2)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rotation vector ``[..., 3]`` → rotation matrix (Rodrigues), with the
    first-order form ``I + [ω]×`` below 1e-6 rad."""
    theta = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
    small = theta < 1e-6
    K = _skew(omega / torch.where(small, torch.ones_like(theta), theta))
    th = theta[..., None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    R_full = eye + torch.sin(th) * K + (1 - torch.cos(th)) * (K @ K)
    return torch.where(small[..., None], eye + _skew(omega), R_full)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → rotation vector ``[..., 3]`` of angle in [0, π].

    Double ``where``: near the identity ``arccos`` is fed a safe 0, so the
    derivative of the discarded branch (-1/√(1-x²) = -inf at x = 1) never
    meets a zero cotangent (0 · inf = NaN) under ``jacfwd`` or autograd."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1) / 2, -1.0, 1.0)
    # θ ≲ 4.5e-4; the threshold must be representable in f32
    small = cos_theta > 1.0 - 1e-7
    theta = torch.arccos(torch.where(small, torch.zeros_like(cos_theta), cos_theta))
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    factor = torch.where(small, torch.full_like(theta, 0.5),
                         theta / torch.clamp_min(2 * torch.sin(theta), 1e-12))
    return factor[..., None] * vee


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit-norm-insensitive quaternion (w, x, y, z) ``[..., 4]`` → ``[..., 3, 3]``."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-8)
    w, x, y, z = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def abs_t_quat_fov_to_camera(pose: torch.Tensor, hw: tuple[int, int]
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """VGGT's ``absT_quaR_FoV`` pose encoding ``[..., 9]`` = (T, q, FoV) →
    (w2c ``[..., 3, 4]`` = [R(q) | T], intrinsics ``[..., 3, 3]``).

    q = pose[3:7] is scalar-last; the fields of view (h, w) = ReLU(pose[7:9])
    (VGGT's ``fl_act``) give f_y = (H/2) / tan(FoV_h/2), f_x = (W/2) /
    tan(FoV_w/2); the principal point is the image centre."""
    H, W = hw
    fov = torch.relu(pose[..., 7:9])
    R = quat_to_rotmat(torch.cat([pose[..., 6:7], pose[..., 3:6]], dim=-1))  # to (w, x, y, z)
    E = torch.cat([R, pose[..., 0:3, None]], dim=-1)
    fy = (H / 2.0) / torch.tan(fov[..., 0] / 2.0)
    fx = (W / 2.0) / torch.tan(fov[..., 1] / 2.0)
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([
        torch.stack([fx, zeros, ones * (W / 2.0)], -1),
        torch.stack([zeros, fy, ones * (H / 2.0)], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)
    return E, K


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3]`` → quaternion (w, x, y, z), branch-free: the four
    Shepperd candidates, the best-conditioned one picked by ``argmax``, the
    sign fixed so that w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    lead = [1 + tr, 1 + m00 - m11 - m22, 1 + m11 - m00 - m22, 1 + m22 - m00 - m11]
    root = [torch.sqrt(torch.clamp_min(x, 1e-12)) for x in lead]
    qw = torch.stack([root[0] / 2, (m21 - m12) / (2 * root[1]),
                      (m02 - m20) / (2 * root[2]), (m10 - m01) / (2 * root[3])], -1)
    qx = torch.stack([(m21 - m12) / (2 * root[0]), root[1] / 2,
                      (m01 + m10) / (2 * root[2]), (m02 + m20) / (2 * root[3])], -1)
    qy = torch.stack([(m02 - m20) / (2 * root[0]), (m01 + m10) / (2 * root[1]),
                      root[2] / 2, (m12 + m21) / (2 * root[3])], -1)
    qz = torch.stack([(m10 - m01) / (2 * root[0]), (m02 + m20) / (2 * root[1]),
                      (m12 + m21) / (2 * root[2]), root[3] / 2], -1)
    idx = torch.argmax(torch.stack(lead, -1), dim=-1)
    q = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4 components, 4 candidates]
    q = torch.gather(q, -1, idx[..., None, None].expand(*idx.shape, 4, 1))[..., 0]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def slerp_rotations(Ra: torch.Tensor, Rb: torch.Tensor, t: float | torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between rotation matrices ``[..., 3, 3]``
    (shortest arc, through quaternions; t=0 → Ra, t=1 → Rb)."""
    qa, qb = rotmat_to_quat(Ra), rotmat_to_quat(Rb)
    dot = torch.sum(qa * qb, dim=-1, keepdim=True)
    qb = torch.where(dot < 0, -qb, qb)  # shortest arc
    dot = torch.clamp_max(torch.abs(dot), 1.0)
    theta = torch.arccos(dot)
    sin_t = torch.sin(theta)
    # lerp where the two are nearly parallel (sin underflows)
    wa = torch.where(sin_t > 1e-6, torch.sin((1 - t) * theta) / sin_t, 1 - t)
    wb = torch.where(sin_t > 1e-6, torch.sin(t * theta) / sin_t, t)
    return quat_to_rotmat(wa * qa + wb * qb)
