"""SE(3) / Sim(3) transform algebra on batched torch tensors (counterpart of
``da3slam_tpu/core/transforms.py``; the subset the SLAM main path uses).

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


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit-norm-insensitive quaternion (w, x, y, z) ``[..., 4]`` → ``[..., 3, 3]``."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-8)
    w, x, y, z = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)
