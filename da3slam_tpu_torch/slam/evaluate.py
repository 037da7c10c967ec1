"""Trajectory + depth evaluation: ATE/RPE and the Eigen depth metrics
(counterpart of ``da3slam_tpu/slam/evaluate.py``).

Absolute trajectory error after optional Sim(3)/SE(3) alignment (monocular
trajectories are scale-ambiguous: Sim(3) alignment is the standard
protocol), relative pose error over a frame delta, and the standard
monocular depth metrics (AbsRel/RMSE/δ) with per-frame median scaling.  The
metrics are numpy in f64; the one alignment (``ops/registration.py:umeyama``)
runs in f32 on ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from da3slam_tpu_torch.ops.registration import umeyama


class TrajectoryErrors(NamedTuple):
    ate_rmse: float
    ate_mean: float
    ate_median: float
    rpe_trans_rmse: float
    rpe_rot_deg_rmse: float
    scale: float  # Sim(3) alignment scale applied to the estimate


def _centers(poses_c2w: np.ndarray) -> np.ndarray:
    return np.asarray(poses_c2w)[:, :3, 3]


def evaluate_trajectory(
    est_c2w: np.ndarray,
    gt_c2w: np.ndarray,
    align: str = "sim3",
    rpe_delta: int = 1,
    device: str | torch.device = "cuda",
) -> TrajectoryErrors:
    """Compare two ``[N, 4, 4]`` c2w trajectories.

    align: "sim3" (scale+rigid, the monocular protocol), "se3", or "none".
    """
    est = np.asarray(est_c2w, np.float64)
    gt = np.asarray(gt_c2w, np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"trajectory shapes differ: {est.shape} vs {gt.shape}")

    p_est, p_gt = _centers(est), _centers(gt)
    s, R, t = 1.0, np.eye(3), np.zeros(3)
    if align != "none":
        T = umeyama(
            torch.as_tensor(p_est, dtype=torch.float32, device=device),
            torch.as_tensor(p_gt, dtype=torch.float32, device=device),
            with_scale=(align == "sim3"),
        )
        s, R, t = float(T.s), T.R.cpu().double().numpy(), T.t.cpu().double().numpy()

    p_al = s * (p_est @ R.T) + t
    err = np.linalg.norm(p_al - p_gt, axis=-1)
    ate_rmse = float(np.sqrt(np.mean(err**2)))

    # RPE over delta: relative motions of aligned estimate vs gt
    def rel(poses, scale=1.0):
        out = []
        for i in range(len(poses) - rpe_delta):
            a = poses[i].copy()
            b = poses[i + rpe_delta].copy()
            a[:3, 3] *= scale
            b[:3, 3] *= scale
            out.append(np.linalg.inv(a) @ b)
        return np.stack(out)

    r_est = rel(est, s)
    r_gt = rel(gt)
    d = np.matmul(np.linalg.inv(r_gt), r_est)
    rpe_t = float(np.sqrt(np.mean(np.linalg.norm(d[:, :3, 3], axis=-1) ** 2)))
    cos = np.clip((np.trace(d[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    rpe_r = float(np.sqrt(np.mean(np.degrees(np.arccos(cos)) ** 2)))

    return TrajectoryErrors(
        ate_rmse=ate_rmse,
        ate_mean=float(err.mean()),
        ate_median=float(np.median(err)),
        rpe_trans_rmse=rpe_t,
        rpe_rot_deg_rmse=rpe_r,
        scale=s,
    )


class DepthErrors(NamedTuple):
    abs_rel: float
    sq_rel: float
    rmse: float
    rmse_log: float
    delta1: float  # fraction with max(pred/gt, gt/pred) < 1.25
    delta2: float  # ... < 1.25²
    delta3: float  # ... < 1.25³
    scale: float  # per-frame median scale applied (mean over frames)
    n_valid: int


def evaluate_depth(
    pred: np.ndarray,
    gt: np.ndarray,
    mask: np.ndarray | None = None,
    align: str = "median",
    min_depth: float = 1e-6,
    max_depth: float | None = None,
) -> DepthErrors:
    """Standard monocular depth metrics over ``[N, H, W]`` (or ``[H, W]``)
    stacks (Eigen protocol: AbsRel/SqRel/RMSE/RMSElog/δ-thresholds).

    align: "median" (per-frame median scaling — the protocol for
    scale-ambiguous predictions), "none".  ``mask`` marks valid gt pixels;
    gt outside (min_depth, max_depth) is always excluded.
    """
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred, gt = pred[None], gt[None]
        if mask is not None:
            mask = np.asarray(mask)[None]
    if pred.shape != gt.shape:
        raise ValueError(f"depth shapes differ: {pred.shape} vs {gt.shape}")
    if align not in ("median", "none"):
        raise ValueError(f"align must be median|none, got {align!r}")

    valid = gt > min_depth
    if max_depth is not None:
        valid &= gt < max_depth
    if mask is not None:
        valid &= np.asarray(mask, bool)
    valid &= np.isfinite(pred) & (pred > 0)

    p_list, g_list, scales = [], [], []
    for f in range(pred.shape[0]):
        m = valid[f]
        if not m.any():
            continue
        p, g = pred[f][m], gt[f][m]
        s = float(np.median(g) / np.median(p)) if align == "median" else 1.0
        p_list.append(p * s)
        g_list.append(g)
        scales.append(s)
    if not p_list:
        raise ValueError("no valid depth pixels to evaluate")
    p = np.concatenate(p_list)
    g = np.concatenate(g_list)

    ratio = np.maximum(p / g, g / p)
    diff_log = np.log(p) - np.log(g)
    return DepthErrors(
        abs_rel=float(np.mean(np.abs(p - g) / g)),
        sq_rel=float(np.mean((p - g) ** 2 / g)),
        rmse=float(np.sqrt(np.mean((p - g) ** 2))),
        rmse_log=float(np.sqrt(np.mean(diff_log**2))),
        delta1=float(np.mean(ratio < 1.25)),
        delta2=float(np.mean(ratio < 1.25**2)),
        delta3=float(np.mean(ratio < 1.25**3)),
        scale=float(np.mean(scales)),
        n_valid=int(p.size),
    )
