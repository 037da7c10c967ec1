"""Evaluation CLI: trajectory ATE/RPE and/or Eigen depth metrics
(counterpart of ``da3slam_tpu/cli/evaluate.py``).

    # trajectory: two camera_poses.txt files
    python -m da3slam_tpu_torch.cli.evaluate --est out/camera_poses.txt \\
        --gt gt/camera_poses.txt [--align sim3|se3|none] [--rpe_delta 1]

    # depth: predicted stack vs ground truth (.npy [N,H,W], directory of
    # per-frame .npy, or a C3VD-layout sequence dir for --depth_gt)
    python -m da3slam_tpu_torch.cli.evaluate --depth_est out/depth.npy \\
        --depth_gt /data/c3vd/seq1 [--max_depth 0.1]

    # both against a C3VD sequence (gt poses from its pose.txt)
    python -m da3slam_tpu_torch.cli.evaluate --est out/camera_poses.txt \\
        --gt_seq /data/c3vd/seq1 --depth_est out/depth.npy

Prints one JSON object with a "trajectory" and/or "depth" section.  Same
flags as the JAX package's CLI, plus ``--device`` (default ``cuda``), where
the trajectory alignment runs (``slam/evaluate.py``); without CUDA a ``cuda``
run is refused.  The metrics themselves are numpy in f64.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ATE/RPE + depth evaluation (PyTorch/CUDA port)")
    p.add_argument("--est", help="estimated trajectory file")
    p.add_argument("--gt", help="ground-truth trajectory file")
    p.add_argument(
        "--traj_format", default="auto",
        choices=["auto", "reference", "kitti", "tum"],
        help="trajectory file format for --est/--gt (auto: detect by "
        "column count — 16=reference camera_poses.txt, 12=KITTI, 8=TUM)",
    )
    p.add_argument("--gt_seq", help="C3VD- or KITTI-layout sequence dir (gt poses + depth)")
    p.add_argument("--gt_poses", help="external poses file for --gt_seq "
                   "(KITTI keeps them in ../poses/NN.txt)")
    p.add_argument("--align", default="sim3", choices=["sim3", "se3", "none"])
    p.add_argument("--rpe_delta", type=int, default=1)
    p.add_argument("--depth_est", help=".npy stack or dir of per-frame .npy")
    p.add_argument("--depth_gt", help=".npy stack, dir of .npy, or C3VD seq dir")
    p.add_argument("--depth_align", default="median", choices=["median", "none"])
    p.add_argument("--max_depth", type=float, default=None)
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def _load_depth_any(path_str: str) -> np.ndarray:
    """Depth stack from a .npy file, a directory of per-frame .npy, or a
    C3VD-layout sequence directory."""
    path = Path(path_str)
    if path.is_file():
        return np.load(path)
    npys = sorted(path.glob("*.npy"))
    if npys:
        return np.stack([np.load(f) for f in npys])
    from da3slam_tpu_torch.inout.datasets import load_c3vd_sequence, load_depth_stack

    stack = load_depth_stack(load_c3vd_sequence(path))
    if stack is None:
        raise FileNotFoundError(f"no depth maps found under {path}")
    return stack


def _match_resolution(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Resize ``[N, H, W]`` predictions to the gt grid (the protocol scores at
    gt resolution), bilinear as ``jax.image.resize`` does, on the CPU."""
    if pred.shape[1:] == gt.shape[1:]:
        return pred
    from da3slam_tpu_torch.ops.resize import resize_bilinear

    out = resize_bilinear(torch.from_numpy(np.ascontiguousarray(pred))[..., None],
                          tuple(gt.shape[1:]))
    return out[..., 0].numpy()


def main(argv=None) -> dict:
    """Run the CLI; returns the report it prints."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    report: dict = {}

    gt_traj = None
    gt_depth_src = args.depth_gt
    if args.gt_seq:
        from da3slam_tpu_torch.inout.datasets import load_c3vd_sequence, load_kitti_sequence

        seq_path = Path(args.gt_seq)
        if (seq_path / "image_2").is_dir() or (seq_path / "calib.txt").exists():
            seq = load_kitti_sequence(seq_path, poses_file=args.gt_poses)
        elif args.gt_poses:
            raise SystemExit("--gt_poses is only meaningful with a KITTI-layout --gt_seq")
        else:
            seq = load_c3vd_sequence(seq_path)
        if seq.poses_c2w is not None:
            gt_traj = seq.poses_c2w
        if gt_depth_src is None and seq.depth_paths is not None:
            gt_depth_src = args.gt_seq

    if args.est:
        from da3slam_tpu_torch.inout.trajectory import load_trajectory
        from da3slam_tpu_torch.slam.evaluate import evaluate_trajectory

        est = load_trajectory(args.est, fmt=args.traj_format)
        if gt_traj is None:
            if not args.gt:
                raise SystemExit("--est needs --gt or --gt_seq with pose.txt")
            gt_traj = load_trajectory(args.gt, fmt=args.traj_format)
        res = evaluate_trajectory(est, gt_traj, align=args.align, rpe_delta=args.rpe_delta,
                                  device=device)
        report["trajectory"] = res._asdict()

    if args.depth_est:
        from da3slam_tpu_torch.slam.evaluate import evaluate_depth

        if gt_depth_src is None:
            raise SystemExit("--depth_est needs --depth_gt or --gt_seq with depth")
        pred = np.asarray(_load_depth_any(args.depth_est), np.float32)
        gt = np.asarray(_load_depth_any(gt_depth_src), np.float32)
        if pred.ndim == 2:
            pred = pred[None]
        if gt.ndim == 2:
            gt = gt[None]
        pred = _match_resolution(pred, gt)
        res = evaluate_depth(pred, gt, align=args.depth_align, max_depth=args.max_depth)
        report["depth"] = res._asdict()

    if not report:
        raise SystemExit("nothing to evaluate: pass --est and/or --depth_est")
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
