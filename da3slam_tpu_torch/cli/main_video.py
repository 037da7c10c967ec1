"""One-shot video → SLAM CLI (counterpart of ``da3slam_tpu/cli/main_video.py``).

    python -m da3slam_tpu_torch.cli.main_video --video clip.mp4 --output_dir out/ \\
        [--config configs/config1.yaml] [--stride 2] [--crop c3vd2] \\
        [--brightness] [--mode streaming|slam] [--traj_formats tum,kitti]

Chains the stages the port already has behind one command: decode the video
into frames (``preprocess/host.py:video_to_frames``: imageio, so a GIF
decodes through its pillow plugin and a real codec needs its ffmpeg
plugin), an optional ratio-square crop (a preset or a ratio) and
brightness pass, then ``DA3Streaming`` (``--mode streaming``, the default)
or ``SLAMSolver`` with its trajectory export (``--mode slam``; the viewer
unless ``--headless``).  Stages write into ``<output_dir>/frames``,
``/cropped``, ``/normalized`` and ``/slam``, so intermediate frames stay
inspectable.  The JAX package's flags, plus ``--device`` (default ``cuda``;
the run, the crop and the brightness pass happen there or not at all).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Video → DA3-SLAM in one command (PyTorch/CUDA port)")
    p.add_argument("--video", required=True, help="input video file")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--config", default=None, help="YAML config (reference schema)")
    p.add_argument("--stride", type=int, default=1, help="frame sample stride")
    p.add_argument("--crop", default=None, metavar="PRESET",
                   help="ratio-square crop preset (uka1 / c3vd2) or a float ratio")
    p.add_argument("--brightness", action="store_true",
                   help="LAB/CLAHE brightness normalization pass")
    p.add_argument("--mode", default="streaming", choices=["streaming", "slam"],
                   help="streaming = disk-spill long-sequence pipeline (default); "
                   "slam = in-memory SLAMSolver with live viewer")
    p.add_argument("--traj_formats", default=None,
                   help="extra trajectory exports (streaming mode): tum,kitti")
    p.add_argument("--headless", action="store_true",
                   help="slam mode: no viewer")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None):
    """Run the CLI; returns the ``DA3Streaming`` or ``SLAMSolver`` that ran."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    out_root = Path(args.output_dir)
    out_root.mkdir(parents=True, exist_ok=True)

    from da3slam_tpu_torch.preprocess import host

    frames_dir = out_root / "frames"
    n = host.video_to_frames(args.video, frames_dir, stride=args.stride)
    if n == 0:
        raise SystemExit(f"no frames decoded from {args.video}")
    image_dir = frames_dir

    if args.crop is not None:
        cropped = out_root / "cropped"
        try:
            ratio = float(args.crop)  # only the parse: a crop error must not
            # re-run as dataset=<numeric string>
        except ValueError:
            ratio = None
        if ratio is not None:
            if not 0.0 < ratio <= 1.0:
                raise SystemExit(f"--crop ratio must be in (0, 1], got {ratio}")
            host.crop_images_in_folder(image_dir, cropped, ratio=ratio, device=device)
        else:
            if args.crop not in host.CROP_PRESETS:
                raise SystemExit(
                    f"unknown crop preset {args.crop!r}; available: "
                    f"{', '.join(sorted(host.CROP_PRESETS))} or a float ratio"
                )
            host.crop_images_in_folder(image_dir, cropped, dataset=args.crop, device=device)
        image_dir = cropped

    if args.brightness:
        normalized = out_root / "normalized"
        host.adjust_brightness_in_folder(image_dir, normalized, device=device)
        image_dir = normalized

    from da3slam_tpu_torch.inout import load_config
    from da3slam_tpu_torch.inout.trajectory import validate_extra_formats

    config = load_config(args.config) if args.config else {"Weights": {"DA3": "small"}}
    traj_formats = validate_extra_formats(
        f.strip() for f in (args.traj_formats or "").split(",") if f.strip()
    )

    run_dir = out_root / "slam"
    if args.mode == "streaming":
        if traj_formats:
            config.setdefault("Model", {})["traj_formats"] = list(traj_formats)
        from da3slam_tpu_torch.slam.streaming import DA3Streaming

        streaming = DA3Streaming(str(image_dir), str(run_dir), config, device=device)
        streaming.run()
        streaming.close()
        print(f"outputs in {run_dir}")
        return streaming

    from da3slam_tpu_torch.inout.trajectory import save_camera_poses
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    solver = SLAMSolver(str(image_dir), config, viewer=None if args.headless else "auto",
                        device=device)
    solver.run()
    poses, intrs = solver.trajectory()
    save_camera_poses(run_dir, poses, intrs, extra_formats=traj_formats)
    print(f"Trajectory ({len(poses)} frames) exported to {run_dir}")
    return solver


if __name__ == "__main__":
    main()
