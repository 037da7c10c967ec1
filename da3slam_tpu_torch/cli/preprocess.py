"""Preprocessing CLIs under one entry point (counterpart of
``da3slam_tpu/cli/preprocess.py``):

  python -m da3slam_tpu_torch.cli.preprocess video2frame --video v.mp4 --output frames/
  python -m da3slam_tpu_torch.cli.preprocess crop --input frames/ --output cropped/ --dataset uka1
  python -m da3slam_tpu_torch.cli.preprocess brightness --input cropped/ --output norm/

Same flags as the JAX package's CLI, plus ``--device`` on ``crop`` and
``brightness`` (default ``cuda``; the pixel work runs there or not at all).
"""

from __future__ import annotations

import argparse

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Frame-ingest preprocessing (PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("video2frame", help="decode video to numbered JPEGs")
    v.add_argument("--video", required=True)
    v.add_argument("--output", required=True)
    v.add_argument("--stride", type=int, default=1)

    c = sub.add_parser("crop", help="ratio-square crop a folder")
    c.add_argument("--input", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--dataset", default="uka1", choices=["uka1", "c3vd2"])
    c.add_argument("--ratio", type=float, default=None)
    c.add_argument("--x_offset", type=int, default=None)

    b = sub.add_parser("brightness", help="LAB brightness normalisation")
    b.add_argument("--input", required=True)
    b.add_argument("--output", required=True)
    b.add_argument("--bright_threshold", type=float, default=230)
    b.add_argument("--dark_threshold", type=float, default=30)
    b.add_argument("--bright_reduction", type=float, default=0.7)
    b.add_argument("--dark_enhancement", type=float, default=1.5)
    b.add_argument("--clip_limit", type=float, default=2.0)
    b.add_argument("--grid_size", type=int, default=8)
    for sp in (c, b):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from da3slam_tpu_torch.preprocess import host

    if args.cmd == "video2frame":
        host.video_to_frames(args.video, args.output, args.stride)
        return
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    if args.cmd == "crop":
        host.crop_images_in_folder(args.input, args.output, args.dataset, args.ratio,
                                   args.x_offset, device=device)
    elif args.cmd == "brightness":
        host.adjust_brightness_in_folder(
            args.input, args.output, device=device,
            bright_threshold=args.bright_threshold,
            dark_threshold=args.dark_threshold,
            bright_reduction=args.bright_reduction,
            dark_enhancement=args.dark_enhancement,
            clip_limit=args.clip_limit,
            grid_size=args.grid_size,
        )


if __name__ == "__main__":
    main()
