"""Confidence-map inspection CLI (counterpart of
``da3slam_tpu/cli/main_conf.py``).

    python -m da3slam_tpu_torch.cli.main_conf --image_dir D --stats_only

One chunk's inference (poses from the ray maps) → per-frame confidence
histograms on stdout.  The JAX package's flags but ``--output_dir`` (the
figures' directory), plus ``--device`` (default ``cuda``; the run happens
there or not at all) and ``--stats_only``, which is required: the comparison
and heatmap figures need matplotlib and are not ported (ROADMAP queue 1,
item 13).
"""

from __future__ import annotations

import argparse

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Confidence-map statistics (PyTorch/CUDA port)")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--model", default="small")
    p.add_argument("--chunk_size", type=int, default=8)
    p.add_argument("--process_res", type=int, default=504)
    p.add_argument("--stats_only", action="store_true",
                   help="print the statistics and write no figure (required)")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None) -> list[dict]:
    """Run the CLI; returns each frame's ``conf_stats``."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    if not args.stats_only:
        raise NotImplementedError("the confidence figures need matplotlib and are not ported "
                                  "(ROADMAP queue 1, item 13): run with --stats_only")

    from da3slam_tpu_torch.inout import load_image_paths
    from da3slam_tpu_torch.models.da3 import DepthAnything3
    from da3slam_tpu_torch.viz.confidence import print_conf_stats

    paths = load_image_paths(args.image_dir)[: args.chunk_size]
    if not paths:
        raise SystemExit(f"no images in {args.image_dir}")

    model = DepthAnything3.from_pretrained(args.model, device=device)
    pred = model.inference(image=paths, use_ray_pose=True, process_res=args.process_res)
    return [print_conf_stats(pred.conf[i], i) for i in range(len(paths))]


if __name__ == "__main__":
    main()
