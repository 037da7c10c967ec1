"""Confidence-map inspection CLI (counterpart of
``da3slam_tpu/cli/main_conf.py``).

    python -m da3slam_tpu_torch.cli.main_conf --image_dir D [--output_dir conf_viz] [--stats_only]

One chunk's inference (poses from the ray maps) → per-frame confidence
histograms on stdout, a 3-panel comparison PNG a frame
(``comparison_NNN.png``) and an all-frames heatmap grid
(``heatmap_grid.png``) in ``--output_dir``.  The JAX package's flags, plus
``--device`` (default ``cuda``; the run happens there or not at all) and
``--stats_only``, which prints the statistics and draws nothing.  The
figures need matplotlib: without it the CLI stops before the model runs,
naming the missing module, and writes nothing.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Confidence-map visualisation (PyTorch/CUDA port)")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--model", default="small")
    p.add_argument("--chunk_size", type=int, default=8)
    p.add_argument("--output_dir", default="conf_viz")
    p.add_argument("--process_res", type=int, default=504)
    p.add_argument("--stats_only", action="store_true",
                   help="print the statistics and draw no figure")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None) -> list[dict]:
    """Run the CLI; returns each frame's ``conf_stats``."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    if not args.stats_only:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise SystemExit(f"main_conf: the figures need matplotlib ({e}); "
                             "run with --stats_only for the statistics alone") from e

    from da3slam_tpu_torch.inout import load_image_paths
    from da3slam_tpu_torch.models.da3 import DepthAnything3
    from da3slam_tpu_torch.viz.confidence import (
        create_confidence_comparison,
        create_overall_heatmap,
        print_conf_stats,
    )

    paths = load_image_paths(args.image_dir)[: args.chunk_size]
    if not paths:
        raise SystemExit(f"no images in {args.image_dir}")

    model = DepthAnything3.from_pretrained(args.model, device=device)
    pred = model.inference(image=paths, use_ray_pose=True, process_res=args.process_res)

    out = Path(args.output_dir)
    stats = []
    for i in range(len(paths)):
        stats.append(print_conf_stats(pred.conf[i], i))
        if not args.stats_only:
            create_confidence_comparison(
                pred.processed_images[i], pred.conf[i], out / f"comparison_{i:03d}.png"
            )
    if not args.stats_only:
        create_overall_heatmap(pred.conf, out / "heatmap_grid.png")
        print(f"figures written to {out}/")
    return stats


if __name__ == "__main__":
    main()
