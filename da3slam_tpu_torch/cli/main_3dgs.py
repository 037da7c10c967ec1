"""3D-Gaussian-Splatting export CLI (counterpart of
``da3slam_tpu/cli/main_3dgs.py``).

    python -m da3slam_tpu_torch.cli.main_3dgs --image_dir frames/ \\
        --output scene_3dgs.ply [--glb scene.glb] [--refine_iters N] \\
        [--train_iters N [--densify_every N]]

Runs the model over the sequence in chunks, stitches the poses with the SLAM
aligner and writes the fused scene as a standard 3DGS ``.ply`` (and a GLB
point cloud with ``--glb``), optionally refined for multi-view consistency
and trained through the tile rasterizer first (``ops/splats.py``).  Same
flags as the JAX package's CLI, plus ``--device`` (default ``cuda``; the run
happens there or not at all).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a sequence as 3D gaussians "
                                "(PyTorch/CUDA port)")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--model", default="small")
    p.add_argument("--output", default="scene_3dgs.ply")
    p.add_argument("--glb", default=None, help="also write a GLB point cloud")
    p.add_argument("--chunk_size", type=int, default=8)
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--conf_threshold", type=float, default=1.0)
    p.add_argument("--process_res", type=int, default=504)
    p.add_argument("--refine_iters", type=int, default=0,
                   help="multi-view consistency refinement steps over the "
                        "splats (ops/splats.py): positions snap to the "
                        "fused geometry, colors to the observed pixels, "
                        "opacity fades for unsupported splats (0 = off)")
    p.add_argument("--train_iters", type=int, default=0,
                   help="3DGS training steps through the differentiable tile "
                        "rasterizer (ops/rasterize.py): every splat attribute "
                        "(position, scale, rotation, color, opacity) optimizes "
                        "the rendered-vs-observed photometric loss across all "
                        "views (0 = off; runs after --refine_iters if both are set)")
    p.add_argument("--densify_every", type=int, default=0,
                   help="during --train_iters, resample pruned splats into "
                        "under-reconstructed regions every N steps "
                        "(fixed-budget densification; 0 = off)")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns the loss traces of the optimisation passes that
    ran (``refine``, ``train``: tensors on the device) and the splat count."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")

    from da3slam_tpu_torch.inout import load_config, load_image_paths
    from da3slam_tpu_torch.inout.export3d import (
        export_3dgs_ply,
        export_glb,
        prediction_to_3dgs,
        splats_from_prediction,
    )
    from da3slam_tpu_torch.models.da3 import DepthAnything3, Prediction
    from da3slam_tpu_torch.slam.chunks import run_chunked_alignment

    model_path = args.model
    if args.config:
        model_path = load_config(args.config).get("Weights", {}).get("DA3", args.model)

    model = DepthAnything3.from_pretrained(model_path, device=device)
    paths = load_image_paths(args.image_dir)
    if not paths:
        raise SystemExit(f"no images in {args.image_dir}")

    fused = run_chunked_alignment(
        model, paths, args.chunk_size, overlap=1,
        process_res=args.process_res, collect_images=True,
    )
    merged = Prediction(
        processed_images=fused["images"],
        depth=fused["depth"],
        conf=fused["conf"],
        extrinsics=fused["extrinsics_global"],
        intrinsics=fused["intrinsics"],
    )
    traces = {}
    if args.refine_iters > 0 or args.train_iters > 0:
        from da3slam_tpu_torch.ops.splats import refine_splats, train_splats

        def dev(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a), device=device)

        d = splats_from_prediction(merged, stride=args.stride,
                                   conf_threshold=args.conf_threshold)
        points, colors, opacity = dev(d["points"]), dev(d["colors"]), dev(d["opacity"])
        scales, rotations = np.asarray(d["scales"]), d["rotations"]
        views = [dev(merged.processed_images), dev(merged.intrinsics), dev(merged.extrinsics)]
        if args.refine_iters > 0:
            res = refine_splats(points, colors, opacity, dev(merged.depth), *views,
                                iters=args.refine_iters)
            points, colors, opacity = res.points, res.colors, res.opacity
            traces["refine"] = res.losses
            print(f"refined {args.refine_iters} iters "
                  f"(mean support {float(res.support.mean()):.2f})")
        if args.train_iters > 0:
            quats = (dev(rotations) if rotations is not None
                     else torch.tensor([[1.0, 0, 0, 0]], device=device).repeat(points.shape[0], 1))
            hw = tuple(int(x) for x in merged.depth.shape[1:3])
            res = train_splats(points, dev(scales), quats, colors, opacity, *views, hw,
                               iters=args.train_iters, densify_every=args.densify_every)
            points, colors, opacity = res.points, res.colors, res.opacity
            scales, rotations = res.scales.cpu().numpy(), res.quats.cpu().numpy()
            traces["train"] = res.losses
            print(f"trained {args.train_iters} iters "
                  f"(photometric L1 {float(res.losses[0]):.4f} -> "
                  f"{float(res.losses[-1]):.4f})")
        export_3dgs_ply(args.output, points.cpu().numpy(), colors.cpu().numpy(), scales,
                        opacity.cpu().numpy(), rotations=rotations)
        n = int(points.shape[0])
    else:
        n = prediction_to_3dgs(merged, args.output, stride=args.stride,
                               conf_threshold=args.conf_threshold)
    print(f"wrote {n} gaussians to {args.output}")
    if args.glb:
        export_glb(merged, args.glb, stride=args.stride, conf_threshold=args.conf_threshold)
        print(f"wrote GLB point cloud to {args.glb}")
    return {"n": n, **traces}


if __name__ == "__main__":
    main()
