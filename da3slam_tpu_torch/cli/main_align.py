"""Chunk-alignment demo CLI (counterpart of ``da3slam_tpu/cli/main_align.py``).

    python -m da3slam_tpu_torch.cli.main_align --image_dir D --model large \\
        --method irls --chunk_size 15 --headless --output_ply fused.ply

Splits the sequence into chunks, runs the model over each with poses
recovered from the ray maps (``use_ray_pose``), aligns each chunk to the
previous one by the chosen method, prints per-chunk diagnostics and
optionally exports the fused cloud as a PLY.  Without ``--headless`` the
first and last frame of every chunk go to the viser viewer with their global
poses, and the process stays alive after the run (headless, with a message,
where ``viser`` is missing).  Same flags as the JAX package's CLI, plus
``--device`` (default ``cuda``): the run happens on that device or not at
all.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Chunk alignment demo (PyTorch/CUDA port)")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--model", default="small")
    p.add_argument("--chunk_size", type=int, default=4)
    p.add_argument("--overlap", type=int, default=1)
    p.add_argument("--method", default="icp", choices=["icp", "irls", "umeyama"])
    p.add_argument("--output_ply", default=None, help="write fused cloud here")
    p.add_argument("--process_res", type=int, default=504)
    p.add_argument("--headless", action="store_true")
    p.add_argument("--debug_color", action="store_true",
                   help="tint each chunk's points a distinct color")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")

    from da3slam_tpu_torch.core.geometry import backproject_depth
    from da3slam_tpu_torch.inout import load_config, load_image_paths, write_ply
    from da3slam_tpu_torch.models.da3 import DepthAnything3
    from da3slam_tpu_torch.slam.alignment import AlignmentConfig, align_chunk_single_overlap
    from da3slam_tpu_torch.slam.chunks import make_chunk_indices
    from da3slam_tpu_torch.viz.debug import apply_chunk_color_to_images_batch

    if args.config:
        model_path = load_config(args.config).get("Weights", {}).get("DA3", args.model)
    else:
        model_path = args.model

    model = DepthAnything3.from_pretrained(model_path, device=device)
    paths = load_image_paths(args.image_dir)
    if not paths:
        raise SystemExit(f"no images in {args.image_dir}")
    ranges = make_chunk_indices(len(paths), args.chunk_size, args.overlap)
    chunks = [paths[a:b] for a, b in ranges]
    print(f"{len(paths)} frames → {len(chunks)} chunks of {args.chunk_size}")

    align_cfg = AlignmentConfig(method=args.method)
    viewer = None
    if not args.headless:
        try:
            from da3slam_tpu_torch.viz.viewer import SLAMViewer

            viewer = SLAMViewer(port=8080, device=device)
        except ImportError:
            print("viser unavailable; headless")

    def dev(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    def infer(chunk):
        return model.inference(image=chunk, use_ray_pose=True, process_res=args.process_res)

    all_pts, all_cols = [], []

    def accumulate(pred, ext_global):
        pts = backproject_depth(dev(pred.depth), dev(pred.intrinsics), dev(ext_global))
        keep = pred.conf >= 1.0
        colors = pred.processed_images
        if args.debug_color:
            colors = apply_chunk_color_to_images_batch(colors, len(all_pts))
        all_pts.append(pts.cpu().numpy()[keep])
        all_cols.append(colors[keep])
        if viewer is not None:
            ends = [0, len(pred.depth) - 1]  # the first and last frame of the chunk
            viewer.add_frames(pred.processed_images[ends], pred.depth[ends], pred.conf[ends],
                              ext_global[ends], pred.intrinsics[ends])

    prev = infer(chunks[0])
    prev_ext_global = prev.extrinsics.astype(np.float64)
    accumulate(prev, prev_ext_global)
    prev_overlap_global = prev_ext_global[-1]

    for k in range(1, len(chunks)):
        cur = infer(chunks[k])
        # index within cur of the frame that IS prev's last frame: overlap-1
        # in the steady state, larger for the re-anchored tail chunk
        anchor = ranges[k - 1][1] - 1 - ranges[k][0]
        out = align_chunk_single_overlap(
            prev_depth=dev(prev.depth[-1]),
            prev_conf=dev(prev.conf[-1]),
            prev_K=dev(prev.intrinsics[-1]),
            cur_depth=dev(cur.depth),
            cur_conf=dev(cur.conf),
            cur_K=dev(cur.intrinsics),
            cur_extrinsics=dev(cur.extrinsics),
            prev_overlap_global=dev(prev_overlap_global),
            config=align_cfg,
            anchor_idx=anchor,
        )
        print(f"chunk {k}: s={float(out.depth_scale):.4f} "
              f"fitness={float(out.fitness):.4f} rmse={float(out.inlier_rmse):.5f}")
        cur_ext_global = out.extrinsics_global.cpu().numpy()
        cur.depth = out.depth_scaled.cpu().numpy()
        accumulate(cur, cur_ext_global)
        prev, prev_overlap_global = cur, cur_ext_global[-1]

    if args.output_ply:
        pts = np.concatenate(all_pts)
        write_ply(args.output_ply, pts, np.concatenate(all_cols))
        print(f"fused cloud ({len(pts)} pts) → {args.output_ply}")

    if viewer is not None:
        viewer.keep_alive()


if __name__ == "__main__":
    main()
