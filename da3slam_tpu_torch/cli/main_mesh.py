"""TSDF-fused triangle-mesh export CLI (counterpart of
``da3slam_tpu/cli/main_mesh.py``).

    python -m da3slam_tpu_torch.cli.main_mesh --image_dir frames/ \\
        --output scene_mesh.ply [--resolution 192] [--conf_floor 1.0]

Runs the model over the sequence in chunks, stitches the poses with the SLAM
aligner, TSDF-fuses every depth frame on the device (``ops/tsdf.py``) and
extracts a mesh with marching tetrahedra on the host (``inout/mesh.py``).
Same flags as the JAX package's CLI, plus ``--device`` (default ``cuda``;
the run happens there or not at all).
"""

from __future__ import annotations

import argparse

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a sequence as a TSDF mesh "
                                "(PyTorch/CUDA port)")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--model", default="small")
    p.add_argument("--output", default="scene_mesh.ply")
    p.add_argument("--chunk_size", type=int, default=8)
    p.add_argument("--process_res", type=int, default=504)
    p.add_argument("--resolution", type=int, default=192,
                   help="voxels along the longest scene axis")
    p.add_argument("--conf_floor", type=float, default=1.0,
                   help="confidence at/below this contributes zero weight")
    p.add_argument("--max_weight", type=float, default=64.0)
    p.add_argument("--color", action="store_true",
                   help="accumulate per-voxel colors and write per-vertex "
                   "colors into the mesh PLY")
    p.add_argument("--sparse", action="store_true",
                   help="block-sparse band-only fusion (ops/tsdf.py "
                   "integrate_frames_sparse); skips free-space carving unless --carve")
    p.add_argument("--carve", action="store_true",
                   help="with --sparse: also carve free space in front of "
                   "occupied blocks, so spurious early surfaces that later "
                   "frames contradict get erased (dense always carves)")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")

    from da3slam_tpu_torch.inout import load_config, load_image_paths
    from da3slam_tpu_torch.inout.mesh import tsdf_to_mesh, tsdf_vertex_normals, write_mesh_ply
    from da3slam_tpu_torch.models.da3 import DepthAnything3
    from da3slam_tpu_torch.ops.tsdf import fuse_frames, vertex_colors
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
        process_res=args.process_res, collect_images=args.color,
        # TSDF averaging is weighted: duplicated overlap frames would
        # double-weight the chunk seams
        dedup_overlap=True,
    )

    grid = fuse_frames(
        fused["depth"], fused["conf"], fused["intrinsics"], fused["extrinsics_global"],
        resolution=args.resolution,
        conf_floor=args.conf_floor,
        max_weight=args.max_weight,
        images=fused.get("images"),
        sparse=args.sparse,
        carve=args.carve,
        device=device,
    )
    verts, faces = tsdf_to_mesh(grid)
    if len(verts) == 0:
        raise SystemExit("TSDF produced an empty mesh — check --conf_floor "
                         "(no pixel cleared it?) and the depth scale")
    colors = vertex_colors(grid, verts) if args.color else None
    write_mesh_ply(args.output, verts, faces, colors=colors,
                   normals=tsdf_vertex_normals(grid, verts))
    print(f"mesh: {len(verts)} vertices, {len(faces)} faces → {args.output}")


if __name__ == "__main__":
    main()
