"""Long-sequence streaming CLI (counterpart of ``da3slam_tpu/cli/streaming.py``).

    python -m da3slam_tpu_torch.cli.streaming --image_dir D --output_dir O [--config C]

Same flags as the JAX package's CLI, plus ``--device`` (default ``cuda``; the
run happens there or not at all).  Writes per-chunk PLYs, a merged cloud,
camera_poses.txt / intrinsic.txt / camera_poses.ply (and the TUM/KITTI files
of ``--traj_formats``), with ``--mesh`` a TSDF-fused ``scene_mesh.ply``,
then deletes its temporary spill.
"""

from __future__ import annotations

import argparse

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Long-sequence streaming DA3-SLAM (PyTorch/CUDA port)")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--output_dir", default="streaming_out")
    p.add_argument("--keep_temp", action="store_true",
                   help="keep the _tmp_results_* spill directories")
    p.add_argument("--traj_formats", default=None,
                   help="comma-separated interop trajectory exports beside "
                   "camera_poses.txt: tum,kitti")
    p.add_argument("--mesh", action="store_true",
                   help="also TSDF-fuse the sequence into scene_mesh.ply "
                   "(Model.export_mesh; mesh_resolution, mesh_sparse, mesh_carve)")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None):
    """Run the CLI; returns the ``DA3Streaming`` that ran."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")

    from da3slam_tpu_torch.inout import load_config
    from da3slam_tpu_torch.slam.streaming import DA3Streaming

    config = load_config(args.config) if args.config else {"Weights": {"DA3": "small"}}
    if args.keep_temp:
        config.setdefault("Model", {})["delete_temp_files"] = False
    if args.traj_formats:
        config.setdefault("Model", {})["traj_formats"] = [
            f.strip() for f in args.traj_formats.split(",") if f.strip()
        ]
    if args.mesh:
        config.setdefault("Model", {})["export_mesh"] = True

    streaming = DA3Streaming(args.image_dir, args.output_dir, config, device=device)
    streaming.run()
    streaming.close()
    return streaming


if __name__ == "__main__":
    main()
