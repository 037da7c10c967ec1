"""Render a 3DGS scene along a camera trajectory (counterpart of
``da3slam_tpu/cli/render.py``).

    python -m da3slam_tpu_torch.cli.render --splats scene_3dgs.ply \\
        --poses camera_poses.txt [--intrinsics intrinsic.txt] \\
        --output_dir frames/ [--interp N]

Replays the trajectory through the tile rasterizer (``ops/rasterize.py``)
and writes the frames as PNGs; ``--interp N`` slerps N in-between cameras on
each edge of the trajectory.  Same flags as the JAX package's CLI, plus
``--device`` (default ``cuda``; the run happens there or not at all).  A
frame's only host wait is the fetch of its uint8 pixels.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Render 3DGS splats along a trajectory "
                                "(PyTorch/CUDA port)")
    p.add_argument("--splats", required=True, help="3DGS .ply (main_3dgs output)")
    p.add_argument("--poses", required=True,
                   help="camera_poses.txt (16-float c2w rows) from the SLAM run")
    p.add_argument("--intrinsics", default=None,
                   help="intrinsic.txt (fx fy cx cy rows); defaults to a "
                        "60-deg pinhole if absent")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--height", type=int, default=504)
    p.add_argument("--width", type=int, default=504)
    p.add_argument("--interp", type=int, default=0,
                   help="slerp N extra cameras between consecutive poses")
    p.add_argument("--stride", type=int, default=1, help="render every k-th pose")
    p.add_argument("--bg", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    p.add_argument("--max_per_tile", type=int, default=256)
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def _interp_poses(c2w: np.ndarray, n_between: int) -> np.ndarray:
    """Slerp rotations and lerp translations between consecutive c2w poses."""
    from da3slam_tpu_torch.core.transforms import slerp_rotations

    out = []
    for a, b in zip(c2w[:-1], c2w[1:]):
        out.append(a)
        Ra = torch.as_tensor(a[:3, :3], dtype=torch.float32)
        Rb = torch.as_tensor(b[:3, :3], dtype=torch.float32)
        for t in np.linspace(0, 1, n_between + 2)[1:-1]:
            T = np.eye(4)
            T[:3, :3] = slerp_rotations(Ra, Rb, float(t)).numpy()
            T[:3, 3] = (1 - t) * a[:3, 3] + t * b[:3, 3]
            out.append(T)
    out.append(c2w[-1])
    return np.stack(out)


def main(argv=None) -> int:
    """Run the CLI; returns the number of frames written."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")

    from PIL import Image

    from da3slam_tpu_torch.inout.export3d import read_3dgs_ply
    from da3slam_tpu_torch.inout.trajectory import load_camera_poses
    from da3slam_tpu_torch.ops.rasterize import rasterize

    gs = read_3dgs_ply(args.splats)
    c2w = load_camera_poses(args.poses)[:: args.stride]
    if args.interp > 0:
        c2w = _interp_poses(c2w, args.interp)

    H, W = args.height, args.width
    if args.intrinsics:
        rows = np.loadtxt(args.intrinsics)
        if rows.ndim == 1:
            rows = rows[None]
        fx, fy, cx, cy = rows[0]
    else:
        fx = fy = 0.5 * W / np.tan(np.deg2rad(30.0))
        cx, cy = W / 2.0, H / 2.0

    def dev(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    K = dev([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    splats = [dev(gs[k]) for k in ("points", "scales", "rotations", "colors", "opacity")]
    bg = dev(args.bg)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    w2c = dev(np.stack([np.linalg.inv(T)[:3] for T in c2w]))  # one upload
    with torch.no_grad():
        for i, E in enumerate(w2c):
            rgb, _, _ = rasterize(*splats, K, E, (H, W), bg=bg, max_per_tile=args.max_per_tile)
            frame = (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
            Image.fromarray(frame).save(out_dir / f"{i:06d}.png")
    print(f"rendered {len(c2w)} frames ({W}x{H}, {splats[0].shape[0]} splats) to {out_dir}")
    return len(c2w)


if __name__ == "__main__":
    main()
