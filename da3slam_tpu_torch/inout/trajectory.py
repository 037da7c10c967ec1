"""Trajectory / intrinsics export (counterpart of
``da3slam_tpu/inout/trajectory.py:save_camera_poses``; numpy only).

``camera_poses.txt``: one row per frame, 16 floats = flattened 4x4 c2w.
``intrinsic.txt``: one row per frame, ``fx fy cx cy``.
``camera_poses.ply``: camera centers as colored points (ascii).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CHUNK_COLORS = np.array(
    [
        [255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0], [255, 0, 255],
        [0, 255, 255], [128, 0, 0], [0, 128, 0], [0, 0, 128], [128, 128, 0],
    ],
    np.uint8,
)


def _write_ascii_ply(path: Path, points: np.ndarray, colors: np.ndarray) -> None:
    points = np.asarray(points, np.float32).reshape(-1, 3)
    header = [
        "ply", "format ascii 1.0", f"element vertex {points.shape[0]}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        "end_header",
    ]
    with open(path, "w") as f:
        f.write("\n".join(header) + "\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def save_camera_poses(
    output_dir: str | Path,
    c2w_poses: np.ndarray,
    intrinsics: np.ndarray,
    chunk_indices: np.ndarray | None = None,
) -> None:
    """Write camera_poses.txt / intrinsic.txt / camera_poses.ply.

    Args:
      c2w_poses:     ``[N, 4, 4]`` camera-to-world
      intrinsics:    ``[N, 3, 3]``
      chunk_indices: optional ``[N]`` int — colors each camera center by its
                     chunk in the PLY
    """
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    with open(out / "camera_poses.txt", "w") as f:
        for pose in c2w_poses:
            f.write(" ".join(str(x) for x in np.asarray(pose).flatten()) + "\n")

    with open(out / "intrinsic.txt", "w") as f:
        for K in intrinsics:
            f.write(f"{K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]}\n")

    centers = np.asarray(c2w_poses)[:, :3, 3]
    if chunk_indices is not None:
        colors = CHUNK_COLORS[np.asarray(chunk_indices) % len(CHUNK_COLORS)]
    else:
        colors = np.broadcast_to(CHUNK_COLORS[0], centers.shape)
    _write_ascii_ply(out / "camera_poses.ply", centers, colors)
