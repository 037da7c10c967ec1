"""PLY point-cloud export (counterpart of ``da3slam_tpu/inout/ply.py:write_ply``,
numpy only): vertices with optional uint8 RGB colors, binary little-endian or
ascii, the bytes the JAX package's writer produces."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_ply(
    path: str | Path,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """points ``[N, 3]`` float; colors ``[N, 3]`` uint8 (optional)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            # float colors: 0-1 vs 0-255 guessed from the data range (ambiguous
            # for all-dark 0-255 floats: pass uint8 to be explicit)
            scale = 255.0 if (colors.size and colors.max() <= 1.0) else 1.0
            colors = np.clip(colors * scale, 0, 255).astype(np.uint8)

    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header.append(f"element vertex {n}")
    header += ["property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if binary:
        with open(path, "wb") as f:
            f.write(("\n".join(header) + "\n").encode("ascii"))
            if has_color:
                rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", np.uint8, 3)])
                rec["xyz"] = points
                rec["rgb"] = colors
                f.write(rec.tobytes())
            else:
                f.write(points.astype("<f4").tobytes())
    else:
        with open(path, "w") as f:
            f.write("\n".join(header) + "\n")
            for i in range(n):
                row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
                if has_color:
                    row += f" {colors[i, 0]} {colors[i, 1]} {colors[i, 2]}"
                f.write(row + "\n")
