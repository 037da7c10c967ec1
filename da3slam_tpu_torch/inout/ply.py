"""PLY point-cloud I/O (counterpart of ``da3slam_tpu/inout/ply.py``):
vertices with optional uint8 RGB colors, binary little-endian or ascii, the
bytes the JAX package's writer produces, and the merge of a directory's
files.  Binary files go through the port's C++ library (``native/``) where
it builds, else through numpy."""

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

    if binary:
        # the C++ writer streams straight from the buffers
        from da3slam_tpu_torch import native

        Path(path).parent.mkdir(parents=True, exist_ok=True)
        if native.write_ply_native(path, points, colors if has_color else None):
            return

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


def read_ply(path: str | Path) -> tuple[np.ndarray, np.ndarray | None]:
    """Read a PLY written by :func:`write_ply` (and the common subset of
    ascii/binary_little_endian vertex-only files)."""
    from da3slam_tpu_torch import native

    fast = native.read_ply_native(path)
    if fast is not None:
        return fast

    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = next(ln.split()[1] for ln in header_lines if ln.startswith("format"))
        n = int(next(ln.split()[2] for ln in header_lines if ln.startswith("element vertex")))
        names = [ln.split()[2] for ln in header_lines if ln.startswith("property")]
        has_color = "red" in names

        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n).reshape(n, -1)
            pts = data[:, :3].astype(np.float32)
            cols = data[:, 3:6].astype(np.uint8) if has_color else None
            return pts, cols

        if has_color:
            rec = np.frombuffer(f.read(n * 15), dtype=[("xyz", "<f4", 3), ("rgb", np.uint8, 3)],
                                count=n)
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts = np.frombuffer(f.read(n * 12), dtype="<f4", count=n * 3).reshape(n, 3)
        return pts.copy(), None


def merge_ply_files(input_dir: str | Path, output_path: str | Path) -> int:
    """Concatenate every ``.ply`` under ``input_dir`` (sorted by name) into one
    binary file, uncolored files in gray 200.  Returns the point count."""
    all_pts, all_cols = [], []
    for fp in sorted(Path(input_dir).glob("*.ply")):
        pts, cols = read_ply(fp)
        all_pts.append(pts)
        all_cols.append(cols if cols is not None else np.full_like(pts, 200, dtype=np.uint8))
    if not all_pts:
        return 0
    pts = np.concatenate(all_pts)
    write_ply(output_path, pts, np.concatenate(all_cols))
    return int(pts.shape[0])
