"""Trajectory / intrinsics I/O (counterpart of ``da3slam_tpu/inout/trajectory.py``;
numpy only).

``camera_poses.txt``: one row per frame, 16 floats = flattened 4x4 c2w.
``intrinsic.txt``: one row per frame, ``fx fy cx cy``.
``camera_poses.ply``: camera centers as colored points (ascii).

Interop formats, for evaluation tools such as ``evo``:
  KITTI: 12 floats per row = the top 3x4 of the c2w matrix, row-major.
  TUM:   ``timestamp tx ty tz qx qy qz qw`` per row (c2w).
``load_trajectory`` tells the three apart by column count (16/12/8).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from da3slam_tpu_torch.inout.ply import write_ply

CHUNK_COLORS = np.array(
    [
        [255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0], [255, 0, 255],
        [0, 255, 255], [128, 0, 0], [0, 128, 0], [0, 0, 128], [128, 128, 0],
    ],
    np.uint8,
)

EXTRA_TRAJ_FORMATS = ("tum", "kitti")


def save_camera_poses(
    output_dir: str | Path,
    c2w_poses: np.ndarray,
    intrinsics: np.ndarray,
    chunk_indices: np.ndarray | None = None,
    extra_formats: tuple[str, ...] = (),
) -> None:
    """Write camera_poses.txt / intrinsic.txt / camera_poses.ply.

    Args:
      c2w_poses:     ``[N, 4, 4]`` camera-to-world
      intrinsics:    ``[N, 3, 3]``
      chunk_indices: optional ``[N]`` int — colors each camera center by its
                     chunk in the PLY
      extra_formats: any of "tum" / "kitti" — also writes
                     ``camera_poses_tum.txt`` / ``camera_poses_kitti.txt``
    """
    validate_extra_formats(extra_formats)  # fail before any file is written
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
        colors = np.broadcast_to(CHUNK_COLORS[0], centers.shape).copy()
    write_ply(out / "camera_poses.ply", centers, colors, binary=False)

    # the extras last: the reference-format files above survive a failing one
    for fmt in extra_formats:
        if fmt == "tum":
            save_trajectory_tum(out / "camera_poses_tum.txt", c2w_poses)
        elif fmt == "kitti":
            save_trajectory_kitti(out / "camera_poses_kitti.txt", c2w_poses)


def validate_extra_formats(formats) -> tuple[str, ...]:
    """Check interop-export format names (at construction or argument parsing,
    so a typo fails before a long run)."""
    formats = tuple(formats)
    for fmt in formats:
        if fmt not in EXTRA_TRAJ_FORMATS:
            raise ValueError(f"unknown trajectory export format {fmt!r}; "
                             f"supported: {', '.join(EXTRA_TRAJ_FORMATS)}")
    return formats


def _loadtxt(path: str | Path, **kw) -> np.ndarray:
    """``np.loadtxt`` that also takes comma-delimited rows."""
    with open(path) as f:
        first = ""
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                first = line
                break
    if "," in first:
        kw.setdefault("delimiter", ",")
    return np.loadtxt(path, **kw)


def load_camera_poses(path: str | Path) -> np.ndarray:
    """Read a camera_poses.txt back into ``[N, 4, 4]``."""
    rows = _loadtxt(path)
    if rows.ndim == 1:
        rows = rows[None]
    return rows.reshape(-1, 4, 4)


def save_trajectory_kitti(path: str | Path, c2w_poses: np.ndarray) -> None:
    """KITTI odometry poses file: 12 floats per row (top 3x4, row-major)."""
    P = np.asarray(c2w_poses, np.float64)[:, :3, :].reshape(-1, 12)
    with open(path, "w") as f:
        for row in P:
            f.write(" ".join(f"{x:.9g}" for x in row) + "\n")


def load_trajectory_kitti(path: str | Path) -> np.ndarray:
    """KITTI odometry poses file → ``[N, 4, 4]`` c2w."""
    rows = _loadtxt(path)
    if rows.ndim == 1:
        rows = rows[None]
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :] = rows.reshape(-1, 3, 4)
    return out


def _quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    """(w,x,y,z) quaternions ``[..., 4]`` → ``[..., 3, 3]``, in the input's
    float precision."""
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), q.dtype)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Batched rotation matrix → (w,x,y,z) quaternion (Shepperd's method: the
    candidate of the largest squared component), in the input's precision
    (the JAX package's ``inout/export3d.py:_rotmat_to_quat_np``)."""
    shape = R.shape[:-2]
    Rf = R.reshape(-1, 3, 3)
    m00, m01, m02 = Rf[:, 0, 0], Rf[:, 0, 1], Rf[:, 0, 2]
    m10, m11, m12 = Rf[:, 1, 0], Rf[:, 1, 1], Rf[:, 1, 2]
    m20, m21, m22 = Rf[:, 2, 0], Rf[:, 2, 1], Rf[:, 2, 2]
    tr = m00 + m11 + m22
    lead = np.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                     1 - m00 - m11 + m22], -1)
    best = np.argmax(lead, axis=-1)

    q = np.empty((Rf.shape[0], 4), R.dtype)
    rows = [
        lambda i: (1 + tr[i], m21[i] - m12[i], m02[i] - m20[i], m10[i] - m01[i]),
        lambda i: (m21[i] - m12[i], 1 + m00[i] - m11[i] - m22[i],
                   m01[i] + m10[i], m02[i] + m20[i]),
        lambda i: (m02[i] - m20[i], m01[i] + m10[i],
                   1 - m00[i] + m11[i] - m22[i], m12[i] + m21[i]),
        lambda i: (m10[i] - m01[i], m02[i] + m20[i], m12[i] + m21[i],
                   1 - m00[i] - m11[i] + m22[i]),
    ]
    for k, row in enumerate(rows):
        idx = np.nonzero(best == k)[0]
        if idx.size:
            q[idx] = np.stack(row(idx), -1)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return q.reshape(*shape, 4)


def save_trajectory_tum(
    path: str | Path,
    c2w_poses: np.ndarray,
    timestamps: np.ndarray | None = None,
) -> None:
    """TUM trajectory: ``timestamp tx ty tz qx qy qz qw`` per row (c2w);
    ``timestamps`` defaults to the frame index."""
    P = np.asarray(c2w_poses, np.float64)
    if timestamps is None:
        timestamps = np.arange(len(P), dtype=np.float64)
    q_wxyz = _rotmat_to_quat_np(P[:, :3, :3])
    t = P[:, :3, 3]
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, tr, q in zip(timestamps, t, q_wxyz):
            f.write(f"{ts:.6f} {tr[0]:.9g} {tr[1]:.9g} {tr[2]:.9g} "
                    f"{q[1]:.9g} {q[2]:.9g} {q[3]:.9g} {q[0]:.9g}\n")


def load_trajectory_tum(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """TUM trajectory → ``(timestamps [N], c2w [N, 4, 4])``."""
    rows = _loadtxt(path, comments="#")
    if rows.ndim == 1:
        rows = rows[None]
    if rows.shape[1] != 8:
        raise ValueError(f"{path}: TUM rows have 8 columns (t tx ty tz qx qy qz qw), "
                         f"got {rows.shape[1]}")
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :3] = _quat_to_rotmat_np(rows[:, [7, 4, 5, 6]])  # (x,y,z,w) → (w,x,y,z)
    out[:, :3, 3] = rows[:, 1:4]
    return rows[:, 0], out


def load_trajectory(path: str | Path, fmt: str = "auto") -> np.ndarray:
    """Load a trajectory as ``[N, 4, 4]`` c2w from any supported format:
    ``fmt`` is "reference" (16-float rows), "kitti" (12), "tum" (8), or "auto"
    (told apart by the first data row's column count)."""
    if fmt == "auto":
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    n = len(line.replace(",", " ").split())
                    break
            else:
                raise ValueError(f"{path}: no data rows")
        fmt = {16: "reference", 12: "kitti", 8: "tum"}.get(n)
        if fmt is None:
            raise ValueError(f"{path}: unrecognized trajectory format ({n} columns; "
                             "expected 16=reference, 12=KITTI, 8=TUM)")
    if fmt == "reference":
        return load_camera_poses(path)
    if fmt == "kitti":
        return load_trajectory_kitti(path)
    if fmt == "tum":
        return load_trajectory_tum(path)[1]
    raise ValueError(f"unknown trajectory format {fmt!r}")
