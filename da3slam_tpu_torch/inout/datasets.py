"""Dataset loaders for evaluation harnesses (counterpart of
``da3slam_tpu/inout/datasets.py``; numpy and PIL only).

C3VD (the reference pipeline's target domain — colonoscopy video with
registered ground truth; configs/config1.yaml crop presets reference its
capture geometry) ships per-sequence folders of:

    0000_color.png       RGB frame
    0000_depth.tiff      16-bit depth, 0..65535 ↦ 0..100 mm
    pose.txt             one 4×4 cam-to-world per line, comma-separated,
                         translations in millimetres; flattening order
                         differs between public loaders (row- vs
                         column-major) — see ``pose_layout``

This loader maps that layout onto the framework's conventions (c2w float
metres, depth [H, W] float metres) so a SLAM run can be scored against
ground truth with ``cli/evaluate.py`` (ATE/RPE + Eigen depth metrics).
It is intentionally tolerant: sequences with no depth or no poses load
with those fields as ``None`` (trajectory-only / depth-only scoring).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

# C3VD units: 16-bit depth spans 0..100 mm; poses are in millimetres.
C3VD_DEPTH_SCALE_M = 0.100 / 65535.0
C3VD_POSE_UNIT_M = 1e-3


@dataclass
class SequenceData:
    image_paths: list[Path]
    depth_paths: list[Path] | None
    poses_c2w: np.ndarray | None  # [N, 4, 4] float64, metres
    intrinsics: np.ndarray | None = None  # [3, 3] when the dataset ships one

    def __len__(self) -> int:
        return len(self.image_paths)


def _load_pose_file(path: Path, unit: float, layout: str = "auto") -> np.ndarray:
    """Parse 16-floats-per-line pose files.

    ``layout`` is the flattening order of each 4x4 matrix:
      - ``"row"``:  row-major (the common C3VD convention)
      - ``"col"``:  column-major (several public C3VD loaders transpose)
      - ``"auto"``: detect from the homogeneous structure.  A transposed
        rigid transform still has an orthonormal 3x3 block (Rᵀ), so
        orthonormality cannot discriminate; what does is where the
        [0, 0, 0, 1] row lands — read row-major, a column-major file shows
        the translation in the bottom row and zeros in the last column.
        A wrong order silently corrupts every rotation-dependent metric
        while translations still look plausible, so ambiguity (both
        residuals nonzero, or translation-free files) falls back to
        row-major with a warning.
    """
    rows = []
    for line in path.read_text().strip().splitlines():
        vals = [float(v) for v in line.replace(",", " ").split()]
        if len(vals) != 16:
            raise ValueError(
                f"{path}: expected 16 values per pose line, got {len(vals)}"
            )
        rows.append(np.asarray(vals, np.float64).reshape(4, 4))
    T = np.stack(rows)
    if layout not in ("row", "col", "auto"):
        raise ValueError(f"pose layout must be row|col|auto, got {layout!r}")
    if layout == "auto":
        # residual of the [0,0,0] part of the homogeneous row under each
        # interpretation (relative to the translation magnitude)
        t_scale = max(np.abs(T[:, :3, 3]).max(), np.abs(T[:, 3, :3]).max(), 1e-12)
        err_row = np.abs(T[:, 3, :3]).max() / t_scale
        err_col = np.abs(T[:, :3, 3]).max() / t_scale
        if err_row <= 1e-9:
            layout = "row"  # includes the translation-free ambiguous case
        elif err_col <= 1e-9:
            layout = "col"
        else:
            layout = "row"
            import warnings

            warnings.warn(
                f"{path}: matrices are not homogeneous under either "
                f"flattening order (row residual {err_row:.2e}, col residual "
                f"{err_col:.2e}); assuming row-major — pass "
                "pose_layout='col' if metrics look wrong",
                stacklevel=2,
            )
    if layout == "col":
        T = np.swapaxes(T, 1, 2)
    T[:, :3, 3] *= unit
    return T


def load_c3vd_sequence(
    seq_dir: str | Path,
    pose_unit: float = C3VD_POSE_UNIT_M,
    pose_layout: str = "auto",
) -> SequenceData:
    """Load one C3VD-layout sequence directory (see module docstring)."""
    seq_dir = Path(seq_dir)
    images = sorted(seq_dir.glob("*_color.png"))
    if not images:
        # plain frame dirs work too (numeric names, any extension)
        from da3slam_tpu_torch.inout.images import load_image_paths

        images = [Path(p) for p in load_image_paths(seq_dir)]
    if not images:
        raise FileNotFoundError(f"no frames found in {seq_dir}")

    depths = sorted(seq_dir.glob("*_depth.tiff")) or sorted(
        seq_dir.glob("*_depth.png")
    )
    if depths and len(depths) != len(images):
        raise ValueError(
            f"{seq_dir}: {len(images)} frames but {len(depths)} depth maps"
        )

    poses = None
    pose_file = seq_dir / "pose.txt"
    if pose_file.exists():
        poses = _load_pose_file(pose_file, pose_unit, layout=pose_layout)
        if len(poses) != len(images):
            raise ValueError(
                f"{seq_dir}: {len(images)} frames but {len(poses)} poses"
            )
    return SequenceData(images, depths or None, poses)


def load_kitti_sequence(
    seq_dir: str | Path,
    poses_file: str | Path | None = None,
    camera: str = "image_2",
) -> SequenceData:
    """Load a KITTI-odometry-layout sequence.

    The reference's long-sequence streaming path was developed on KITTI 00
    and 05 (its temp-disk accounting quotes them, da3_streaming.py:829-830)
    but ships no loader; this provides one.  Layout handled:

        <seq_dir>/image_2/000000.png ...   (or image_0/1/3 via ``camera``)
        <seq_dir>/calib.txt                P0..P3 projection rows (optional)
        poses file: 12 floats per row (3x4 c2w, row-major) — either passed
        explicitly (the dataset keeps them in ../poses/NN.txt) or found as
        <seq_dir>/poses.txt

    KITTI ground-truth poses are cam0-to-world; for trajectory ATE/RPE
    scoring against a monocular estimate (Sim(3)-aligned) the cam0/cam2
    offset is a constant rigid shift absorbed by the alignment.
    """
    seq_dir = Path(seq_dir)
    img_dir = seq_dir / camera
    if not img_dir.is_dir():
        img_dir = seq_dir  # flat directory of frames
    images = sorted(
        p for ext in ("*.png", "*.jpg") for p in img_dir.glob(ext)
    )
    if not images:
        raise FileNotFoundError(f"no frames found under {img_dir}")

    poses = None
    pose_path = Path(poses_file) if poses_file else seq_dir / "poses.txt"
    if poses_file and not pose_path.exists():
        # an explicitly requested poses file must not degrade silently to
        # "no ground truth" — that surfaces later as a misleading error
        raise FileNotFoundError(f"poses file not found: {pose_path}")
    if pose_path.exists():
        from da3slam_tpu_torch.inout.trajectory import load_trajectory_kitti

        poses = load_trajectory_kitti(pose_path)
        if len(poses) != len(images):
            raise ValueError(
                f"{pose_path}: {len(poses)} poses but {len(images)} frames"
            )

    K = None
    calib = seq_dir / "calib.txt"
    if calib.exists():
        want = f"P{camera[-1]}:" if camera[-1].isdigit() else "P2:"
        for line in calib.read_text().splitlines():
            if line.startswith(want):
                P = np.asarray(
                    [float(v) for v in line.split(":", 1)[1].split()],
                    np.float64,
                ).reshape(3, 4)
                K = P[:, :3].copy()
                break
    return SequenceData(images, None, poses, intrinsics=K)


def read_c3vd_depth(path: str | Path, scale: float = C3VD_DEPTH_SCALE_M) -> np.ndarray:
    """16-bit depth image → float32 metres ([H, W]); zero stays zero
    (invalid)."""
    from PIL import Image

    raw = np.asarray(Image.open(path))
    if raw.ndim != 2:
        raise ValueError(f"{path}: expected single-channel depth, got {raw.shape}")
    return raw.astype(np.float32) * scale


def load_depth_stack(seq: SequenceData) -> np.ndarray | None:
    """All ground-truth depth maps of a sequence as ``[N, H, W]`` metres."""
    if seq.depth_paths is None:
        return None
    return np.stack([read_c3vd_depth(p) for p in seq.depth_paths])
