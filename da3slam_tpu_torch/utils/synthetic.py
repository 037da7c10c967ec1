"""Synthetic ground-truth world + contract model for pipeline validation
(a copy of ``da3slam_tpu/utils/synthetic.py``, numpy only; its model returns
the port's ``Prediction``).

Used by the tests and ``chip_smoke.py``: validates the geometry stack (scale
estimation, registration, chaining, loop closure, export, evaluation)
end-to-end with known ground truth and no trained weights.

Emits predictions honoring the §2.5 tensor contract from an *exact*
synthetic world: a corner room of three planes, whose depth from any camera
pose has a closed form.  Per-chunk scale ambiguity (the real model's
metric-ambiguous output) is simulated with a per-chunk multiplier that the
SLAM stitcher must undo.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


PLANES = [
    # (normal, offset): plane n·p = c in world coordinates
    (np.array([1.0, 0.0, 0.0]), 2.0),
    (np.array([0.0, 1.0, 0.0]), 2.0),
    (np.array([0.0, 0.0, 1.0]), 4.0),
]

# The corner room closed into a box ([-2,2] x [-2,2] x [-2,4]): every ray
# from an interior camera hits a wall, so ORBIT trajectories (full yaw
# sweeps) render finite depth in all directions — the full-3D-extent scene
# the TSDF benchmarks fuse.  A superset of PLANES: corner-facing cameras
# see identical depth (the extra walls are behind them).
BOX_PLANES = PLANES + [
    (np.array([-1.0, 0.0, 0.0]), 2.0),
    (np.array([0.0, -1.0, 0.0]), 2.0),
    (np.array([0.0, 0.0, -1.0]), 2.0),
]


def render_depth(
    E_w2c: np.ndarray,
    K: np.ndarray,
    hw: tuple[int, int],
    planes=None,
) -> np.ndarray:
    """Closed-form depth of the corner room (or ``planes``) from ``E_w2c``."""
    H, W = hw
    R, t = E_w2c[:3, :3], E_w2c[:3, 3]
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u, float)], -1)
    depth = np.full((H, W), np.inf)
    Rt_t = R.T @ t
    for n, c in PLANES if planes is None else planes:
        denom = rays @ (R @ n)  # n^T R^T r
        num = c + n @ Rt_t
        with np.errstate(divide="ignore", invalid="ignore"):
            z = num / denom
        z = np.where(z > 0.05, z, np.inf)
        depth = np.minimum(depth, z)
    assert np.isfinite(depth).all(), "camera must face a wall in every pixel"
    return depth.astype(np.float32)


def make_orbit_trajectory(n_frames: int, seed: int = 0) -> np.ndarray:
    """w2c trajectory orbiting inside the BOX_PLANES room: a full 360°
    yaw sweep on a small circle, gentle bobbing — every wall gets seen,
    so the fused scene has true 3D extent (unlike make_trajectory, whose
    corner-facing frames bound a quasi-planar shell)."""
    poses = []
    up = np.array([0.0, 1.0, 0.0])
    for i in range(n_frames):
        th = 2.0 * np.pi * i / max(n_frames, 1)
        look = np.array([np.sin(th), 0.25 * np.sin(2 * th), np.cos(th)])
        look = look / np.linalg.norm(look)
        center = np.array(
            [0.5 * np.cos(th), 0.3 * np.sin(th), 1.0 + 0.5 * np.sin(th)]
        )
        zc = look
        xc = np.cross(up, zc)
        xc = xc / np.linalg.norm(xc)
        yc = np.cross(zc, xc)
        R = np.stack([xc, yc, zc], axis=0)  # world→camera rows
        t = -R @ center
        poses.append(np.concatenate([R, t[:, None]], axis=1))
    return np.stack(poses).astype(np.float64)


def render_hit_points(
    E_w2c: np.ndarray, K: np.ndarray, hw: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    """(depth [H,W], world hit points [H,W,3]) of the corner room."""
    H, W = hw
    R, t = E_w2c[:3, :3], E_w2c[:3, 3]
    depth = render_depth(E_w2c, K, hw)
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack(
        [(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u, float)], -1
    )
    pts_cam = rays * depth[..., None]
    return depth, (pts_cam - t) @ R  # R.T @ (p - t), batched


def render_rgb(E_w2c: np.ndarray, K: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Textured uint8 RGB of the corner room: a smooth multi-frequency
    world-anchored pattern plus Lambert shading, so confidence maps, loop
    descriptors, and preprocess (CLAHE) see real structure.  The texture
    is a pure function of the world hit point: revisits reproduce the same
    pixels, which is what appearance-based loop detection needs."""
    depth, p = render_hit_points(E_w2c, K, hw)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.55 + 0.25 * np.sin(3.1 * x + 1.7 * y) + 0.2 * np.sin(9.3 * y + 0.5)
    g = 0.5 + 0.3 * np.sin(2.3 * y + 4.1 * z + 1.1) + 0.15 * np.sin(11.7 * x)
    b = 0.5 + 0.25 * np.sin(5.2 * z + 2.9 * x + 2.3) + 0.2 * np.sin(7.1 * (x + y + z))
    shade = 1.0 / (1.0 + 0.12 * depth * depth)  # inverse-square-ish falloff
    img = np.stack([r, g, b], -1) * shade[..., None]
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def render_rgb_sequence(
    poses_w2c: np.ndarray, K: np.ndarray, hw: tuple[int, int]
) -> np.ndarray:
    """[N, H, W, 3] uint8 textured frames for a pose sequence."""
    return np.stack([render_rgb(E, K, hw) for E in poses_w2c])


def default_intrinsics(hw: tuple[int, int], fov_scale: float = 1.2) -> np.ndarray:
    H, W = hw
    f = fov_scale * max(H, W)
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


def make_loop_trajectory(n_frames: int, seed: int = 0) -> np.ndarray:
    """w2c trajectory that wanders away and RETURNS to its start: frames
    near the two ends see the same walls from the same poses (a genuine
    revisit), driving loop detection → gating → pose-graph machinery."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        loop = 0.5 * (1 - np.cos(2 * np.pi * s))  # 0 → 1 → 0, smooth
        ang = 0.22 * loop
        ax = np.array([0.2, 1.0, 0.15])
        ax = ax / np.linalg.norm(ax)
        Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
        R = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * (Kx @ Kx)
        center = loop * np.array([0.55, -0.35, 0.6])
        t = -R @ center
        poses.append(np.concatenate([R, t[:, None]], axis=1))
    return np.stack(poses).astype(np.float64)


def make_trajectory(n_frames: int, seed: int = 0) -> np.ndarray:
    """Smooth w2c trajectory wiggling near the origin, looking at the corner."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        # small smooth rotation
        ang = 0.08 * np.sin(2 * np.pi * s) + 0.03 * s
        ax = np.array([0.3, 1.0, 0.1]) / np.linalg.norm([0.3, 1.0, 0.1])
        Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
        R = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * (Kx @ Kx)
        # camera center moving slowly
        center = np.array([0.3 * s, -0.2 * s, 0.4 * s])
        t = -R @ center
        E = np.concatenate([R, t[:, None]], axis=1)
        poses.append(E)
    return np.stack(poses).astype(np.float64)


class SyntheticDA3:
    """Emits the §2.5 contract from ground-truth geometry.

    ``image`` arguments must be paths whose stem is the global frame index
    (e.g. ``000007.jpg``).
    """

    def __init__(
        self,
        poses_w2c: np.ndarray,  # [T, 3, 4] ground-truth w2c
        hw: tuple[int, int] = (48, 64),
        fx: float = 60.0,
        chunk_scales: list[float] | None = None,
        depth_noise: float = 0.0,
        seed: int = 0,
        textured: bool = False,
        brightness_drift: float = 0.0,
    ):
        self.poses = poses_w2c
        self.hw = hw
        H, W = hw
        self.K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
        self.chunk_scales = chunk_scales
        self.depth_noise = depth_noise
        self.rng = np.random.default_rng(seed)
        self.call_count = 0
        self.textured = textured
        # per-frame illumination drift: frame i renders gamma-warped with
        # gamma = 1 + drift·(i / (T-1)), a MONOTONIC exposure drift over the
        # sequence — a revisit of the SAME pose late in the sequence renders
        # at a different exposure than the first visit, so appearance-based
        # loop retrieval must tolerate a realistic lighting change instead
        # of matching bit-identical thumbnails.  Gamma (not gain): a pure
        # multiplicative gain is removed exactly by the mean-subtract +
        # L2-normalize in frame_descriptor, so it would test nothing.
        self.brightness_drift = brightness_drift

    def inference(self, image, **kwargs):
        from da3slam_tpu_torch.models.da3 import Prediction

        idxs = [int(Path(p).stem) for p in image]
        n = len(idxs)
        H, W = self.hw

        depth = np.stack([render_depth(self.poses[i], self.K, self.hw) for i in idxs])
        if self.depth_noise > 0:
            depth = depth * (1 + self.rng.normal(size=depth.shape).astype(np.float32) * self.depth_noise)

        # chunk-local extrinsics: E_i ∘ E_ref^{-1} with ref = first frame
        E_ref = np.eye(4)
        E_ref[:3] = self.poses[idxs[0]]
        E_ref_inv = np.linalg.inv(E_ref)
        ext_local = np.zeros((n, 3, 4), np.float32)
        for j, i in enumerate(idxs):
            E = np.eye(4)
            E[:3] = self.poses[i]
            ext_local[j] = (E @ E_ref_inv)[:3]

        # per-chunk metric-scale ambiguity
        if self.chunk_scales is not None:
            s = self.chunk_scales[min(self.call_count, len(self.chunk_scales) - 1)]
            depth = depth * s
            ext_local[:, :, 3] *= s

        self.call_count += 1
        if self.textured:
            # world-anchored texture (render_rgb): revisits of the same pose
            # reproduce the same pixels with real structure for thumbnails,
            # descriptors, and preprocess
            images = np.stack([render_rgb(self.poses[i], self.K, self.hw) for i in idxs])
        else:
            # pose-deterministic shaded images (normalised inverse depth, so
            # the per-chunk scale ambiguity does not leak into appearance):
            # revisits of the same pose reproduce the same image, which lets
            # the loop detector run against the synthetic world
            inv = 1.0 / np.maximum(depth, 1e-6)
            inv = inv / inv.max(axis=(1, 2), keepdims=True)
            shade = (inv * 255).astype(np.uint8)
            images = np.repeat(shade[..., None], 3, axis=-1)
        if self.brightness_drift:
            T = max(len(self.poses) - 1, 1)
            gamma = 1.0 + self.brightness_drift * (np.asarray(idxs, np.float64) / T)
            x = images.astype(np.float32) / 255.0
            images = np.clip(
                255.0 * x ** (1.0 / gamma)[:, None, None, None], 0.0, 255.0
            ).astype(np.uint8)
        return Prediction(
            processed_images=images,
            depth=depth.astype(np.float32),
            conf=np.full((n, H, W), 1.5, np.float32),
            extrinsics=ext_local,
            intrinsics=np.tile(self.K[None], (n, 1, 1)).astype(np.float32),
        )


def make_synthetic_image_dir(tmp_path, n_frames: int) -> str:
    d = Path(tmp_path) / "frames"
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n_frames):
        (d / f"{i:06d}.jpg").touch()
    return str(d)
