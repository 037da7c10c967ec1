"""Seeded synthetic frames: a textured room rendered along a smooth camera path.

Frozen copy of ``da3slam_tpu_torch/utils/synthetic.py`` at commit b277bb1
(``PLANES``, ``render_depth``, ``render_hit_points``, ``render_rgb``,
``default_intrinsics``, ``make_trajectory``), transcribed from numpy to torch
so that a whole sequence renders on the device in a few batched calls.  The
trajectory takes its shape from the seed (rotation axis, amplitudes, phase,
direction of travel); the copy's ``make_trajectory`` ignored its seed.  Every
seed gives the same number of frames of the same size: only their content
moves.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# (normal, offset): plane n·p = c in world coordinates; the camera looks
# along +z, so every ray meets one of them
PLANES = ((1.0, 0.0, 0.0, 2.0), (0.0, 1.0, 0.0, 2.0), (0.0, 0.0, 1.0, 4.0))


def default_intrinsics(hw: tuple[int, int], fov_scale: float = 1.2) -> np.ndarray:
    H, W = hw
    f = fov_scale * max(H, W)
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float64)


def _axis_angle(axis: np.ndarray, ang: float) -> np.ndarray:
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + math.sin(ang) * Kx + (1 - math.cos(ang)) * (Kx @ Kx)


def make_trajectory(n_frames: int, seed: int) -> np.ndarray:
    """Smooth w2c ``[n, 3, 4]`` path wiggling near the origin, looking at the
    room's far wall; its shape drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    axis = np.array([0.3, 1.0, 0.1]) + rng.uniform(-0.2, 0.2, 3)
    axis /= np.linalg.norm(axis)
    wiggle, drift, phase = rng.uniform(0.05, 0.1), rng.uniform(0.02, 0.04), rng.uniform(0, 2 * np.pi)
    travel = np.array([0.3, -0.2, 0.4]) * rng.uniform(0.7, 1.3, 3)
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        R = _axis_angle(axis, wiggle * math.sin(2 * math.pi * s + phase) + drift * s)
        t = -R @ (travel * s)
        poses.append(np.concatenate([R, t[:, None]], axis=1))
    return np.stack(poses)


def render_rgb(poses: torch.Tensor, K: np.ndarray, hw: tuple[int, int]) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` textured frames of the room for w2c ``poses
    [N, 3, 4]`` (float64, on the device): a smooth world-anchored pattern and
    Lambert-like falloff, as the original's ``render_rgb``."""
    H, W = hw
    dev = poses.device
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                          torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    rays = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], torch.ones_like(u)], -1)
    R, t = poses[:, :, :3], poses[:, :, 3]
    depth = torch.full((poses.shape[0], H, W), torch.inf, dtype=torch.float64, device=dev)
    Rt_t = torch.einsum("nji,nj->ni", R, t)  # R^T t
    for nx, ny, nz, c in PLANES:
        n = torch.tensor([nx, ny, nz], dtype=torch.float64, device=dev)
        denom = torch.einsum("hwk,nk->nhw", rays, R @ n)
        num = c + Rt_t @ n
        z = num[:, None, None] / denom
        z = torch.where(z > 0.05, z, torch.inf)
        depth = torch.minimum(depth, z)
    cam = rays[None] * depth[..., None]
    p = torch.einsum("nhwk,nkj->nhwj", cam - t[:, None, None, :], R)  # R^T (p - t)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.55 + 0.25 * torch.sin(3.1 * x + 1.7 * y) + 0.2 * torch.sin(9.3 * y + 0.5)
    g = 0.5 + 0.3 * torch.sin(2.3 * y + 4.1 * z + 1.1) + 0.15 * torch.sin(11.7 * x)
    b = 0.5 + 0.25 * torch.sin(5.2 * z + 2.9 * x + 2.3) + 0.2 * torch.sin(7.1 * (x + y + z))
    shade = 1.0 / (1.0 + 0.12 * depth * depth)
    img = torch.stack([r, g, b], -1) * shade[..., None]
    return (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8)


def render_sequence(n_frames: int, seed: int, hw: tuple[int, int], device,
                    batch: int = 32) -> np.ndarray:
    """``[n, H, W, 3]`` uint8 frames along ``make_trajectory(n, seed)``,
    rendered on ``device`` a batch at a time."""
    poses = torch.as_tensor(make_trajectory(n_frames, seed), device=device)
    K = default_intrinsics(hw)
    out = [render_rgb(poses[a:a + batch], K, hw).cpu() for a in range(0, n_frames, batch)]
    return torch.cat(out).numpy()


def order_indices(traffic: dict) -> list[int]:
    """The rendered frames' indices in the order of ``traffic["order"]``, a list
    of ``[first, last]`` segments of the rendered path, each taken inclusively
    and backwards where ``last < first`` (``[[0, 149], [149, 0]]``: out and
    back along the same views)."""
    out = []
    for a, b in traffic["order"]:
        step = 1 if b >= a else -1
        out += range(a, b + step, step)
    return out


def ordered(traffic: dict, seed: int, device) -> list[np.ndarray]:
    """A traffic file's frames: ``traffic["frames"]`` rendered along the path
    drawn from ``seed`` at ``traffic["hw"]``, in the order of ``order_indices``."""
    pixels = render_sequence(traffic["frames"], seed, tuple(traffic["hw"]), device)
    return [pixels[i] for i in order_indices(traffic)]


def write_jpegs(frames, folder: Path, quality: int, workers: int = 4) -> list[Path]:
    """Each frame as ``folder/NNNNNN.jpg`` (PIL, the given quality), as
    ``cli/main_video.py`` writes extracted frames."""
    from PIL import Image

    folder.mkdir(parents=True, exist_ok=True)
    paths = [folder / f"{i:06d}.jpg" for i in range(len(frames))]

    def save(i: int) -> None:
        Image.fromarray(frames[i]).save(paths[i], quality=quality)

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(save, range(len(frames))))
    return paths
