"""Image path discovery + keyframe decimation (counterpart of
``da3slam_tpu/inout/images.py``; numpy/PIL only)."""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

IMAGE_EXTENSIONS = ("*.png", "*.jpg", "*.jpeg", "*.bmp", "*.tiff", "*.tif")


def load_image_paths(folder: str | Path) -> list[str]:
    """All images in a folder, sorted by the number embedded in the filename."""
    paths: list[str] = []
    for ext in IMAGE_EXTENSIONS:
        paths.extend(glob.glob(os.path.join(str(folder), ext)))

    def extract_number(p: str) -> int:
        digits = "".join(ch for ch in Path(p).stem if ch.isdigit())
        return int(digits) if digits else 0

    paths.sort(key=extract_number)
    return paths


def extract_keyframes(paths: list[str], interval: int) -> list[str]:
    """Every ``interval``-th frame."""
    if interval <= 1:
        return list(paths)
    return list(paths[::interval])


def decode_image(path: str | Path) -> np.ndarray:
    """One image file → ``[H, W, 3]`` uint8 RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_images(paths: list[str]) -> np.ndarray:
    """Decode to a stacked ``[N, H, W, 3]`` uint8 array (host-side)."""
    return np.stack([decode_image(p) for p in paths])
