"""Debug colours (counterpart of ``da3slam_tpu/viz/debug.py``): a distinct
colour per chunk and a tint of a chunk's frames with it — the eyeball check
that chunk alignment is right (``cli/main_align.py --debug_color``)."""

from __future__ import annotations

import colorsys

import numpy as np


def get_distinct_color(index: int, saturation: float = 0.85,
                       value: float = 0.95) -> tuple[int, int, int]:
    """A deterministic, well-separated RGB colour for chunk ``index``
    (golden-ratio hue steps)."""
    hue = (index * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(hue, saturation, value)
    return int(r * 255), int(g * 255), int(b * 255)


def apply_chunk_color_to_images_batch(images: np.ndarray, chunk_index: int,
                                      blend: float = 0.6) -> np.ndarray:
    """Tint ``[N, H, W, 3]`` uint8 frames with the chunk's colour; ``blend``
    1 gives a solid fill, lower keeps the image visible."""
    color = np.asarray(get_distinct_color(chunk_index), np.float32)
    out = np.asarray(images, np.float32) * (1 - blend) + color * blend
    return np.clip(out, 0, 255).astype(np.uint8)
