"""Image resizing + normalisation for model ingest (counterpart of
``da3slam_tpu/ops/resize.py``): the reference's ``upper_bound_resize``,
aspect-preserving so the max side ≤ process_res, snapped to patch multiples.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def upper_bound_shape(h: int, w: int, process_res: int = 504, patch: int = 14) -> tuple[int, int]:
    """Target (H, W): scale so max side ≤ process_res, floor-snap to patch
    multiples (518×518 at process_res 504 gives the 36×36 ViT-14 grid)."""
    scale = process_res / max(h, w)
    th = max(int(h * scale) // patch, 1) * patch
    tw = max(int(w * scale) // patch, 1) * patch
    return th, tw


def _stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # filled on the device: torch.tensor(list, device=cuda), like t[i] = 0.5,
    # copies from pageable host memory, which waits for the stream
    def const(values):
        return torch.stack([torch.full((), v, dtype=torch.float32, device=x.device)
                            for v in values])

    return const(IMAGENET_MEAN), const(IMAGENET_STD)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Float ``[N, H, W, C]`` → ``[N, *out_hw, C]``, bilinear with
    antialiasing, as ``jax.image.resize(..., "bilinear")`` does: on a
    downscale (the 518→504 ingest) the triangle filter widens by the scale
    factor; plain ``F.interpolate`` bilinear would not."""
    if (x.shape[1], x.shape[2]) == tuple(out_hw):
        return x
    return F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
        align_corners=False, antialias=True,
    ).permute(0, 2, 3, 1)


def resize_normalize(images: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``[N, H, W, 3]`` uint8/float RGB → resized (:func:`resize_bilinear`),
    ImageNet-normalised f32 NHWC."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0
    x = resize_bilinear(x, out_hw)
    mean, std = _stats(x)
    return (x - mean) / std


def denormalize_to_uint8(images: torch.Tensor) -> torch.Tensor:
    """Inverse of the ``resize_normalize`` normalisation → uint8 RGB."""
    mean, std = _stats(images)
    x = (images * std + mean) * 255.0
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
