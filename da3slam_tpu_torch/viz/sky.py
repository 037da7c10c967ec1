"""Sky segmentation for outdoor demo scenes (counterpart of
``da3slam_tpu/viz/sky.py``; numpy on the host): zero the confidence of sky
pixels before display.

A dependency-free heuristic: sky pixels are bright, blue-dominant or
low-saturation, and connected to the top image edge.  The flood is a
top-edge connected-component pass (per-row candidate runs are labelled and
kept iff seeded from the row above), so one dark pixel does not shadow
everything below it and sky grows sideways around foreground objects.  An
ONNX model path uses a learned model where ``onnxruntime`` is installed (it
is imported only then), else the heuristic.
"""

from __future__ import annotations

import numpy as np


def _flood_row(cand: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """Keep the connected runs of ``cand`` (bool [W]) containing a seed."""
    if not seed.any():
        return np.zeros_like(cand)
    starts = cand & ~np.concatenate(([False], cand[:-1]))
    run_id = np.cumsum(starts) * cand  # 0 outside candidates
    seeded = np.zeros(int(run_id.max()) + 1, bool)
    seeded[run_id[seed & cand]] = True
    seeded[0] = False
    return seeded[run_id]


def sky_mask_heuristic(image: np.ndarray, horizon: float = 0.6) -> np.ndarray:
    """``[H, W, 3]`` uint8 RGB → bool mask (True = sky).

    Candidates = blueish or washed-out bright pixels; the mask is the subset
    of candidates 4/8-connected to the top edge, found with one vectorized
    top-down sweep (per-row run labelling seeded by the dilated row above).
    Rows below ``horizon``·H are never sky.
    """
    img = np.asarray(image, np.float32) / 255.0
    H, W, _ = img.shape
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = img.max(-1)
    sat = (img.max(-1) - img.min(-1)) / np.maximum(img.max(-1), 1e-6)

    blueish = (b >= r - 0.02) & (b >= g - 0.02) & (v > 0.45)
    washed = (v > 0.75) & (sat < 0.25)  # overcast / near-white sky
    cand = blueish | washed

    mask = np.zeros((H, W), bool)
    limit = min(int(H * horizon), H)
    if limit == 0:
        return mask
    mask[0] = cand[0]
    for y in range(1, limit):
        seed = mask[y - 1]
        # 8-connectivity: dilate the seed row one pixel sideways
        seed = seed | np.concatenate((seed[1:], [False])) | np.concatenate(
            ([False], seed[:-1])
        )
        mask[y] = _flood_row(cand[y], seed)
        if not mask[y].any():
            break  # sky is top-connected; nothing below can reconnect
    return mask


def apply_sky_segmentation(
    conf: np.ndarray, images: np.ndarray, onnx_model_path: str | None = None
) -> np.ndarray:
    """Zero the confidence of sky pixels.

    ``conf``: ``[N, H, W]``; ``images``: ``[N, H, W, 3]`` uint8.
    """
    conf = np.asarray(conf).copy()
    masks = None
    if onnx_model_path is not None:
        masks = _onnx_sky_masks(images, onnx_model_path)
    if masks is None:
        masks = np.stack([sky_mask_heuristic(im) for im in images])
    conf[masks] = 0.0
    return conf


def _onnx_sky_masks(images: np.ndarray, model_path: str) -> np.ndarray | None:
    """Run a learned skyseg ONNX model: NCHW float input in [0, 1] →
    [N, 1, H, W] logits; >0.5 = sky.
    Returns None (heuristic fallback) when onnxruntime or the model is
    unavailable."""
    try:
        import onnxruntime as ort  # optional
    except ImportError as e:
        print(f"onnx skyseg unavailable ({e}); using heuristic")
        return None
    try:
        sess = ort.InferenceSession(model_path)
        inp = sess.get_inputs()[0]
        x = np.asarray(images, np.float32).transpose(0, 3, 1, 2) / 255.0
        out = sess.run(None, {inp.name: x})[0]
        return np.asarray(out).reshape(len(images), *images.shape[1:3]) > 0.5
    except Exception as e:  # model missing / shape mismatch → degrade
        print(f"onnx skyseg failed ({e}); using heuristic")
        return None
