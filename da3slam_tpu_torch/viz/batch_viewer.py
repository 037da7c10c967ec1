"""One-shot scene viewer: a whole Prediction at once (counterpart of
``da3slam_tpu/viz/batch_viewer.py``).  The adapter feeds the same
``SLAMViewer`` as the live solver, so there is one viewer implementation.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def prediction_to_viewer_dict(prediction, extrinsics_global=None) -> dict:
    """A Prediction (numpy arrays, or tensors with ``keep_on_device``) → the
    flat dict of host arrays the viewer takes."""
    ext = extrinsics_global if extrinsics_global is not None else prediction.extrinsics
    return {
        "images": _host(prediction.processed_images),
        "depth": _host(prediction.depth),
        "conf": _host(prediction.conf),
        "extrinsics": _host(ext).astype(np.float32),
        "intrinsics": _host(prediction.intrinsics),
    }


def show_prediction(
    prediction,
    extrinsics_global=None,
    port: int = 8080,
    point_stride: int = 4,
    block: bool = True,
    mask_sky: bool = False,
    sky_onnx_path: str | None = None,
    device: str | torch.device = "cuda",
):
    """Open a viewer and load every frame of a prediction (one batch: the
    geometry on ``device``, one transfer back).

    ``mask_sky`` zeroes the confidence of sky pixels before display
    (``viz/sky.py``: the top-connected flood heuristic, or an ONNX model).
    Returns the viewer, or None where ``viser`` is missing.
    """
    from da3slam_tpu_torch.viz.viewer import SLAMViewer

    try:
        viewer = SLAMViewer(port=port, point_stride=point_stride, device=device)
    except ImportError as e:
        print(f"viser unavailable ({e}); cannot open the viewer")
        return None

    scene = prediction_to_viewer_dict(prediction, extrinsics_global)
    if mask_sky:
        from da3slam_tpu_torch.viz.sky import apply_sky_segmentation

        scene["conf"] = apply_sky_segmentation(
            scene["conf"], scene["images"], onnx_model_path=sky_onnx_path
        )
    viewer.add_frames(scene["images"], scene["depth"], scene["conf"], scene["extrinsics"],
                      scene["intrinsics"])
    if block:
        viewer.keep_alive()
    return viewer
