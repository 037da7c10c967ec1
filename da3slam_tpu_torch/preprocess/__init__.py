"""Frame-ingest preprocessing (counterpart of ``da3slam_tpu/preprocess``).

Host side (``preprocess.host``): video decode and the folder passes.  Device
side (``preprocess.device``): the per-frame pixel pipeline (ratio-square crop,
LAB-space brightness normalisation, resize, ImageNet normalisation) over
frame batches.
"""

from da3slam_tpu_torch.preprocess.device import (  # noqa: F401
    adjust_brightness,
    clahe,
    crop_square,
    lab_to_rgb,
    preprocess_batch,
    rgb_to_lab,
)
