"""Host-side I/O: config loading, image paths and decode, trajectory and PLY export."""

from da3slam_tpu_torch.inout.config import load_config, update_recursive  # noqa: F401
from da3slam_tpu_torch.inout.images import (  # noqa: F401
    decode_image,
    extract_keyframes,
    load_image_paths,
)
from da3slam_tpu_torch.inout.ply import write_ply  # noqa: F401
from da3slam_tpu_torch.inout.trajectory import save_camera_poses  # noqa: F401
