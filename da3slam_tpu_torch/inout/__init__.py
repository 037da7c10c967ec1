"""Host-side I/O: config loading, image paths and decode, trajectory and PLY export."""

from da3slam_tpu_torch.inout.config import load_config, update_recursive  # noqa: F401
from da3slam_tpu_torch.inout.images import (  # noqa: F401
    decode_image,
    extract_keyframes,
    load_image_paths,
    load_images,
)
from da3slam_tpu_torch.inout.ply import merge_ply_files, read_ply, write_ply  # noqa: F401
from da3slam_tpu_torch.inout.trajectory import (  # noqa: F401
    load_camera_poses,
    load_trajectory,
    save_camera_poses,
)
