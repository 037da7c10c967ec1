"""Full SLAM loop CLI (counterpart of ``da3slam_tpu/cli/main_slam.py``).

    python -m da3slam_tpu_torch.cli.main_slam --image_dir D --output_dir O --headless

Same flags as the JAX package's CLI, plus ``--device`` (default ``cuda``).
The run happens on that device or not at all: there is no fallback to the
CPU.  Without ``--headless`` the solver opens the viser viewer (headless,
with a message, where ``viser`` is missing) and the process stays alive
after the run while the viewer is attached (ctrl-c ends it).  A config with
``Loop.enable: true`` turns on online loop closure.
"""

from __future__ import annotations

import argparse
import time

import torch

# the run's configuration when no --config is given
DEFAULT_CONFIG = {
    "Weights": {"DA3": "small"},
    "Model": {"chunk_size": 15, "overlap_size": 1, "keyframe_interval": 1,
              "sleep_between_chunk": 0, "port": 8080},
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DA3-SLAM (PyTorch/CUDA port)")
    p.add_argument("--image_dir", required=True, help="directory of frames")
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--output_dir", default=None, help="export trajectory here")
    p.add_argument("--headless", action="store_true", help="disable the viewer")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None):
    """Run the CLI; returns the ``SLAMSolver`` that ran (for callers that
    read its state, such as the loop closer's attempts)."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")

    from da3slam_tpu_torch.inout import load_config, save_camera_poses
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    config = load_config(args.config) if args.config else DEFAULT_CONFIG
    solver = SLAMSolver(args.image_dir, config, viewer=None if args.headless else "auto",
                        device=device)
    solver.run()

    if args.output_dir:
        poses, intrs = solver.trajectory()
        save_camera_poses(args.output_dir, poses, intrs)
        print(f"Trajectory ({len(poses)} frames) exported to {args.output_dir}")

    if solver.viewer is not None:
        print("SLAM finished; viewer still running (ctrl-c to exit)")
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
    return solver


if __name__ == "__main__":
    main()
