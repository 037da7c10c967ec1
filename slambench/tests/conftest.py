"""Fixtures of the benchmark's tests: a ``tiny`` cell defined in files of a
temporary benchmark folder, and the card check for tests marked ``cuda``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from slambench.lib.spec import BENCH_DIR, load_benchmark

TINY_BACKBONE = {
    "patch_size": 14, "embed_dim": 32, "depth": 4, "num_heads": 2, "mlp_ratio": 4.0,
    "num_register_tokens": 1, "cross_view_interval": 2, "mlp_type": "mlp", "base_grid": 37,
    "dpt_layers": [0, 1, 2, 3], "dpt_dim": 16, "dpt_features": [8, 16, 24, 32], "camera_dim": 32,
}
ASSUMED = json.loads((BENCH_DIR / "configs" / "da3-small.json").read_text())["assumed"]
# float32 on the CPU against the reference in float32: rounding only (sound
# runs read at most 3e-7, and the alignment's copy reproduces the port's bit
# for bit)
TINY_LIMITS = {"depth_rel": 1e-5, "conf_rel": 1e-5, "desc_rel": 1e-5, "pose_gap": 1e-5,
               "intrinsics_rel": 1e-5, "align_gap": 1e-7}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tiny_bench(tmp_path: Path):
    """A copy of the benchmark folder's data files plus ``tiny-offline`` and
    ``tiny-live`` cells (a ``tiny`` configuration, 7-frame sequences, chunk
    4: two chunks a sequence, both kept for the comparison), added as new
    files only.  Returns (BENCHMARK dict, folder)."""
    for sub in ("configs", "kinds", "traffic", "drivers", "workloads"):
        shutil.copytree(BENCH_DIR / sub, tmp_path / sub)
    config = {"name": "tiny", "source": "test size", "reduced": [], "kind": "da3",
              "dtype": "bfloat16", "backbone": TINY_BACKBONE, "assumed": ASSUMED}
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(config))
    orders = {"offline": [[0, 6]], "live": [[0, 6], [5, 1]]}
    for mode in ("offline", "live"):
        (tmp_path / "traffic" / f"tiny-{mode}.json").write_text(json.dumps(
            {"driver": mode, "frames": 7, "order": orders[mode], "hw": [518, 518],
             "process_res": 504, "jpeg_quality": 95}))
        settings = json.loads((BENCH_DIR / "workloads" / "small-live.json").read_text())
        settings["solver"]["Model"]["chunk_size"] = 4
        # every chunk due in the live session is compared
        settings.update(rate_fps=4.0, compare_chunks=8, trace_skip_chunks=1, trace_slice_chunks=2,
                        limits=TINY_LIMITS)
        (tmp_path / "workloads" / f"tiny-{mode}.json").write_text(json.dumps(settings))
    bench = load_benchmark()
    bench["workloads"] += [{"name": f"tiny-{m}", "config": "tiny", "traffic": f"tiny-{m}",
                            "chips": 1, "why": "test size"} for m in ("offline", "live")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            twin = "tiny-live" if "small-live" in m["workloads"] else "tiny-offline"
            m["workloads"].append(twin)
    return bench, tmp_path
