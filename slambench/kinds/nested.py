"""The nested tier (the port's ``models/nested.py:DepthAnything3Nested``): a
DA3 any-view network (``anyview``) over every view of a chunk and a DA3
metric network (``metric``) on the chunk's reference view, whose depth gives
the chunk its metric scale.  Both are built as ``kinds/da3.py`` builds one,
from one generator, the any-view network first.
"""

from __future__ import annotations

from pathlib import Path

import torch

from slambench.lib.model import Built, kind

da3 = kind("da3", Path(__file__).resolve().parents[1])

CONTROLS = ("w8a8", "fp8", "tf32-align")


def build(config: dict, seed: int, device: torch.device) -> Built:
    from da3slam_tpu_torch.models.nested import DepthAnything3Nested

    gen = torch.Generator(device).manual_seed(seed)
    dtype = da3.serve_dtype(config, device)
    anyview, sd_any = da3.network(config["anyview"], config["assumed"], gen, device, dtype)
    metric, sd_metric = da3.network(config["metric"], config["assumed"], gen, device, dtype)
    return Built(DepthAnything3Nested(anyview, metric), {"anyview": sd_any, "metric": sd_metric},
                 {"anyview": da3.reference_cfg(config["anyview"]),
                  "metric": da3.reference_cfg(config["metric"])}, anyview.dtype)


def reference_forward(built: Built, raw: torch.Tensor, process_res: int, act: torch.dtype) -> dict:
    from slambench.reference import model as ref

    sds, cfgs = built.state_dicts, built.ref_cfgs
    return ref.forward_nested(sds["anyview"], cfgs["anyview"], sds["metric"], cfgs["metric"], raw,
                              process_res, act)


def chunk_flops(config: dict, views: int, hw: tuple[int, int], process_res: int) -> float:
    """The any-view network over ``views`` views and the metric one over one."""
    return float(da3.network_flops(config["anyview"], views, hw, process_res)
                 + da3.network_flops(config["metric"], 1, hw, process_res))
