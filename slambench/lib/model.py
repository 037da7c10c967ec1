"""A configuration file → the port's model with the benchmark's weights, and
the same weights for the reference.

The networks are built on the meta device and take the benchmark's tensors
by ``load_state_dict(strict=True, assign=True)``, so no parameter is made
twice and none is copied.
"""

from __future__ import annotations

import dataclasses

import torch

from slambench.lib.weights import make_state_dict

# the keys of a backbone block that are ModelConfig fields of the port
_TUPLE_KEYS = ("dpt_layers", "dpt_features")


def submodels(config: dict) -> list[tuple[str, dict]]:
    """``[(role, backbone dict)]``: one any-view model, or the nested tier's
    any-view and metric models."""
    if config["kind"] == "nested":
        return [("anyview", config["anyview"]), ("metric", config["metric"])]
    return [("anyview", config["backbone"])]


def reference_cfg(backbone: dict) -> dict:
    return {**backbone, "dpt_layers": tuple(backbone["dpt_layers"])}


def _port_cfg(backbone: dict):
    from da3slam_tpu_torch.models.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if k in _TUPLE_KEYS else v for k, v in backbone.items() if k in fields}
    return ModelConfig(**kw)


@dataclasses.dataclass
class Built:
    model: object  # DepthAnything3 or DepthAnything3Nested
    state_dicts: dict[str, dict[str, torch.Tensor]]  # role -> the weights, shared with the port
    ref_cfgs: dict[str, dict]  # role -> the reference's backbone dict
    act: torch.dtype  # the dtype the port stores activations in on this device


def build(config: dict, seed: int, device: torch.device) -> Built:
    """The configuration's model on ``device`` with weights drawn from ``seed``
    (one generator on the device, the submodels in order)."""
    from da3slam_tpu_torch.models.da3 import DA3Net, DepthAnything3

    gen = torch.Generator(device).manual_seed(seed)
    dtype = getattr(torch, config["dtype"]) if device.type == "cuda" else None
    parts, sds, cfgs = {}, {}, {}
    for role, backbone in submodels(config):
        cfg = _port_cfg(backbone)
        with torch.device("meta"):
            net = DA3Net(cfg)
        shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        sd = make_state_dict(shapes, config["assumed"], gen, device)
        net.load_state_dict(sd, strict=True, assign=True)
        parts[role] = DepthAnything3(cfg, net, dtype)
        sds[role], cfgs[role] = sd, reference_cfg(backbone)
    if config["kind"] == "nested":
        from da3slam_tpu_torch.models.nested import DepthAnything3Nested

        model = DepthAnything3Nested(parts["anyview"], parts["metric"])
    else:
        model = parts["anyview"]
    return Built(model, sds, cfgs, parts["anyview"].dtype)


def reference_forward(built_sds: dict, ref_cfgs: dict, raw: torch.Tensor, process_res: int,
                      act: torch.dtype) -> dict:
    """The plain reference over one chunk of uint8 views, activations stored
    in ``act``."""
    from slambench.reference import model as ref

    if "metric" in built_sds:
        return ref.forward_nested(built_sds["anyview"], ref_cfgs["anyview"], built_sds["metric"],
                                  ref_cfgs["metric"], raw, process_res, act)
    return ref.forward(built_sds["anyview"], ref_cfgs["anyview"], raw, process_res, act)


def chunk_flops(config: dict, views: int, hw: tuple[int, int], process_res: int) -> float:
    """Operations of one chunk as the plain reference computes them (matmuls
    and convolutions, ``FlopCounterMode`` on the meta device): the any-view
    model over ``views`` views, and the metric model over one."""
    from torch.utils.flop_counter import FlopCounterMode

    from slambench.reference import model as ref

    total = 0
    for role, backbone in submodels(config):
        with torch.device("meta"):
            from da3slam_tpu_torch.models.da3 import DA3Net

            net = DA3Net(_port_cfg(backbone))
        sd = {k: torch.empty(v.shape, device="meta") for k, v in net.state_dict().items()}
        n = views if role == "anyview" else 1
        raw = torch.empty((n, *hw, 3), dtype=torch.uint8, device="meta")
        with FlopCounterMode(display=False) as counter:
            ref.forward(sd, reference_cfg(backbone), raw, process_res)
        total += counter.get_total_flops()
    return float(total)
