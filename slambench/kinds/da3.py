"""DA3: one DepthAnything3 network (the port's ``models/da3.py:DA3Net``), a
DINOv2 ViT whose every ``cross_view_interval``-th block attends across the
views of a chunk, a DPT depth and confidence head and a camera head.  The
configuration's ``backbone`` holds its sizes as ``ModelConfig`` fields.

Weights follow the port's ``init_params`` distributions (truncated normal
std 0.02 for the encoder and the camera MLP, He-normal for the DPT
convolutions, std 1e-3 and an identity-quaternion bias for the camera
output, unit norms, zero biases), without the truncation, with LayerScale
and the DPT head's last convolution at the configuration's assumed trained
values (``assumed``): at He-normal scale that convolution gives depth and
confidence logits of ±100, whose softplus spans e^-100 to 100, where a
trained head gives logits of order 1.  Parameters stay float32: the port
casts them to the activation dtype at each operation.
"""

from __future__ import annotations

import dataclasses

import torch

from slambench.lib.model import Built
from slambench.lib.weights import make_state_dict

CONTROLS = ("w8a8", "fp8", "tf32-align")

# the keys of a backbone block that are ModelConfig fields of the port
_TUPLE_KEYS = ("dpt_layers", "dpt_features")
# DPT layers stored as ConvTranspose2d: their weight is [in, out, kh, kw]
_TRANSPOSED = ("depth_head.resize_layers.0.weight", "depth_head.resize_layers.1.weight")
_HEAD_OUT = "depth_head.scratch.output_conv2.2"


def reference_cfg(backbone: dict) -> dict:
    return {**backbone, "dpt_layers": tuple(backbone["dpt_layers"])}


def port_cfg(backbone: dict):
    from da3slam_tpu_torch.models.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if k in _TUPLE_KEYS else v for k, v in backbone.items() if k in fields}
    return ModelConfig(**kw)


def rule(name: str, shape: tuple[int, ...], assumed: dict) -> tuple[float, float]:
    """(std, constant) of one tensor: ``value = std · N(0, 1) + constant``."""
    if name.endswith(("ls1.gamma", "ls2.gamma")):
        return 0.0, assumed["layerscale"]
    if name.endswith(".bias"):
        return 0.0, 0.0
    if name.endswith(".weight") and len(shape) == 1 and "norm" in name.split(".")[-2]:
        return 0.0, 1.0
    if name.startswith("depth_head.") and len(shape) == 4:
        fan_in = (shape[0] if name in _TRANSPOSED else shape[1]) * shape[2] * shape[3]
        gain = assumed["dpt_output"]["weight_gain"] if name == _HEAD_OUT + ".weight" else 1.0
        return gain * (2.0 / fan_in) ** 0.5, 0.0
    if name == "camera_head.out.weight":
        return 1e-3, 0.0
    return 0.02, 0.0


def network(backbone: dict, assumed: dict, generator: torch.Generator, device: torch.device,
            dtype: torch.dtype | None):
    """One DA3 network on ``device``, its weights drawn next from
    ``generator``: ``(DepthAnything3, state dict)``."""
    from da3slam_tpu_torch.models.da3 import DA3Net, DepthAnything3

    cfg = port_cfg(backbone)
    with torch.device("meta"):
        net = DA3Net(cfg)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    sd = make_state_dict(shapes, lambda n, s: rule(n, s, assumed), generator, device)
    # the identity quaternion (w = 1) of the camera head's output, the depth
    # and confidence logits' offsets, and the pos-embed row of the class
    # token, which the encoder drops
    sd["camera_head.out.bias"][0].fill_(1.0)
    sd[_HEAD_OUT + ".bias"][0].fill_(assumed["dpt_output"]["depth_bias"])
    sd[_HEAD_OUT + ".bias"][1].fill_(assumed["dpt_output"]["conf_bias"])
    sd["pos_embed"][:, 0].zero_()
    net.load_state_dict(sd, strict=True, assign=True)
    return DepthAnything3(cfg, net, dtype), sd


def serve_dtype(config: dict, device: torch.device) -> torch.dtype | None:
    """The configuration's activation dtype on a card; the port's own choice
    on the CPU."""
    return getattr(torch, config["dtype"]) if device.type == "cuda" else None


def build(config: dict, seed: int, device: torch.device) -> Built:
    gen = torch.Generator(device).manual_seed(seed)
    model, sd = network(config["backbone"], config["assumed"], gen, device,
                        serve_dtype(config, device))
    return Built(model, {"anyview": sd}, {"anyview": reference_cfg(config["backbone"])},
                 model.dtype)


def reference_forward(built: Built, raw: torch.Tensor, process_res: int, act: torch.dtype) -> dict:
    from slambench.reference import model as ref

    return ref.forward(built.state_dicts["anyview"], built.ref_cfgs["anyview"], raw, process_res,
                       act)


def network_flops(backbone: dict, views: int, hw: tuple[int, int], process_res: int) -> int:
    """The reference's matmul and convolution operations of one DA3 network
    over ``views`` views, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from da3slam_tpu_torch.models.da3 import DA3Net
    from slambench.reference import model as ref

    with torch.device("meta"):
        net = DA3Net(port_cfg(backbone))
    sd = {k: torch.empty(v.shape, device="meta") for k, v in net.state_dict().items()}
    raw = torch.empty((views, *hw, 3), dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.forward(sd, reference_cfg(backbone), raw, process_res)
    return counter.get_total_flops()


def chunk_flops(config: dict, views: int, hw: tuple[int, int], process_res: int) -> float:
    return float(network_flops(config["backbone"], views, hw, process_res))
