"""VGGT: the port's ``models/vggt.py:VGGT`` (VGGT-1B), a DINOv2 ViT-L/14
patch embed, 24 frame and 24 global blocks with QK-norm and 2D RoPE, a DPT
depth head on 2048-wide taps and an adaLN camera head.  The configuration's
``network`` holds its sizes as ``VGGTConfig`` fields; its plain reference is
``reference/vggt.py``.

Weights (one generator, by VGGT's parameter names): normal, std
0.02 for every linear layer, token and position grid, unit norms, zero
biases, He-normal depth-head convolutions, with the trained values the
configuration assumes (``assumed``): LayerScale 0.1; the depth head's last
convolution at 0.01 of He-normal with logit offsets, since ``exp`` of
He-normal logits (±100) overflows; the camera's last layer at std 1e-3 with
a bias on the quaternion's w and on both fields of view, which the summed
iterations bring to the identity and to ~1 rad.  Parameters stay float32:
the port casts them to the activation dtype at each operation.

The port's module is imported in ``build``: a program without it fails
there, in set-up, with no result.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from slambench.lib.model import Built, kind
from slambench.lib.weights import make_state_dict

da3 = kind("da3", Path(__file__).resolve().parents[1])

CONTROLS = ("fp8", "tf32-align")  # no W8A8 path

_TUPLE_KEYS = ("dpt_layers", "dpt_features")
# DPT layers stored as ConvTranspose2d: their weight is [in, out, kh, kw]
_TRANSPOSED = ("depth_head.resize_layers.0.weight", "depth_head.resize_layers.1.weight")
_HEAD_OUT = "depth_head.scratch.output_conv2.2"
_POSE_OUT = "camera_head.pose_branch.fc2"


def reference_cfg(network: dict) -> dict:
    return {**network, "dpt_layers": tuple(network["dpt_layers"])}


def port_cfg(network: dict):
    from da3slam_tpu_torch.models.vggt import VGGTConfig

    fields = {f.name for f in dataclasses.fields(VGGTConfig)}
    return VGGTConfig(**{k: tuple(v) if k in _TUPLE_KEYS else v
                         for k, v in network.items() if k in fields})


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
    if name == _POSE_OUT + ".weight":
        return assumed["camera_output"]["weight_std"], 0.0
    return 0.02, 0.0


def build(config: dict, seed: int, device: torch.device) -> Built:
    from da3slam_tpu_torch.models.vggt import VGGT, VGGTNet

    cfg = port_cfg(config["network"])
    assumed = config["assumed"]
    with torch.device("meta"):
        net = VGGTNet(cfg)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    gen = torch.Generator(device).manual_seed(seed)
    sd = make_state_dict(shapes, lambda n, s: rule(n, s, assumed), gen, device)
    cam = assumed["camera_output"]
    sd[_POSE_OUT + ".bias"][6].fill_(cam["quat_w_bias"])
    sd[_POSE_OUT + ".bias"][7:9].fill_(cam["fov_bias"])
    sd[_HEAD_OUT + ".bias"][0].fill_(assumed["dpt_output"]["depth_bias"])
    sd[_HEAD_OUT + ".bias"][1].fill_(assumed["dpt_output"]["conf_bias"])
    net.load_state_dict(sd, strict=True, assign=True)
    model = VGGT(cfg, net, da3.serve_dtype(config, device))
    return Built(model, {"vggt": sd}, {"vggt": reference_cfg(config["network"])}, model.dtype)


def reference_forward(built: Built, raw: torch.Tensor, process_res: int, act: torch.dtype) -> dict:
    from slambench.reference import vggt as ref

    return ref.forward(built.state_dicts["vggt"], built.ref_cfgs["vggt"], raw, process_res, act)


def chunk_flops(config: dict, views: int, hw: tuple[int, int], process_res: int) -> float:
    """The reference's matmul and convolution operations over ``views``
    views, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from da3slam_tpu_torch.models.vggt import VGGTNet
    from slambench.reference import vggt as ref

    with torch.device("meta"):
        sd = VGGTNet(port_cfg(config["network"])).state_dict()
    raw = torch.empty((views, *hw, 3), dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.forward(sd, reference_cfg(config["network"]), raw, process_res)
    return float(counter.get_total_flops())
