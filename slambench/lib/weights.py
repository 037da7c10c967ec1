"""Seeded random weights, made on the device in a few large calls.

Every tensor of a network's state dict is a view into one flat float32
buffer: one ``normal_`` from a generator on the device, then one multiply by
the per-tensor scale and one add of the per-tensor constant.  The
distributions are the port's ``init_params`` ones (truncated normal std 0.02
for the encoder and the camera MLP, He-normal for the DPT convolutions, std
1e-3 and an identity-quaternion bias for the camera output, unit norms, zero
biases), without the truncation, with LayerScale and the DPT head's last
convolution at the configuration's assumed trained values (``assumed``):
at He-normal scale that convolution gives depth and confidence logits of
±100, whose softplus spans e^-100 to 100, where a trained head gives logits of
order 1.  Parameters stay float32: the port casts them to the activation
dtype at each operation.
"""

from __future__ import annotations

import torch

# DPT layers stored as ConvTranspose2d: their weight is [in, out, kh, kw]
_TRANSPOSED = ("depth_head.resize_layers.0.weight", "depth_head.resize_layers.1.weight")


_HEAD_OUT = "depth_head.scratch.output_conv2.2"


def _rule(name: str, shape: tuple[int, ...], assumed: dict) -> tuple[float, float]:
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


def make_state_dict(shapes: dict[str, tuple[int, ...]], assumed: dict,
                    generator: torch.Generator, device: torch.device) -> dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` for every name in ``shapes`` (a state dict's
    names and shapes, in its order), drawn from ``generator`` on ``device``."""
    names = list(shapes)
    sizes = [int(torch.Size(shapes[n]).numel()) for n in names]
    rules = [_rule(n, tuple(shapes[n]), assumed) for n in names]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(generator=generator)
    counts = torch.tensor(sizes, device=device)
    std = torch.tensor([r[0] for r in rules], dtype=torch.float32, device=device)
    const = torch.tensor([r[1] for r in rules], dtype=torch.float32, device=device)
    flat.mul_(torch.repeat_interleave(std, counts, output_size=flat.numel()))
    flat.add_(torch.repeat_interleave(const, counts, output_size=flat.numel()))
    sd = {n: part.view(shapes[n]) for n, part in zip(names, flat.split(sizes))}
    # the identity quaternion (w = 1) of the camera head's output, the depth
    # and confidence logits' offsets, and the pos-embed row of the class
    # token, which the encoder drops
    sd["camera_head.out.bias"][0].fill_(1.0)
    sd[_HEAD_OUT + ".bias"][0].fill_(assumed["dpt_output"]["depth_bias"])
    sd[_HEAD_OUT + ".bias"][1].fill_(assumed["dpt_output"]["conf_bias"])
    sd["pos_embed"][:, 0].zero_()
    return sd
