"""JAX-package parameters → the port's state dict (counterpart of
``da3slam_tpu/models/torch_import.py:export_torch_style``).

``convert(params)`` takes the JAX package's parameter pytree as numpy arrays
(``{"encoder", "dpt", "camera"}``) and returns the DA3/DINOv2-style state
dict that ``DA3Net.load_state_dict(strict=True)`` takes unchanged.  Layouts:
HWIO conv kernels → torch OIHW (ConvTranspose2d: [in, out, kh, kw]),
``[in, out]`` linears → ``[out, in]``, the ``[G, G, D]`` pos-embed →
``[1, 1 + G², D]`` with a leading zero cls row.

The map is linear and takes any pytree shaped like the parameters, so it
also carries ``jax.grad`` gradients into the layout of the port's
``param.grad`` (the training tests compare them that way).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _dpt_name_map() -> list[tuple[tuple, str]]:
    """JAX DPT pytree paths ↔ the released DPT head's module names."""
    m: list[tuple[tuple, str]] = []
    for k in range(4):
        m.append((("project", k), f"depth_head.projects.{k}"))
        m.append((("stage_rn", k), f"depth_head.scratch.layer{k + 1}_rn"))
        for j in range(2):
            for rcu, name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
                m.append((("fusion", k, rcu, j),
                          f"depth_head.scratch.refinenet{k + 1}.{name}.conv{j + 1}"))
        m.append((("fusion", k, "out"), f"depth_head.scratch.refinenet{k + 1}.out_conv"))
    m.append((("head1",), "depth_head.scratch.output_conv1"))
    m.append((("head2",), "depth_head.scratch.output_conv2.0"))
    m.append((("head_out",), "depth_head.scratch.output_conv2.2"))
    return m


# (JAX key under params["dpt"]["resize"], torch base name, is_transposed_conv)
_DPT_RESIZE_MAP = [
    ("r0", "depth_head.resize_layers.0", True),
    ("r1", "depth_head.resize_layers.1", True),
    ("r3", "depth_head.resize_layers.3", False),
]
# (JAX weight key, JAX bias key, torch base name)
_CAMERA_NAME_MAP = [
    ("w1", "b1", "camera_head.mlp.fc1"),
    ("w2", "b2", "camera_head.mlp.fc2"),
    ("w_out", "b_out", "camera_head.out"),
]


def _navigate(tree: Any, path: tuple) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def _t(x, axes=None) -> torch.Tensor:
    a = np.asarray(x, np.float32)
    if axes is not None:
        a = np.transpose(a, axes)
    return torch.from_numpy(np.array(a, np.float32, order="C"))  # a writable copy


def convert(params: Any) -> dict[str, torch.Tensor]:
    """The JAX package's numpy parameter pytree → the port's state dict."""
    enc = params["encoder"]
    sd: dict[str, torch.Tensor] = {
        "patch_embed.proj.weight": _t(enc["patch_embed"]["kernel"], (3, 2, 0, 1)),
        "patch_embed.proj.bias": _t(enc["patch_embed"]["bias"]),
        "cls_token": _t(enc["camera_token"]),
        "register_tokens": _t(enc["register_tokens"]),
        "norm.weight": _t(enc["norm"]["scale"]),
        "norm.bias": _t(enc["norm"]["bias"]),
    }
    pos = np.asarray(enc["pos_embed"], np.float32)
    G, D = pos.shape[0], pos.shape[-1]
    sd["pos_embed"] = _t(np.concatenate([np.zeros((1, 1, D), np.float32),
                                         pos.reshape(1, G * G, D)], axis=1))
    for i, blk in enumerate(enc["blocks"]):
        if "wg" in blk["mlp"]:
            raise NotImplementedError("SwiGLU blocks are not ported yet")
        b = f"blocks.{i}"
        sd[f"{b}.norm1.weight"] = _t(blk["ln1"]["scale"])
        sd[f"{b}.norm1.bias"] = _t(blk["ln1"]["bias"])
        sd[f"{b}.attn.qkv.weight"] = _t(blk["attn"]["qkv_w"], (1, 0))
        sd[f"{b}.attn.qkv.bias"] = _t(blk["attn"]["qkv_b"])
        sd[f"{b}.attn.proj.weight"] = _t(blk["attn"]["proj_w"], (1, 0))
        sd[f"{b}.attn.proj.bias"] = _t(blk["attn"]["proj_b"])
        sd[f"{b}.ls1.gamma"] = _t(blk["ls1"])
        sd[f"{b}.norm2.weight"] = _t(blk["ln2"]["scale"])
        sd[f"{b}.norm2.bias"] = _t(blk["ln2"]["bias"])
        sd[f"{b}.mlp.fc1.weight"] = _t(blk["mlp"]["w1"], (1, 0))
        sd[f"{b}.mlp.fc1.bias"] = _t(blk["mlp"]["b1"])
        sd[f"{b}.mlp.fc2.weight"] = _t(blk["mlp"]["w2"], (1, 0))
        sd[f"{b}.mlp.fc2.bias"] = _t(blk["mlp"]["b2"])
        sd[f"{b}.ls2.gamma"] = _t(blk["ls2"])

    for path, base in _dpt_name_map():
        conv = _navigate(params["dpt"], path)
        sd[f"{base}.weight"] = _t(conv["kernel"], (3, 2, 0, 1))
        sd[f"{base}.bias"] = _t(conv["bias"])
    for ours, base, is_deconv in _DPT_RESIZE_MAP:
        conv = params["dpt"]["resize"][ours]
        sd[f"{base}.weight"] = _t(conv["kernel"], (2, 3, 0, 1) if is_deconv else (3, 2, 0, 1))
        sd[f"{base}.bias"] = _t(conv["bias"])
    cam = params["camera"]
    for w, bias, base in _CAMERA_NAME_MAP:
        sd[f"{base}.weight"] = _t(cam[w], (1, 0))
        sd[f"{base}.bias"] = _t(cam[bias])
    return sd
