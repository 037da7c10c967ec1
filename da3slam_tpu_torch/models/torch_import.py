"""PyTorch checkpoint import (counterpart of
``da3slam_tpu/models/torch_import.py``).

Released DA3/DINOv2 checkpoints name their tensors as ``DA3Net`` does
(``blocks.N.attn.qkv.weight``, ``depth_head.scratch...``, ``camera_head...``)
and store them in its layouts, so importing one is a name resolution onto the
network's parameters: wrapper prefixes (``model.``, ``module.``) are
stripped, each parameter takes the first of its candidate names that the
checkpoint holds (``backbone.``/``encoder.``/``pretrained.`` before encoder
names; ``head.``/``dpt.``/``dpt_head.`` for the depth head and
``pose_head.``/``cam_head.`` for the camera head), and a ``pos_embed`` of
another grid is resampled.  Tensors the checkpoint lacks stay at their
initial values.  The ``ImportReport`` lists what matched, what was missing and
what was left over, entry for entry as the JAX package's import does for the
same dict: its shape messages are spelled in the JAX package's layouts
(HWIO convolutions, ``[in, out]`` linears), and the SwiGLU ``w12`` counts as
its gate and value halves, which the JAX package stores apart.

``split_nested_state_dict`` splits a nested checkpoint (the any-view and the
metric model in one dict) into its two submodels; ``models/nested.py``
builds them.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from da3slam_tpu_torch.models.convert import _CAMERA_NAME_MAP, _DPT_RESIZE_MAP, _dpt_name_map
from da3slam_tpu_torch.models.vit import SwiGLU
from da3slam_tpu_torch.ops.resize import resize_bilinear

# checkpoint tensors with no inference-time role: consumed, not mapped
# (DINOv2 checkpoints carry a mask_token from masked-image pretraining)
_IGNORED_CKPT_KEYS = ("mask_token",)

# torch layout -> the JAX package's layout, for the report's shape messages
_CONV = (2, 3, 1, 0)  # OIHW -> HWIO
_DECONV = (2, 3, 0, 1)  # ConvTranspose2d [in, out, kh, kw] -> HWIO
_LINEAR = (1, 0)  # [out, in] -> [in, out]


@dataclasses.dataclass
class ImportReport:
    matched: list[str]
    missing: list[str]  # our parameters not found in the checkpoint
    unused: list[str]  # checkpoint tensors we did not consume

    def __str__(self) -> str:
        return (
            f"imported {len(self.matched)} tensors; "
            f"{len(self.missing)} ours unmatched; {len(self.unused)} theirs unused"
        )


def _strip_prefixes(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Remove the wrapper prefixes ``model.`` and then ``module.``."""
    out = {}
    for k, v in sd.items():
        for prefix in ("model.", "module."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    return out


def _candidates(name: str) -> list[str]:
    """Checkpoint-name candidates for an encoder tensor."""
    return [name, f"backbone.{name}", f"encoder.{name}", f"pretrained.{name}"]


def _head_candidates(name: str) -> list[str]:
    """Checkpoint-name candidates for a head tensor: released checkpoints
    differ in the head prefix across DA3 versions."""
    alts = [name]
    if name.startswith("depth_head."):
        rest = name[len("depth_head."):]
        alts += [f"head.{rest}", f"dpt.{rest}", f"dpt_head.{rest}"]
    if name.startswith("camera_head."):
        rest = name[len("camera_head."):]
        alts += [f"pose_head.{rest}", f"cam_head.{rest}"]
    return alts


def _as_tensor(v: Any) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


class _Import:
    """One import's state: the stripped dict and the report being built."""

    def __init__(self, state_dict: Mapping[str, Any]):
        self.sd = _strip_prefixes(state_dict)
        self.used: set[str] = set()
        self.matched: list[str] = []
        self.missing: list[str] = []

    def take(self, names: list[str]) -> tuple[str | None, torch.Tensor | None]:
        for n in names:
            if n in self.sd:
                return n, _as_tensor(self.sd[n])
        return None, None

    def assign(self, target: torch.Tensor, names: list[str], perm=None, pre=None) -> None:
        """Copy the first of ``names`` the checkpoint holds into ``target``
        (``pre`` first selects from it); ``perm`` spells the shapes of a
        mismatch in the JAX package's layout."""
        name, val = self.take(names)
        if val is None:
            self.missing.append(names[0])
            return
        if pre is not None:
            val = pre(val)
        theirs, ours = (val.permute(perm), target.permute(perm)) if perm else (val, target)
        if tuple(theirs.shape) != tuple(ours.shape):
            self.missing.append(f"{names[0]} (shape {tuple(theirs.shape)} != "
                                f"{tuple(ours.shape)})")
            return
        target.copy_(val)
        self.used.add(name)
        self.matched.append(names[0])


def _pos_grid(p: torch.Tensor) -> torch.Tensor:
    """``[1, (1 +) G², D]`` or ``[(1 +) G², D]`` → ``[G, G, D]``: a leading
    cls row is dropped when the count is one past a perfect square."""
    if p.ndim == 3:
        p = p[0]
    side = int(round(p.shape[0] ** 0.5))
    if side * side != p.shape[0]:
        side = int(round((p.shape[0] - 1) ** 0.5))
        if side * side == p.shape[0] - 1:
            p = p[1:]
    return p.reshape(side, side, -1)


def _import_encoder(imp: _Import, net, cfg) -> None:
    a = imp.assign
    a(net.patch_embed.proj.weight, _candidates("patch_embed.proj.weight"), _CONV)
    a(net.patch_embed.proj.bias, _candidates("patch_embed.proj.bias"))

    # pos embed: another grid is resampled as jax.image.resize(..., "bilinear")
    # does it (antialiased on a downscale); the cls row (row 0) is not used
    name, val = imp.take(_candidates("pos_embed"))
    if val is None:
        imp.missing.append("pos_embed")
    else:
        grid = _pos_grid(val)
        if grid.shape[-1] == cfg.embed_dim:
            G = net.base_grid
            if grid.shape[0] != G:
                grid = resize_bilinear(grid[None].float(), (G, G))[0]
            net.pos_embed[0, 1:].copy_(grid.reshape(G * G, -1))
            imp.used.add(name)
            imp.matched.append("pos_embed")
        else:
            imp.missing.append("pos_embed (dim mismatch)")

    a(net.cls_token, _candidates("cls_token") + _candidates("camera_token"))
    a(net.register_tokens, _candidates("register_tokens") + _candidates("reg_token"))

    for i, blk in enumerate(net.blocks):
        base = f"blocks.{i}"
        ours_swiglu = isinstance(blk.mlp, SwiGLU)
        theirs_swiglu = any(c in imp.sd for c in _candidates(f"{base}.mlp.w12.weight"))
        if ours_swiglu != theirs_swiglu and (
            theirs_swiglu or any(c in imp.sd for c in _candidates(f"{base}.mlp.fc1.weight"))
        ):
            # leaving every FFN at its initial values would give wrong depth
            # with no error; a config.json that omits mlp_type for a SwiGLU
            # (giant) checkpoint is the usual cause
            raise ValueError(
                f"FFN flavour mismatch at {base}: config says "
                f"{'swiglu' if ours_swiglu else 'mlp'} but the checkpoint has "
                f"{'mlp.w12 (SwiGLU)' if theirs_swiglu else 'mlp.fc1 (plain MLP)'} "
                "— set mlp_type accordingly in the model config"
            )
        mlp = blk.mlp
        if ours_swiglu:
            # w12 fuses gate | value as [2h, D], the gate in the first h rows
            h = mlp.w3.in_features

            def fused(w, h=h, base=base):
                if w.shape[0] != 2 * h:
                    # slicing [:h] of a fused tensor of another width would
                    # pass the shape check with the wrong rows
                    raise ValueError(
                        f"{base}.mlp.w12 has fused width {w.shape[0]} but the config's "
                        f"SwiGLU hidden is {h} (expected {2 * h}); fix "
                        "mlp_ratio/embed_dim in the config")
                return w

            w12, b12 = mlp.w12.weight, mlp.w12.bias
            mlp_rows = [
                (w12[:h], "mlp.w12.weight", _LINEAR, lambda w, h=h: fused(w)[:h]),
                (b12[:h], "mlp.w12.bias", None, lambda b, h=h: b[:h]),
                (w12[h:], "mlp.w12.weight", _LINEAR, lambda w, h=h: fused(w)[h:]),
                (b12[h:], "mlp.w12.bias", None, lambda b, h=h: b[h:]),
                (mlp.w3.weight, "mlp.w3.weight", _LINEAR, None),
                (mlp.w3.bias, "mlp.w3.bias", None, None),
            ]
        else:
            mlp_rows = [
                (mlp.fc1.weight, "mlp.fc1.weight", _LINEAR, None),
                (mlp.fc1.bias, "mlp.fc1.bias", None, None),
                (mlp.fc2.weight, "mlp.fc2.weight", _LINEAR, None),
                (mlp.fc2.bias, "mlp.fc2.bias", None, None),
            ]
        for target, theirs, perm, pre in [
            (blk.norm1.weight, "norm1.weight", None, None),
            (blk.norm1.bias, "norm1.bias", None, None),
            (blk.attn.qkv.weight, "attn.qkv.weight", _LINEAR, None),
            (blk.attn.qkv.bias, "attn.qkv.bias", None, None),
            (blk.attn.proj.weight, "attn.proj.weight", _LINEAR, None),
            (blk.attn.proj.bias, "attn.proj.bias", None, None),
            (blk.ls1.gamma, "ls1.gamma", None, None),
            (blk.norm2.weight, "norm2.weight", None, None),
            (blk.norm2.bias, "norm2.bias", None, None),
            *mlp_rows,
            (blk.ls2.gamma, "ls2.gamma", None, None),
        ]:
            a(target, _candidates(f"{base}.{theirs}"), perm, pre)

    a(net.norm.weight, _candidates("norm.weight"))
    a(net.norm.bias, _candidates("norm.bias"))
    for ignored in _IGNORED_CKPT_KEYS:
        imp.used.update(c for c in _candidates(ignored) if c in imp.sd)


def _import_heads(imp: _Import, net) -> None:
    a = imp.assign
    for _, base in _dpt_name_map():
        conv = net.get_submodule(base)
        a(conv.weight, _head_candidates(f"{base}.weight"), _CONV)
        a(conv.bias, _head_candidates(f"{base}.bias"))
    for _, base, is_deconv in _DPT_RESIZE_MAP:
        conv = net.get_submodule(base)
        a(conv.weight, _head_candidates(f"{base}.weight"), _DECONV if is_deconv else _CONV)
        a(conv.bias, _head_candidates(f"{base}.bias"))
    for _, _, base in _CAMERA_NAME_MAP:
        lin = net.get_submodule(base)
        a(lin.weight, _head_candidates(f"{base}.weight"), _LINEAR)
        a(lin.bias, _head_candidates(f"{base}.bias"))


@torch.no_grad()
def import_torch_encoder(state_dict: Mapping[str, Any], net, cfg) -> tuple[Any, ImportReport]:
    """Copy the DINOv2-style encoder tensors of ``state_dict`` into ``net``
    in place; ``unused`` lists every tensor the encoder did not take (the
    heads' among them).  Returns ``(net, report)``."""
    imp = _Import(state_dict)
    _import_encoder(imp, net, cfg)
    return net, ImportReport(imp.matched, imp.missing, sorted(set(imp.sd) - imp.used))


@torch.no_grad()
def import_torch_heads(state_dict: Mapping[str, Any], net) -> tuple[Any, ImportReport]:
    """Copy the DPT depth-head and camera-head tensors of ``state_dict`` into
    ``net`` in place; ``unused`` lists every tensor the heads did not take.
    Returns ``(net, report)``."""
    imp = _Import(state_dict)
    _import_heads(imp, net)
    return net, ImportReport(imp.matched, imp.missing, sorted(set(imp.sd) - imp.used))


@torch.no_grad()
def import_torch_checkpoint(state_dict: Mapping[str, Any], net, cfg) -> tuple[Any, ImportReport]:
    """Copy a DA3/DINOv2-style state dict (tensors or numpy arrays) into
    ``net``'s parameters in place: encoder, DPT head, camera head.  Returns
    ``(net, report)``; parameters the checkpoint lacks keep their values."""
    imp = _Import(state_dict)
    _import_encoder(imp, net, cfg)
    _import_heads(imp, net)
    return net, ImportReport(imp.matched, imp.missing, sorted(set(imp.sd) - imp.used))


def export_torch_style(net) -> dict[str, torch.Tensor]:
    """The inverse: a float network's DA3/DINOv2-style state dict (the
    tensors share the network's storage, on its device)."""
    return {k: v.detach() for k, v in net.state_dict().items()}


def split_nested_state_dict(
    sd: Mapping[str, Any],
) -> tuple[dict[str, Any], dict[str, Any], tuple[str, str]] | None:
    """Detect and split a nested (two-submodel) DA3 checkpoint.

    Each submodel prefixes its tensors with its attribute name: ``model.``
    for the any-view model and ``metric_model.`` for the metric one in the
    layout pinned by ``tests/fixtures/torch_schema_nested_giant.json``, with
    tolerant alternates.  The metric submodel is the prefix named "metric";
    when no name decides, the any-view model is the wider backbone.  Keys bind
    to the longest matching prefix, so an unprefixed any-view backbone beside
    a ``metric_model.`` submodel splits cleanly.  Returns ``(anyview_sd,
    metric_sd, (anyview_prefix, metric_prefix))`` with the prefixes stripped,
    or ``None`` when fewer than two backbones are found.  Reads shapes only.
    """
    probe = "patch_embed.proj.weight"
    prefixes = sorted({k[: -len(probe)] for k in sd if k.endswith(probe)})
    if len(prefixes) < 2:
        return None

    def rank(prefix: str) -> tuple[int, int]:
        return (0 if "metric" in prefix.lower() else 1, int(sd[prefix + probe].shape[0]))

    ordered = sorted(prefixes, key=rank, reverse=True)
    p_any, p_metric = ordered[0], ordered[-1]
    sd_any: dict[str, Any] = {}
    sd_metric: dict[str, Any] = {}
    for k, v in sd.items():
        cands = [p for p in (p_any, p_metric) if k.startswith(p)]
        if not cands:
            continue
        p = max(cands, key=len)
        (sd_metric if p == p_metric else sd_any)[k[len(p):]] = v
    return sd_any, sd_metric, (p_any, p_metric)


def load_checkpoint_dir(path: str | Path) -> dict[str, torch.Tensor] | None:
    """The state dict of a checkpoint directory: its ``model.safetensors``,
    else the first of ``pytorch_model.bin``, ``model.pt``, ``model.bin``;
    None when it has none of them."""
    for name in ("model.safetensors", "pytorch_model.bin", "model.pt", "model.bin"):
        if (Path(path) / name).exists():
            return load_torch_checkpoint_file(Path(path) / name)
    return None


def load_torch_checkpoint_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Read a checkpoint file (``.safetensors``, or a pickled ``.bin``/``.pt``
    read with ``weights_only``) into ``{name: CPU tensor}``; a pickled
    ``{"state_dict": ...}`` is unwrapped."""
    path = Path(path)
    if path.suffix == ".safetensors":
        from da3slam_tpu_torch.models.weights import load_file

        return load_file(path)
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)
