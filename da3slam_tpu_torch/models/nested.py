"""DepthAnything3Nested — the nested (any-view + metric) model tier
(counterpart of ``da3slam_tpu/models/nested.py``).

The reference's first-listed production checkpoint,
``DA3NESTED-GIANT-LARGE-1.1``, packages two complete DA3 models: the
any-view geometry model (giant: multi-view depth, confidence and poses,
metric-ambiguous per chunk) and the monocular metric model (large: single-view
metric depth, run on the reference view only).  The any-view prediction's
depth and extrinsic translations are multiplied by one robust scale,
``median(metric_depth / anyview_depth[ref])`` over pixels confident in both
branches, so downstream consumers see a metric chunk with unchanged geometry.

A nested checkpoint is one state dict whose submodels prefix their tensors,
``model.`` (any-view) and ``metric_model.`` (metric), with tolerant
alternates (``models/torch_import.py:split_nested_state_dict``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from da3slam_tpu_torch.core.geometry import median
from da3slam_tpu_torch.models.config import PRESETS, ModelConfig, resolve_nested_preset
from da3slam_tpu_torch.utils.profiling import span


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN elements as ``jnp.nanmedian`` takes it: for an
    even count the mean of the two middle values (``torch.nanmedian`` returns
    the lower); NaN when every element is NaN.  No host wait."""
    s = torch.sort(x.reshape(-1)).values  # NaN last
    n = (~torch.isnan(s)).sum()
    lo = ((n - 1) // 2).clamp_min(0).reshape(1)
    hi = (n // 2).clamp_max(s.shape[0] - 1).reshape(1)
    med = 0.5 * (s.index_select(0, lo) + s.index_select(0, hi))[0]
    return torch.where(n > 0, med, torch.nan)


def metric_scale_from_mono(any_depth_ref, any_conf_ref, metric_depth, metric_conf,
                           eps: float = 1e-6) -> torch.Tensor:
    """Robust global scale: the median of per-pixel ``metric / anyview``
    depth ratios over pixels confident in both branches (confidence at or
    above each branch's median).  A 0-d f32 tensor on the inputs' device;
    1.0 when no pixel qualifies or the median is not finite and positive."""
    a, m, ca, cm = (torch.as_tensor(x).to(torch.float32).reshape(-1)
                    for x in (any_depth_ref, metric_depth, any_conf_ref, metric_conf))
    valid = ((a > eps) & (m > eps) & (ca >= median(ca)) & (cm >= median(cm))
             & torch.isfinite(a) & torch.isfinite(m))
    ratio = torch.where(valid, m / a.clamp_min(eps), torch.nan)
    s = _nanmedian(ratio)
    return torch.where(torch.isfinite(s) & (s > 0), s, torch.ones_like(s))


class DepthAnything3Nested:
    """Two submodels behind ``DepthAnything3``'s inference API.  ``cfg``,
    ``net``, ``dtype`` and ``device`` are the any-view submodel's, the one the
    SLAM stack runs."""

    # the solver's prefetcher may hand it decoded arrays in place of paths
    takes_arrays = True

    def __init__(self, anyview, metric):
        self.anyview = anyview
        self.metric = metric

    @property
    def cfg(self) -> ModelConfig:
        return self.anyview.cfg

    @property
    def net(self):
        return self.anyview.net

    @property
    def dtype(self) -> torch.dtype:
        return self.anyview.dtype

    @property
    def device(self) -> torch.device:
        return self.anyview.device

    @classmethod
    def from_pretrained(cls, path_or_preset: str, seed: int = 0,
                        device: str | torch.device = "cuda") -> "DepthAnything3Nested":
        """A nested checkpoint directory (split, then imported), or a nested
        preset name: random weights, the any-view model from ``seed`` and the
        metric model from ``seed + 1``."""
        from da3slam_tpu_torch.models.da3 import DepthAnything3
        from da3slam_tpu_torch.models.torch_import import (
            load_checkpoint_dir,
            split_nested_state_dict,
        )

        p = Path(path_or_preset)
        sd = load_checkpoint_dir(p)
        if sd is not None:
            split = split_nested_state_dict(sd)
            if split is None:
                raise ValueError(
                    f"{path_or_preset}: checkpoint is not nested (no two complete backbones "
                    "found) — load it with DepthAnything3.from_pretrained instead")
            return cls.from_split_state_dicts(*split[:2], ckpt_dir=p, seed=seed, device=device)
        pair = resolve_nested_preset(path_or_preset)
        if pair is None:
            raise KeyError(f"unknown nested preset {path_or_preset!r}; known: "
                           "nested-giant-large, nested-tiny, or a checkpoint directory")
        any_name, metric_name = pair
        return cls(DepthAnything3.from_pretrained(any_name, seed=seed, device=device),
                   DepthAnything3.from_pretrained(metric_name, seed=seed + 1, device=device))

    @classmethod
    def from_split_state_dicts(cls, sd_any, sd_metric, ckpt_dir=None, seed: int = 0,
                               device: str | torch.device = "cuda") -> "DepthAnything3Nested":
        """Build from the two split state dicts.  Each submodel's config comes
        from a nested ``config.json`` (``{"model": {...}, "metric_model":
        {...}}``) when it has that section, else from its tensors (width,
        depth, FFN flavour).  Missing tensors are made on ``device`` from
        ``seed`` (any-view) and ``seed + 1`` (metric)."""
        from da3slam_tpu_torch.models.da3 import DepthAnything3, init_params
        from da3slam_tpu_torch.models.torch_import import import_torch_checkpoint

        sub_cfg: dict[str, ModelConfig | None] = {"model": None, "metric_model": None}
        if ckpt_dir is not None and (Path(ckpt_dir) / "config.json").exists():
            blob = json.loads((Path(ckpt_dir) / "config.json").read_text())
            fields = {f.name for f in dataclasses.fields(ModelConfig)}
            for key in sub_cfg:
                if isinstance(blob.get(key), dict):
                    sub_cfg[key] = ModelConfig(**{
                        k: tuple(v) if isinstance(v, list) else v
                        for k, v in blob[key].items() if k in fields})

        def build(sd, cfg, sub_seed):
            if cfg is None:
                cfg = _config_from_state_dict(sd)
            net, report = import_torch_checkpoint(sd, init_params(cfg, sub_seed, device), cfg)
            print(f"nested submodel import ({cfg.embed_dim}d x{cfg.depth}): {report}")
            return DepthAnything3(cfg, net)

        return cls(build(sd_any, sub_cfg["model"], seed),
                   build(sd_metric, sub_cfg["metric_model"], seed + 1))

    def quantize(self, scheme: str = "w8a8") -> "DepthAnything3Nested":
        return DepthAnything3Nested(self.anyview.quantize(scheme), self.metric.quantize(scheme))

    def inference(self, image: Sequence[str] | Sequence[np.ndarray] | np.ndarray | torch.Tensor,
                  ref_view_strategy: str = "first", **kwargs):
        """Any-view inference over the chunk, then the metric scale from the
        monocular branch on the reference view.  The prediction's ``depth``
        and extrinsic translations are multiplied by the scale, which
        ``metric_scale`` records; with input ``extrinsics=`` the input poses
        define the scale and the rescale is skipped.  ``export_dir`` goes to
        the any-view inference, so its ``prediction.npz`` holds the depth
        before the rescale, as in the JAX package.  Both submodels' spans
        sit inside this call's ``model.nested`` span, whose ``fetches``
        attribute counts the call's fetches of a prediction to the host
        (``model.fetch`` spans): 1, or 0 with ``keep_on_device``.

        Without ``extrinsics=`` the host waits for neither branch: the metric
        branch is enqueued right behind the any-view forward, the scale is
        found and applied on the device, and the rescaled chunk is fetched
        once, at the end."""
        with span("model.nested") as attrs:
            attrs["fetches"] = 0 if kwargs.get("keep_on_device", False) else 1
            return self._inference(image, ref_view_strategy, **kwargs)

    def _inference(self, image, ref_view_strategy: str, **kwargs):
        from da3slam_tpu_torch.models import camera
        from da3slam_tpu_torch.models.da3 import deliver

        if kwargs.get("extrinsics") is not None:
            return self.anyview.inference(image, ref_view_strategy=ref_view_strategy, **kwargs)
        pred = self.anyview.inference(image, ref_view_strategy=ref_view_strategy,
                                      **{**kwargs, "keep_on_device": True})

        # the metric branch sees the raw reference view (it resizes itself):
        # a staged device batch is sliced where it lives, and of a list of
        # paths or arrays only that one is read again
        views = image[None] if getattr(image, "ndim", None) == 3 else image
        ref_idx = camera.ref_view_index(len(views), ref_view_strategy)
        mkwargs = {k: v for k, v in kwargs.items() if k in ("process_res", "process_res_method")}
        mono = self.metric.inference(views[ref_idx:ref_idx + 1], keep_on_device=True, **mkwargs)

        s = metric_scale_from_mono(pred.depth[ref_idx], pred.conf[ref_idx],
                                   mono.depth[0], mono.conf[0])
        ext = pred.extrinsics.clone()
        ext[:, :, 3] *= s
        keep = kwargs.get("keep_on_device", False)
        out = deliver({**vars(pred), "depth": pred.depth * s, "extrinsics": ext,
                       "metric_scale": s}, keep)
        if not keep:
            out.metric_scale = float(out.metric_scale)
        return out


def _config_from_state_dict(sd: dict[str, Any]) -> ModelConfig:
    """A submodel's preset from its tensors: width, depth and FFN flavour
    identify the released tier; an unknown combination raises."""
    D = int(sd["patch_embed.proj.weight"].shape[0])
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    swiglu = any(".mlp.w12." in k and k.startswith("blocks.") for k in sd)
    for cfg in PRESETS.values():
        if cfg.embed_dim == D and cfg.depth == depth and (cfg.mlp_type == "swiglu") == swiglu:
            return cfg
    raise ValueError(
        f"no preset matches nested submodel (embed_dim={D}, depth={depth}, "
        f"{'swiglu' if swiglu else 'mlp'}) — add a preset or a nested config.json "
        "with per-submodel sections")


def export_torch_style_nested(nested: DepthAnything3Nested) -> dict[str, torch.Tensor]:
    """The inverse for the pair: each submodel's state dict under its prefix
    (the tensors share the networks' storage)."""
    from da3slam_tpu_torch.models.torch_import import export_torch_style

    sd = {}
    for prefix, sub in (("model.", nested.anyview), ("metric_model.", nested.metric)):
        for k, v in export_torch_style(sub.net).items():
            sd[prefix + k] = v
    return sd
