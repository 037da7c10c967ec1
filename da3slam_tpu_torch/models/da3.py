"""DepthAnything3 — the public model API (counterpart of
``da3slam_tpu/models/da3.py``).

``DepthAnything3.from_pretrained(preset)`` → ``.inference(image=[...])``,
with ``forward_fn`` underneath.  The network is one ``nn.Module`` whose
state-dict names are the DA3/DINOv2 ones (``models/convert.py``).  The
working dtype is bf16 on CUDA and f32 on the CPU.  Checkpoint directories,
the nested tier, ``use_ray_pose`` and export are not ported yet.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from da3slam_tpu_torch.models import camera, dpt, vit
from da3slam_tpu_torch.models.config import ModelConfig, get_preset
from da3slam_tpu_torch.ops.resize import (
    denormalize_to_uint8,
    resize_normalize,
    upper_bound_shape,
)


@dataclasses.dataclass
class Prediction:
    """The §2.5 tensor contract: numpy arrays, or tensors on the model's
    device with ``keep_on_device``."""

    processed_images: Any  # [N, H, W, 3] uint8
    depth: Any  # [N, H, W] float32 (metric-ambiguous, chunk scale)
    conf: Any  # [N, H, W] float32, ~>= 1.0
    extrinsics: Any  # [N, 3, 4] float32 w2c OpenCV, chunk-local
    intrinsics: Any  # [N, 3, 3] float32 zero-skew pinhole
    frame_desc: Any = None  # [N, D] L2-normalised encoder descriptors


class DA3Net(vit.ViTEncoder):
    """Encoder + DPT depth head + camera head, named as the DA3 state dict
    (encoder tensors at the root, ``depth_head.*``, ``camera_head.*``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.depth_head = dpt.DPTHead(cfg)
        self.camera_head = camera.CameraHead(cfg)


def init_params(cfg: ModelConfig, seed: int = 0) -> DA3Net:
    """A randomly initialised network on the CPU, from an explicit generator."""
    net = DA3Net(cfg)
    gen = torch.Generator().manual_seed(seed)
    vit.init_encoder(net, cfg, gen)
    dpt.init_dpt(net.depth_head, gen)
    camera.init_camera_head(net.camera_head, gen)
    return net


def forward_fn(
    net: DA3Net,
    images: torch.Tensor,
    cfg: ModelConfig,
    ref_idx: int = 0,
    dtype=torch.float32,
) -> dict[str, torch.Tensor]:
    """Normalised images ``[N, H, W, 3]`` → prediction dict (f32 outputs)."""
    N, H, W, _ = images.shape
    taps, final, grid = vit.encode(net, images, cfg, dtype)
    depth, conf, rays = dpt.apply_dpt(net.depth_head, taps, grid, (H, W), cfg)
    extrinsics, intrinsics = camera.apply_camera_head(
        net.camera_head, final[:, 0, :], (H, W), ref_idx
    )
    # per-frame retrieval descriptor: L2-normalised mean-pooled patch tokens
    pooled = final[:, vit.num_prefix_tokens(cfg):, :].float().mean(dim=1)
    frame_desc = pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)
    return {
        "depth": depth,
        "conf": conf,
        "extrinsics": extrinsics,
        "intrinsics": intrinsics,
        "rays": rays,
        "frame_desc": frame_desc,
    }


class DepthAnything3:
    """Holds (config, network, dtype) behind the reference-shaped API."""

    def __init__(self, cfg: ModelConfig, net: DA3Net, dtype: torch.dtype | None = None):
        self.cfg = cfg
        self.net = net.eval()
        self.device = next(net.parameters()).device
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype

    @classmethod
    def from_pretrained(
        cls, preset: str, seed: int = 0, device: str | torch.device = "cuda"
    ) -> "DepthAnything3":
        """A randomly initialised model of a preset tier (``tiny``/``small``/...,
        or a checkpoint-directory-style name such as ``DA3-SMALL``).  Weights
        are made on the CPU from ``seed``, then moved to ``device``."""
        if (Path(preset) / "model.safetensors").exists():
            raise NotImplementedError("loading checkpoint directories is not ported yet")
        cfg = get_preset(preset)
        return cls(cfg, init_params(cfg, seed).to(device))

    @torch.no_grad()
    def inference(
        self,
        image: Sequence[str] | Sequence[np.ndarray] | np.ndarray | torch.Tensor,
        process_res: int = 504,
        process_res_method: str = "upper_bound_resize",
        ref_view_strategy: str = "first",
        extrinsics: np.ndarray | None = None,
        align_to_input_ext_scale: bool = False,
        keep_on_device: bool = False,
    ) -> Prediction:
        """Reference-contract inference over one chunk of views.

        ``keep_on_device=True`` returns every field as a tensor on the
        model's device and returns without waiting for the forward; otherwise
        the fields are fetched to numpy.
        """
        if process_res_method != "upper_bound_resize":
            raise ValueError(f"unsupported process_res_method {process_res_method!r}")
        if isinstance(image, torch.Tensor):
            raw = image if image.ndim == 4 else image[None]
        else:
            raw = torch.from_numpy(_load_images(image))
        if self.device.type == "cuda" and raw.device.type == "cpu":
            # pinned + non_blocking: the upload queues behind the previous
            # chunk's work instead of making the host wait for it
            raw = raw.pin_memory().to(self.device, non_blocking=True)
        raw = raw.to(self.device)
        h, w = raw.shape[1], raw.shape[2]
        th, tw = upper_bound_shape(h, w, process_res, self.cfg.patch_size)
        norm = resize_normalize(raw, (th, tw))

        ref_idx = camera.ref_view_index(raw.shape[0], ref_view_strategy)
        out = forward_fn(self.net, norm, self.cfg, ref_idx, self.dtype)

        ext = out["extrinsics"]
        depth = out["depth"]
        if extrinsics is not None:
            # conditioning adopts the provided poses; with scale alignment the
            # depth is rescaled so its metric matches their translations
            ext_in = torch.as_tensor(np.asarray(extrinsics), dtype=torch.float32,
                                     device=self.device)
            if align_to_input_ext_scale:
                depth = depth * _pose_scale_ratio(ext_in, ext)
            ext = ext_in

        fields = {
            "processed_images": denormalize_to_uint8(norm),
            "depth": depth.float(),
            "conf": out["conf"].float(),
            "extrinsics": ext.float(),
            "intrinsics": out["intrinsics"].float(),
            "frame_desc": out["frame_desc"].float(),
        }
        if not keep_on_device:
            fields = {k: v.cpu().numpy() for k, v in fields.items()}
        return Prediction(**fields)


def _pose_scale_ratio(ext_target: torch.Tensor, ext_pred: torch.Tensor) -> torch.Tensor:
    """Median ratio of camera-translation norms (the ``align_to_input_ext_scale``
    rescaling); the median of an even count averages the two middle values."""
    tn_t = torch.linalg.vector_norm(ext_target[:, :, 3], dim=-1)
    tn_p = torch.linalg.vector_norm(ext_pred[:, :, 3], dim=-1)
    valid = (tn_t > 1e-8) & (tn_p > 1e-8)
    ratio = torch.where(valid, tn_t / tn_p.clamp_min(1e-8), torch.nan)
    med = torch.nanquantile(ratio, 0.5)
    return torch.where(torch.isfinite(med) & (med > 0), med, torch.ones_like(med))


def _load_images(image) -> np.ndarray:
    """Paths / arrays / stacked array → ``[N, H, W, 3]`` uint8."""
    from da3slam_tpu_torch.inout.images import decode_image

    if isinstance(image, np.ndarray):
        arr = image if image.ndim == 4 else image[None]
        return arr.astype(np.uint8) if arr.dtype != np.uint8 else arr
    frames = [decode_image(item) if isinstance(item, (str, Path)) else np.asarray(item)
              for item in image]
    if not frames:
        raise ValueError("inference needs at least one image (got an empty list)")
    return np.stack(frames).astype(np.uint8)
