"""DepthAnything3 — the public model API (counterpart of
``da3slam_tpu/models/da3.py``).

``DepthAnything3.from_pretrained(preset)`` → ``.inference(image=[...])``,
with ``forward_fn`` underneath.  The network is one ``nn.Module`` whose
state-dict names are the DA3/DINOv2 ones (``models/convert.py``).  The
working dtype is bf16 on CUDA and f32 on the CPU.  ``from_pretrained`` takes
a preset name or a checkpoint directory (``models/weights.py``,
``models/torch_import.py``); a nested preset or checkpoint gives a
``DepthAnything3Nested`` (``models/nested.py``).  ``quantize("w8a8")``
returns a copy whose encoder GEMMs run int8.  ``inference(export_dir=...)``
writes the ``mini_npz`` or the ``glb`` export.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from da3slam_tpu_torch.core.transforms import se3_compose, se3_inverse
from da3slam_tpu_torch.models import camera, dpt, vit
from da3slam_tpu_torch.models.config import ModelConfig, config_from_json, get_preset
from da3slam_tpu_torch.ops.resize import (
    denormalize_to_uint8,
    resize_normalize,
    upper_bound_shape,
)
from da3slam_tpu_torch.utils.profiling import nbytes, span


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
    # nested tiers only (models/nested.py): the recovered metric scale that
    # depth and extrinsic translations were multiplied by (a float, or a 0-d
    # device tensor with keep_on_device); None for the plain tiers
    metric_scale: Any = None


class DA3Net(vit.ViTEncoder):
    """Encoder + DPT depth head + camera head, named as the DA3 state dict
    (encoder tensors at the root, ``depth_head.*``, ``camera_head.*``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.depth_head = dpt.DPTHead(cfg)
        self.camera_head = camera.CameraHead(cfg)


def init_params(cfg: ModelConfig, seed: int = 0, device: str | torch.device = "cpu") -> DA3Net:
    """A randomly initialised network made on ``device`` from a generator of
    that device (the same seed gives other numbers on the card than on the
    CPU; on the CPU, the same as ever)."""
    device = torch.device(device)
    with device:
        net = DA3Net(cfg)
    gen = torch.Generator(device).manual_seed(seed)
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
    use_ray_pose: bool = False,
) -> dict[str, torch.Tensor]:
    """Normalised images ``[N, H, W, 3]`` → prediction dict (f32 outputs).

    ``use_ray_pose`` recovers the extrinsics from the DPT head's dense Plücker
    ray maps instead of the camera-token head."""
    N, H, W, _ = images.shape
    taps, final, grid = vit.encode(net, images, cfg, dtype)
    with span("model.dpt"):
        depth, conf, rays = dpt.apply_dpt(net.depth_head, taps, grid, (H, W), cfg)
    extrinsics, intrinsics = camera.apply_camera_head(
        net.camera_head, final[:, 0, :], (H, W), ref_idx
    )
    if use_ray_pose:
        ext_rays = camera.pose_from_rays(rays, intrinsics)
        # re-anchor so the reference view is the identity, like the head path
        extrinsics = se3_compose(ext_rays, se3_inverse(ext_rays[ref_idx])[None])
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

    # the solver's prefetcher may hand it decoded arrays in place of paths
    takes_arrays = True

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
        """A checkpoint directory, or a randomly initialised model of a preset
        tier (``tiny``/``small``/..., or a checkpoint-directory-style name such
        as ``DA3-SMALL`` when no such directory exists), dispatched as the JAX
        package does:

        - ``model.safetensors`` in the JAX package's native layout
          (``/``-joined pytree paths) goes through ``models/convert.py``
          (its ``config.json`` is required);
        - a torch-style (dot-named) ``model.safetensors``, or a pickled
          ``pytorch_model.bin``/``model.pt``/``model.bin``, holding two
          backbones is a nested checkpoint (``DepthAnything3Nested``), else it
          goes through ``models/torch_import.py``;
        - a nested preset name (``DA3NESTED-GIANT-LARGE-1.1``,
          ``nested-tiny``) gives a ``DepthAnything3Nested`` of random weights;
        - anything else names a preset.

        A preset's random weights are made from ``seed`` on the CPU, then
        moved to ``device``; an imported checkpoint's missing tensors are made
        on ``device``."""
        from da3slam_tpu_torch.models.config import resolve_nested_preset
        from da3slam_tpu_torch.models.torch_import import (
            load_checkpoint_dir,
            split_nested_state_dict,
        )

        p = Path(preset)
        sd = load_checkpoint_dir(p)
        if sd is not None:
            if any("/" in k for k in sd):
                return cls._from_native(sd, p, device)
            split = split_nested_state_dict(sd)
            if split is not None:
                from da3slam_tpu_torch.models.nested import DepthAnything3Nested

                return DepthAnything3Nested.from_split_state_dicts(
                    *split[:2], ckpt_dir=p, seed=seed, device=device)
            return cls._from_torch_state_dict(sd, p, seed, device)
        if resolve_nested_preset(preset) is not None:
            from da3slam_tpu_torch.models.nested import DepthAnything3Nested

            return DepthAnything3Nested.from_pretrained(preset, seed, device)
        cfg = get_preset(preset)
        return cls(cfg, init_params(cfg, seed).to(device))

    @classmethod
    def _from_native(cls, flat: dict, ckpt_dir: Path, device) -> "DepthAnything3":
        from da3slam_tpu_torch.models.convert import convert
        from da3slam_tpu_torch.models.weights import unflatten_params

        if not (ckpt_dir / "config.json").exists():
            raise FileNotFoundError(f"{ckpt_dir}: a native checkpoint needs its config.json")
        sd = convert(unflatten_params({k: v.float().numpy() for k, v in flat.items()}))
        cfg = _ffn_from_tensors(config_from_json(ckpt_dir / "config.json"), sd)
        net = DA3Net(cfg)
        net.load_state_dict(sd, strict=True)
        return cls(cfg, net.to(device))

    @classmethod
    def _from_torch_state_dict(cls, sd: dict, ckpt_dir: Path, seed: int,
                               device) -> "DepthAnything3":
        from da3slam_tpu_torch.models.torch_import import import_torch_checkpoint

        try:
            cfg = config_from_json(ckpt_dir / "config.json")
        except (OSError, ValueError, TypeError):  # absent, or not a model config
            cfg = get_preset(str(ckpt_dir))
        cfg = _ffn_from_tensors(cfg, sd)
        net, report = import_torch_checkpoint(sd, init_params(cfg, seed, device), cfg)
        print(f"torch checkpoint import: {report}")
        if report.missing:
            print(f"  unmatched (kept at init): {report.missing[:8]}"
                  + (" ..." if len(report.missing) > 8 else ""))
        return cls(cfg, net)

    def quantize(self, scheme: str = "w8a8") -> "DepthAnything3":
        """A copy whose encoder QKV and MLP GEMMs run pre-quantized int8 × int8
        (``ops/quant.py``, ``models/vit.py:quantize_encoder``); this model is
        left as it is.  Inference only: the copy's quantized projections hold
        no parameters."""
        if scheme != "w8a8":
            raise ValueError(f"unknown quantization scheme {scheme!r}")
        net = copy.deepcopy(self.net)
        vit.quantize_encoder(net)
        return DepthAnything3(self.cfg, net, self.dtype)

    @torch.no_grad()
    def inference(
        self,
        image: Sequence[str] | Sequence[np.ndarray] | np.ndarray | torch.Tensor,
        process_res: int = 504,
        process_res_method: str = "upper_bound_resize",
        ref_view_strategy: str = "first",
        use_ray_pose: bool = False,
        extrinsics: np.ndarray | None = None,
        align_to_input_ext_scale: bool = False,
        export_dir: str | Path | None = None,
        export_format: str = "mini_npz",
        keep_on_device: bool = False,
    ) -> Prediction:
        """Reference-contract inference over one chunk of views.

        ``use_ray_pose=True`` recovers poses from the dense ray maps instead
        of the camera-token head.  ``keep_on_device=True`` returns every field as a tensor on the
        model's device and returns without waiting for the forward; otherwise
        the fields are fetched to numpy.  ``export_dir`` also writes the
        prediction there in ``export_format``: ``"mini_npz"`` is
        ``prediction.npz`` (depth, conf, extrinsics, intrinsics), ``"glb"``
        is ``scene.glb``, the fused point cloud (``inout/export3d.py``).
        """
        if process_res_method != "upper_bound_resize":
            raise ValueError(f"unsupported process_res_method {process_res_method!r}")
        if export_dir is not None and export_format not in ("mini_npz", "glb"):
            raise ValueError(f"unknown export_format {export_format!r}")
        with span("model.inference") as attrs:
            raw = upload_views(image, self.device, attrs)
            h, w = raw.shape[1], raw.shape[2]
            th, tw = upper_bound_shape(h, w, process_res, self.cfg.patch_size)
            norm = resize_normalize(raw, (th, tw))

            ref_idx = camera.ref_view_index(raw.shape[0], ref_view_strategy)
            out = forward_fn(self.net, norm, self.cfg, ref_idx, self.dtype, use_ray_pose)

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
            pred = deliver(fields, keep_on_device)
            if export_dir is not None:
                _export({k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                         for k, v in vars(pred).items() if k in fields},
                        Path(export_dir), export_format)
            return pred


def upload_views(image, device: torch.device, attrs: dict) -> torch.Tensor:
    """Paths, arrays or a tensor of views → uint8 ``[N, H, W, 3]`` on
    ``device``; the number of views goes into the enclosing span's
    ``attrs``."""
    if isinstance(image, torch.Tensor):
        raw = image if image.ndim == 4 else image[None]
    else:
        raw = torch.from_numpy(_load_images(image))
    attrs["views"] = raw.shape[0]
    if device.type == "cuda" and raw.device.type == "cpu":
        # pinned + non_blocking: the upload queues behind the previous
        # chunk's work instead of making the host wait for it
        with span("model.upload", bytes=nbytes(raw)):
            raw = raw.pin_memory().to(device, non_blocking=True)
    return raw.to(device)


def deliver(fields: dict, keep_on_device: bool) -> Prediction:
    """A prediction of device tensors, or of numpy arrays fetched in the
    ``model.fetch`` span."""
    if not keep_on_device:
        with span("model.fetch", bytes=nbytes(*fields.values())):
            fields = {k: v.cpu().numpy() for k, v in fields.items()}
    return Prediction(**fields)


def _ffn_from_tensors(cfg: ModelConfig, sd: dict) -> ModelConfig:
    """The FFN flavour is visible in the tensors: trust them over a
    config.json that omits mlp_type (backbone blocks only: camera_head.mlp.fc1
    would match too)."""
    swiglu = any(".mlp.w12." in k and "blocks." in k for k in sd)
    mlp = any(".mlp.fc1." in k and "blocks." in k for k in sd)
    return cfg.with_overrides(mlp_type="swiglu" if swiglu else "mlp") if swiglu != mlp else cfg


def _export(fields: dict, out: Path, export_format: str) -> None:
    """Write numpy ``fields`` of a prediction to ``out`` as the JAX package's
    ``_export`` does."""
    out.mkdir(parents=True, exist_ok=True)
    if export_format == "mini_npz":
        np.savez_compressed(out / "prediction.npz", **{
            k: fields[k] for k in ("depth", "conf", "extrinsics", "intrinsics")})
    else:
        from da3slam_tpu_torch.inout.export3d import export_glb

        export_glb(Prediction(**fields), out / "scene.glb")


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
