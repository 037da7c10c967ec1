"""Model configuration and checkpoint-tier presets (copy of
``da3slam_tpu/models/config.py``'s ``ModelConfig``, ``PRESETS`` and
``get_preset``; that module cannot be imported without JAX, through its
package ``__init__``)."""

from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # backbone (DINOv2-style plain ViT)
    patch_size: int = 14
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    # every `cross_view_interval`-th block attends across all views jointly;
    # the others attend within each view
    cross_view_interval: int = 2
    layerscale_init: float = 1e-5
    # feed-forward flavour: "mlp" (fc1/gelu/fc2) or "swiglu" (DINOv2-giant's
    # SwiGLUFFN: w12 → silu(x1)·x2 → w3)
    mlp_type: str = "mlp"
    remat: bool = False
    # DPT head
    dpt_layers: tuple[int, ...] = (2, 5, 8, 11)  # blocks tapped for the head
    dpt_dim: int = 128
    dpt_features: tuple[int, ...] = (96, 192, 384, 768)
    # camera head
    camera_dim: int = 256

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        if self.mlp_type == "swiglu":
            h = int(self.embed_dim * self.mlp_ratio * 2 / 3)
            return (h + 7) // 8 * 8
        return int(self.embed_dim * self.mlp_ratio)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


PRESETS: dict[str, ModelConfig] = {
    # test-sized model: real code paths, trivial compute
    "tiny": ModelConfig(
        embed_dim=32, depth=4, num_heads=2, num_register_tokens=1,
        dpt_layers=(0, 1, 2, 3), dpt_dim=16, dpt_features=(8, 16, 24, 32),
        camera_dim=32,
    ),
    "small": ModelConfig(
        embed_dim=384, depth=12, num_heads=6,
        dpt_layers=(2, 5, 8, 11), dpt_dim=128, dpt_features=(96, 192, 384, 768),
    ),
    "base": ModelConfig(
        embed_dim=768, depth=12, num_heads=12,
        dpt_layers=(2, 5, 8, 11), dpt_dim=256, dpt_features=(96, 192, 384, 768),
    ),
    "large": ModelConfig(
        embed_dim=1024, depth=24, num_heads=16,
        dpt_layers=(4, 11, 17, 23), dpt_dim=256, dpt_features=(256, 512, 1024, 1024),
    ),
    "giant": ModelConfig(
        embed_dim=1536, depth=40, num_heads=24, mlp_type="swiglu",
        dpt_layers=(9, 19, 29, 39), dpt_dim=384, dpt_features=(384, 768, 1536, 1536),
    ),
}

_ALIASES = {
    "da3-small": "small", "da3-samll": "small",  # the reference config has the typo
    "da3-base": "base",
    "da3-large": "large", "da3-large-1.1": "large",
    "da3nested-giant-large-1.1": "giant", "da3-giant": "giant",
}


def get_preset(name: str) -> ModelConfig:
    """Resolve a tier name or checkpoint-directory-style name to a config."""
    key = Path(name).name.lower()
    key = _ALIASES.get(key, key)
    if key not in PRESETS:
        raise KeyError(f"Unknown model preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[key]
