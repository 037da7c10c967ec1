"""VGGT-1B (github.com/facebookresearch/vggt, arXiv:2503.11651) as a second
network of the SLAM path: depth, confidence and cameras of a chunk of views,
behind the same ``inference`` contract as ``models/da3.py:DepthAnything3``.

The network, at the published sizes (``PRESETS["vggt-1b"]``):

- **Patch embed**: a DINOv2 ViT-L/14 with 4 registers, each view on its own
  (``aggregator.patch_embed.*``, DINOv2's names).  Tokens ``[cls + pos₀,
  reg×4, patches + pos]``, the 37×37 position grid resampled bicubic with
  antialiasing; the final norm's patch tokens go on.
- **Aggregator**: a camera token and 4 register tokens are prepended to each
  view's patch tokens, the first view's pair (index 0) its own, the others'
  shared (index 1).  Then 24 *frame* blocks (attention within each view) and
  24 *global* blocks (attention over all views' tokens as one sequence)
  alternate, frame i then global i.  Each attention layer-norms q and k per
  head (QK-norm, eps 1e-5) and rotates them by 2D RoPE at frequency 100
  (:func:`rope_tables`): the y half and the x half of each head, channel j
  paired with j + D/4, at the patch's row or column counted from 1; the five
  special tokens sit at 0 and are not rotated.  Global blocks take each
  token's position within its own view.  After pair i the two outputs,
  concatenated, are tap i (2048 wide).
- **Depth head**: ``models/dpt.py:apply_dpt_uv`` on taps 4, 11, 17, 23.
- **Camera head**: the camera token of tap 23, layer-normed, refined 4 times
  by an adaLN-modulated 4-block trunk (2048 wide, 16 heads of 128) from the
  same tokens each time, the pose encoding summed over the iterations and
  decoded by ``core/transforms.py:abs_t_quat_fov_to_camera``.

Precision: bf16 activations over f32 parameters on the card (f32 on the CPU)
in the patch embed, the aggregator and the depth head; every LayerNorm,
QK-norm included, in f32 (``vit.layer_norm``), and RoPE applied in f32 to
QK-norm's output, rounded once.  The camera head runs in f32.

Every attention of the patch embed and the aggregator (head width 64) goes
through ``vit.multi_head_attention`` (looked up at each call) as
``[B, S, H, D]``.  The camera trunk's attention over the views has head
width 128, which the flash kernels do not take (``ops/attention.py``): it is
plain f32 softmax attention here.

Departures from the published model, each for the SLAM path:

- the point and track heads are not built: the solver reads depth,
  confidence and cameras only;
- the extrinsics are re-anchored to the first view, ``E_i ∘ E_0⁻¹``, as
  ``models/camera.py:apply_camera_head`` does for DA3 (VGGT is trained so
  that the first camera is the world frame);
- ``frame_desc``, which VGGT has not, is the L2-normalised mean of tap 23's
  patch tokens, for retrieval and the loop closer;
- the solver feeds every model at ``process_res`` 504 (VGGT's own loader
  resizes to 518).

Spans (``utils/profiling.py``): ``model.inference`` → ``model.upload``,
``model.qk`` (one an aggregator attention, around QK-norm and RoPE of q and
k; ``B``, ``S``, ``H``, ``D`` of its attention and ``kind`` frame / global),
``model.attention``, ``model.dpt``, ``model.camera`` (the head's iterations),
``model.fetch``.

``VGGT.from_pretrained(name, seed, device)`` builds a preset with random
weights from ``seed`` (:func:`init_params`); no checkpoint is read yet.  The
state-dict names are VGGT's, so a checkpoint can load later without renaming.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from da3slam_tpu_torch.core.transforms import (
    abs_t_quat_fov_to_camera,
    highest_precision,
    se3_compose,
    se3_inverse,
)
from da3slam_tpu_torch.models import dpt, vit
from da3slam_tpu_torch.models.config import ModelConfig
from da3slam_tpu_torch.models.da3 import deliver, upload_views
from da3slam_tpu_torch.ops.resize import denormalize_to_uint8, resize_normalize, upper_bound_shape
from da3slam_tpu_torch.utils.profiling import span

POSE_DIM = 9  # absT_quaR_FoV: translation 3, quaternion 4 (scalar last), FoV 2
ADALN_EPS = 1e-6  # the camera head's modulated LayerNorm (no affine parameters)


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    patch_size: int = 14
    embed_dim: int = 1024
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    base_grid: int = 37  # the learned position grid: the patch grid at 518²
    dino_depth: int = 24  # blocks of the DINOv2 patch embed
    depth: int = 24  # frame / global block pairs of the aggregator
    rope_freq: float = 100.0
    dpt_layers: tuple[int, ...] = (4, 11, 17, 23)  # block pairs tapped for the depth head
    dpt_dim: int = 256
    dpt_features: tuple[int, ...] = (256, 512, 1024, 1024)
    camera_depth: int = 4  # trunk blocks
    camera_heads: int = 16
    camera_iters: int = 4
    layerscale_init: float = 0.01  # VGGT's init_values

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def n_prefix(self) -> int:
        """The aggregator's special tokens a view: the camera token and the
        registers (VGGT's ``patch_start_idx``)."""
        return 1 + self.num_register_tokens

    def dino(self) -> ModelConfig:
        """The patch embed's sizes as the port's ViT configuration."""
        return ModelConfig(patch_size=self.patch_size, embed_dim=self.embed_dim,
                           depth=self.dino_depth, num_heads=self.num_heads,
                           mlp_ratio=self.mlp_ratio, num_register_tokens=self.num_register_tokens,
                           mlp_type="mlp", layerscale_init=self.layerscale_init)


PRESETS: dict[str, VGGTConfig] = {
    "vggt-1b": VGGTConfig(),
    # test-sized: every code path, trivial compute
    "vggt-tiny": VGGTConfig(embed_dim=64, num_heads=4, dino_depth=2, depth=2,
                            dpt_layers=(0, 1, 1, 1), dpt_dim=16, dpt_features=(8, 16, 24, 32),
                            camera_depth=2, camera_heads=4, camera_iters=2),
}


def vggt_preset(name: str) -> VGGTConfig | None:
    """The preset ``name`` names (``VGGT-1B``, ``vggt-tiny``; case and any
    directory part ignored), or None."""
    return PRESETS.get(Path(str(name)).name.lower())


# -- parameters, named as VGGT's state dict -------------------------------------

class QKAttention(nn.Module):
    def __init__(self, dim: int, head_dim: int, qk_norm: bool):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(head_dim)
            self.k_norm = nn.LayerNorm(head_dim)
        self.proj = nn.Linear(dim, dim)


class Block(nn.Module):
    """VGGT's block: pre-norm attention and GELU MLP with LayerScale, torch's
    LayerNorm eps (1e-5)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qk_norm: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = QKAttention(dim, dim // num_heads, qk_norm)
        self.ls1 = vit.LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = vit.Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = vit.LayerScale(dim)


class PatchEmbed(vit.ViTEncoder):
    """DINOv2 ViT with registers, named as DINOv2 (``mask_token`` is stored,
    never read)."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__(cfg.dino(), cfg.base_grid)
        self.mask_token = nn.Parameter(torch.empty(1, cfg.embed_dim))


class Aggregator(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.frame_blocks = nn.ModuleList(
            [Block(D, cfg.num_heads, cfg.mlp_ratio, True) for _ in range(cfg.depth)])
        self.global_blocks = nn.ModuleList(
            [Block(D, cfg.num_heads, cfg.mlp_ratio, True) for _ in range(cfg.depth)])
        # [first view's, the others'] camera token and registers
        self.camera_token = nn.Parameter(torch.empty(1, 2, 1, D))
        self.register_token = nn.Parameter(torch.empty(1, 2, cfg.num_register_tokens, D))


class CameraHead(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        D = 2 * cfg.embed_dim
        self.trunk = nn.Sequential(
            *[Block(D, cfg.camera_heads, cfg.mlp_ratio, False) for _ in range(cfg.camera_depth)])
        self.token_norm = nn.LayerNorm(D)
        self.trunk_norm = nn.LayerNorm(D)
        self.empty_pose_tokens = nn.Parameter(torch.empty(1, 1, POSE_DIM))
        self.embed_pose = nn.Linear(POSE_DIM, D)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(D, 3 * D))
        self.pose_branch = vit.Mlp(D, D // 2, POSE_DIM)


class VGGTNet(nn.Module):
    """``aggregator``, ``camera_head`` and ``depth_head`` (VGGT's point and
    track heads are not built)."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.aggregator = Aggregator(cfg)
        self.camera_head = CameraHead(cfg)
        self.depth_head = dpt.DPTHead(cfg, vggt=True)


@torch.no_grad()
def init_params(cfg: VGGTConfig, seed: int = 0, device: str | torch.device = "cpu") -> VGGTNet:
    """Random weights from ``seed``, made on ``device``: truncated normal std
    0.02 for the linear layers and the DINOv2 tokens, VGGT's std 1e-6 for the
    camera and register tokens, LayerScale at ``cfg.layerscale_init``, unit
    norms, zero biases, He-normal depth-head convolutions.  Two trained
    scales stand in where a random draw would break the outputs: the depth
    head's last convolution at 0.01 of He-normal (its ``exp`` overflows at
    full scale), and the camera's last layer at std 1e-3 with a bias that the
    summed iterations bring to the identity rotation and fields of view of
    1 rad.  On the meta device only the shapes are made."""
    device = torch.device(device)
    with device:
        net = VGGTNet(cfg)
    if device.type == "meta":
        return net
    gen = torch.Generator(device).manual_seed(seed)
    pe = net.aggregator.patch_embed
    vit.init_encoder(pe, cfg.dino(), gen)
    vit._trunc_normal_(pe.pos_embed[:, :1], 0.02, gen)  # the cls token's row, which VGGT reads
    pe.mask_token.zero_()
    agg = net.aggregator
    agg.camera_token.normal_(0.0, 1e-6, generator=gen)
    agg.register_token.normal_(0.0, 1e-6, generator=gen)
    head = net.camera_head
    for blk in [*agg.frame_blocks, *agg.global_blocks, *head.trunk]:
        for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
            vit._trunc_normal_(lin.weight, 0.02, gen)
            nn.init.zeros_(lin.bias)
        blk.ls1.gamma.fill_(cfg.layerscale_init)
        blk.ls2.gamma.fill_(cfg.layerscale_init)
    for lin in (head.embed_pose, head.poseLN_modulation[1], head.pose_branch.fc1):
        vit._trunc_normal_(lin.weight, 0.02, gen)
        nn.init.zeros_(lin.bias)
    head.empty_pose_tokens.zero_()
    out = head.pose_branch.fc2
    out.weight.normal_(0.0, 1e-3, generator=gen)
    out.bias.zero_()
    out.bias[6:9] = 1.0 / cfg.camera_iters  # quaternion w, FoV_h, FoV_w
    for m in net.modules():
        if isinstance(m, nn.LayerNorm) and m.elementwise_affine:
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    dpt.init_dpt(net.depth_head, gen)
    net.depth_head.scratch.output_conv2[2].weight.mul_(0.01)
    return net


# -- the forward ------------------------------------------------------------------

def rope_tables(grid: tuple[int, int], head_dim: int, n_special: int, freq: float,
                device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[n_special + hp·wp, 2, head_dim / 4]`` float32 of the 2D
    RoPE angles ``p · freq^(−j / (head_dim / 4))``: axis 0 is the y half
    (p = the patch's row + 1), axis 1 the x half (its column + 1); the special
    tokens sit at p = 0.  Made in float64."""
    hp, wp = grid
    quarter = head_dim // 4
    inv = freq ** (-torch.arange(quarter, dtype=torch.float64, device=device) / quarter)
    ys = torch.arange(1, hp + 1, dtype=torch.float64, device=device).repeat_interleave(wp)
    xs = torch.arange(1, wp + 1, dtype=torch.float64, device=device).repeat(hp)
    pos = torch.cat([torch.zeros(n_special, 2, dtype=torch.float64, device=device),
                     torch.stack([ys, xs], dim=-1)])
    ang = pos[:, :, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """2D RoPE of ``y [B, P, H, D]`` (P tokens a view, tables from
    :func:`rope_tables`).  Within each half of the head, channel j < D/4
    pairs with j + D/4: ``(a, b) ← (a·cos − b·sin, b·cos + a·sin)``."""
    y = y.unflatten(-1, (2, 2, y.shape[-1] // 4))  # [..., half (y, x), part (a, b), j]
    a, b = y[..., 0, :], y[..., 1, :]
    c, s = cos[:, None], sin[:, None]  # [P, 1, 2, D/4]: over the heads
    return torch.stack([a * c - b * s, b * c + a * s], dim=-2).flatten(-3)


def qk_norm_rope(ln: nn.LayerNorm, t: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """QK-norm (a LayerNorm over each head's channels) then 2D RoPE of
    ``t [B, P, H, D]``, in f32, rounded once to t's dtype."""
    y = F.layer_norm(t.float(), (t.shape[-1],), ln.weight.float(), ln.bias.float(), ln.eps)
    return apply_rope(y, cos, sin).to(t.dtype)


def _split_heads(qkv: torch.Tensor, heads: int) -> tuple[torch.Tensor, ...]:
    B, S, D3 = qkv.shape
    D = D3 // 3
    return tuple(t.reshape(B, S, heads, D // heads) for t in qkv.split(D, dim=-1))


def _block(blk, x: torch.Tensor, attention) -> torch.Tensor:
    """``x += γ₁·proj(attention(qkv(LN₁ x)))``, then ``x += γ₂·fc2(GELU(fc1(LN₂ x)))``
    (exact GELU, as DINOv2 and VGGT)."""
    a = vit.linear(blk.attn.proj, attention(vit.linear(blk.attn.qkv, vit.layer_norm(blk.norm1, x))))
    x = x + a * blk.ls1.gamma.to(x.dtype)
    m = vit.linear(blk.mlp.fc2, F.gelu(vit.linear(blk.mlp.fc1, vit.layer_norm(blk.norm2, x))))
    return x + m * blk.ls2.gamma.to(x.dtype)


def _dino_attention(heads: int):
    def attend(qkv):
        q, k, v = (t.contiguous() for t in _split_heads(qkv, heads))
        return vit.multi_head_attention(q, k, v).flatten(-2)
    return attend


def _aa_attention(attn: QKAttention, heads: int, rope, kind: str):
    """A frame block's attention (within each view, ``[N, P, H, D]``) or a
    global one (all views as one sequence, ``[1, N·P, H, D]``); QK-norm and
    RoPE in the ``model.qk`` span."""
    cos, sin = rope

    def attend(qkv):
        N, P, _ = qkv.shape
        q, k, v = _split_heads(qkv, heads)
        B, S = (N, P) if kind == "frame" else (1, N * P)
        with span("model.qk", B=B, S=S, H=heads, D=q.shape[-1], kind=kind):
            q = qk_norm_rope(attn.q_norm, q, cos, sin)
            k = qk_norm_rope(attn.k_norm, k, cos, sin)
        q, k, v = (t.reshape(B, S, heads, -1).contiguous() for t in (q, k, v))
        return vit.multi_head_attention(q, k, v).reshape(N, P, -1)
    return attend


def patch_tokens(pe: PatchEmbed, images: torch.Tensor, cfg: VGGTConfig,
                 dtype) -> tuple[torch.Tensor, tuple[int, int]]:
    """DINOv2 over each view: ``images [N, H, W, 3]`` → (final-norm patch
    tokens ``[N, hp·wp, D]``, the patch grid)."""
    N, H, W, _ = images.shape
    P, D = cfg.patch_size, cfg.embed_dim
    hp, wp = H // P, W // P
    proj = pe.patch_embed.proj
    x = F.conv2d(images.permute(0, 3, 1, 2).to(dtype), proj.weight.to(dtype), proj.bias.to(dtype),
                 stride=P).flatten(2).transpose(1, 2)
    G = cfg.base_grid
    pos = pe.pos_embed[0, 1:].reshape(G, G, D)
    if (G, G) != (hp, wp):
        pos = F.interpolate(pos.permute(2, 0, 1)[None], size=(hp, wp), mode="bicubic",
                            align_corners=False, antialias=True)[0].permute(1, 2, 0)
    x = x + pos.reshape(1, hp * wp, D).to(dtype)
    cls = pe.cls_token.to(dtype) + pe.pos_embed[:, :1].to(dtype)
    reg = pe.register_tokens.to(dtype).expand(N, -1, -1)
    x = torch.cat([cls.expand(N, 1, D), reg, x], dim=1)
    attend = _dino_attention(cfg.num_heads)
    for blk in pe.blocks:
        x = _block(blk, x, attend)
    return vit.layer_norm(pe.norm, x)[:, 1 + cfg.num_register_tokens:], (hp, wp)


def aggregate(agg: Aggregator, images: torch.Tensor, cfg: VGGTConfig,
              dtype) -> tuple[dict[int, torch.Tensor], tuple[int, int]]:
    """The aggregator: ``{i: tap i [N, S, 2D]}`` for the depth head's block
    pairs and the last one, and the patch grid."""
    patches, grid = patch_tokens(agg.patch_embed, images, cfg, dtype)
    N = patches.shape[0]

    def special(p):  # [1, 2, n, D] → [N, n, D]: the first view's, then the others'
        p = p.to(dtype)[0]
        return torch.cat([p[:1], p[1:].expand(N - 1, -1, -1)])

    x = torch.cat([special(agg.camera_token), special(agg.register_token), patches], dim=1)
    rope = rope_tables(grid, cfg.head_dim, cfg.n_prefix, cfg.rope_freq, x.device)
    keep = set(cfg.dpt_layers) | {cfg.depth - 1}
    taps = {}
    for i in range(cfg.depth):
        fblk, gblk = agg.frame_blocks[i], agg.global_blocks[i]
        f = _block(fblk, x, _aa_attention(fblk.attn, cfg.num_heads, rope, "frame"))
        x = _block(gblk, f, _aa_attention(gblk.attn, cfg.num_heads, rope, "global"))
        if i in keep:
            taps[i] = torch.cat([f, x], dim=-1)
    return taps, grid


def _trunk_attention(heads: int):
    """Plain f32 softmax attention over the views (head width 128, which the
    flash kernels do not take)."""
    def attend(qkv):
        q, k, v = (t.transpose(1, 2) for t in _split_heads(qkv, heads))  # [B, H, S, Dh]
        s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        return (torch.softmax(s, dim=-1) @ v).transpose(1, 2).flatten(-2)
    return attend


@highest_precision()
def apply_camera_head(head: CameraHead, tokens: torch.Tensor, cfg: VGGTConfig,
                      image_hw: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera tokens of the last tap ``[N, 2D]`` → (extrinsics ``[N, 3, 4]``
    w2c with the first view at the identity, intrinsics ``[N, 3, 3]``), in
    f32.  Each iteration modulates the same normed tokens t by the pose
    encoding so far (the learned empty pose at first): ``u = t + gate ·
    (LN₀(t)·(1 + scale) + shift)``, runs the trunk over the views and adds
    ``pose_branch(LN(u))`` to the pose encoding, which is decoded at the
    end."""
    t = vit.layer_norm(head.token_norm, tokens.float())
    t0 = F.layer_norm(t, (t.shape[-1],), eps=ADALN_EPS)
    attend = _trunk_attention(cfg.camera_heads)
    pose = None
    for _ in range(cfg.camera_iters):
        m = vit.linear(head.embed_pose,
                       head.empty_pose_tokens[0].expand(t.shape[0], -1) if pose is None else pose)
        shift, scale, gate = vit.linear(head.poseLN_modulation[1], F.silu(m)).chunk(3, dim=-1)
        u = (t + gate * (t0 * (1 + scale) + shift))[None]  # the views as one sequence
        for blk in head.trunk:
            u = _block(blk, u, attend)
        mlp = head.pose_branch
        h = F.gelu(vit.linear(mlp.fc1, vit.layer_norm(head.trunk_norm, u[0])))
        delta = vit.linear(mlp.fc2, h)
        pose = delta if pose is None else pose + delta
    E, K = abs_t_quat_fov_to_camera(pose, image_hw)
    return se3_compose(E, se3_inverse(E[0])[None]), K


def forward_fn(net: VGGTNet, images: torch.Tensor, cfg: VGGTConfig,
               dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Normalised images ``[N, H, W, 3]`` → depth, conf, extrinsics (w2c,
    the first view at the identity), intrinsics, frame_desc (f32)."""
    N, H, W, _ = images.shape
    taps, grid = aggregate(net.aggregator, images, cfg, dtype)
    with span("model.dpt"):
        depth, conf = dpt.apply_dpt_uv(net.depth_head, [taps[i] for i in cfg.dpt_layers], grid,
                                       (H, W), cfg.n_prefix)
    last = taps[cfg.depth - 1]
    with span("model.camera"):
        extrinsics, K = apply_camera_head(net.camera_head, last[:, 0], cfg, (H, W))
    pooled = last[:, cfg.n_prefix:].float().mean(dim=1)
    frame_desc = pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)
    return {"depth": depth, "conf": conf, "extrinsics": extrinsics, "intrinsics": K,
            "frame_desc": frame_desc}


class VGGT:
    """Holds (config, network, dtype) behind ``DepthAnything3``'s inference
    contract."""

    # the solver's prefetcher may hand it decoded arrays in place of paths
    takes_arrays = True

    def __init__(self, cfg: VGGTConfig, net: VGGTNet, dtype: torch.dtype | None = None):
        self.cfg = cfg
        self.net = net.eval()
        self.device = next(net.parameters()).device
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype

    @classmethod
    def from_pretrained(cls, name: str = "VGGT-1B", seed: int = 0,
                        device: str | torch.device = "cuda") -> "VGGT":
        """A preset (``VGGT-1B``, ``vggt-tiny``) with random weights from
        ``seed``, made on ``device``."""
        cfg = vggt_preset(name)
        if cfg is None:
            raise KeyError(f"unknown VGGT preset {name!r}; available: {sorted(PRESETS)}")
        return cls(cfg, init_params(cfg, seed, device))

    @torch.no_grad()
    def inference(
        self,
        image: Sequence[str] | Sequence[np.ndarray] | np.ndarray | torch.Tensor,
        process_res: int = 504,
        process_res_method: str = "upper_bound_resize",
        keep_on_device: bool = False,
    ):
        """One chunk of views → ``models/da3.py:Prediction`` (numpy arrays, or
        device tensors returned without waiting with ``keep_on_device``)."""
        if process_res_method != "upper_bound_resize":
            raise ValueError(f"unsupported process_res_method {process_res_method!r}")
        with span("model.inference") as attrs:
            raw = upload_views(image, self.device, attrs)
            th, tw = upper_bound_shape(raw.shape[1], raw.shape[2], process_res,
                                       self.cfg.patch_size)
            norm = resize_normalize(raw, (th, tw))
            out = forward_fn(self.net, norm, self.cfg, self.dtype)
            fields = {"processed_images": denormalize_to_uint8(norm),
                      **{k: v.float() for k, v in out.items()}}
            return deliver(fields, keep_on_device)
