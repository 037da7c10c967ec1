"""Multi-view ViT encoder (DINOv2-style) with alternating intra-/cross-view
attention — the DA3 backbone (counterpart of ``da3slam_tpu/models/vit.py``).

Token layout per view: ``[camera_token, register_tokens..., patch_tokens...]``.
Intra-view blocks attend over one view's tokens (batch = views); cross-view
blocks (every ``i % interval == interval - 1``) attend over the concatenation
of all views' tokens.

Parameters live in ``nn.Module``s named after the DINOv2 state dict
(``blocks.{i}.attn.qkv``, ``blocks.{i}.ls1.gamma``, ...), kept in f32; each
op casts them to the activation dtype, as the JAX package does.  The
feed-forward is the plain MLP or, for the giant tier, DINOv2's SwiGLU.

W8A8: a block whose QKV and MLP projections are ``Int8Linear`` (made by
``quantize_encoder``) runs them int8 × int8 → int32 on inputs that the
layernorm and the MLP's nonlinearity quantize as they go (``ops/quant.py``);
attention and its out-projection stay in the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from da3slam_tpu_torch.models.config import ModelConfig
from da3slam_tpu_torch.ops.attention import multi_head_attention
from da3slam_tpu_torch.ops.quant import int8_gemm, layer_norm_quant, quantize_rows, quantize_weight

LN_EPS = 1e-6  # DINOv2's LayerNorm eps (torch's default is 1e-5)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int | None = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)


class SwiGLU(nn.Module):
    """DINOv2-giant's SwiGLUFFN: ``w3(silu(x1)·x2)`` with ``[x1 | x2] = w12(x)``,
    gate and value fused in one tensor as the released checkpoints store them."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)


class Int8Linear(nn.Module):
    """A projection quantized once, per output channel: buffers ``w8
    [in, out]`` int8, ``wscale [out]`` f32 and the float bias.  Inference
    only: it holds no parameter."""

    def __init__(self, lin: nn.Linear):
        super().__init__()
        wq = quantize_weight(lin.weight.detach().t())
        self.register_buffer("w8", wq["w8"])
        self.register_buffer("wscale", wq["wscale"])
        self.register_buffer("bias", lin.bias.detach().clone())

    def forward(self, x8: torch.Tensor, xscale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return int8_gemm(x8, xscale, {"w8": self.w8, "wscale": self.wscale}, self.bias, dtype)


def quantize_encoder(enc: "ViTEncoder") -> None:
    """Swap every block's QKV and MLP projections (``fc1``/``fc2`` or
    ``w12``/``w3``) for ``Int8Linear``, in place.  The attention
    out-projection, norms, layer scales, embeddings and heads stay float.
    ``w12`` is quantized per output column, which is what quantizing gate and
    value apart gives."""
    for blk in enc.blocks:
        blk.attn.qkv = Int8Linear(blk.attn.qkv)
        for name, lin in list(blk.mlp.named_children()):
            setattr(blk.mlp, name, Int8Linear(lin))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = nn.LayerNorm(D, eps=LN_EPS)
        self.attn = Attention(D)
        self.ls1 = LayerScale(D)
        self.norm2 = nn.LayerNorm(D, eps=LN_EPS)
        self.mlp = (SwiGLU if cfg.mlp_type == "swiglu" else Mlp)(D, cfg.mlp_hidden)
        self.ls2 = LayerScale(D)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)


class ViTEncoder(nn.Module):
    """Encoder parameters.  ``pos_embed`` is stored torch-style,
    ``[1, 1 + G², D]`` with a leading (zero) cls row that :func:`embed` strips;
    ``base_grid`` G = 37 is the patch grid at 518², the reference's default."""

    def __init__(self, cfg: ModelConfig, base_grid: int = 37):
        super().__init__()
        if cfg.mlp_type not in ("mlp", "swiglu"):
            raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}")
        D = cfg.embed_dim
        self.base_grid = base_grid
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, D))  # the camera token
        self.register_tokens = nn.Parameter(torch.empty(1, cfg.num_register_tokens, D))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + base_grid * base_grid, D))
        self.blocks = nn.ModuleList([Block(cfg) for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(D, eps=LN_EPS)


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


@torch.no_grad()
def init_encoder(enc: ViTEncoder, cfg: ModelConfig, generator: torch.Generator) -> None:
    """Random init with the JAX package's distributions (truncated normal,
    std 0.02; LayerScale at ``cfg.layerscale_init``).  The numbers differ
    from JAX's for the same seed: tests carry weights over with
    ``models/convert.py`` instead."""
    _trunc_normal_(enc.patch_embed.proj.weight, 0.02, generator)
    nn.init.zeros_(enc.patch_embed.proj.bias)
    enc.pos_embed.zero_()
    _trunc_normal_(enc.pos_embed[:, 1:], 0.02, generator)
    _trunc_normal_(enc.cls_token, 0.02, generator)
    _trunc_normal_(enc.register_tokens, 0.02, generator)
    for ln in [enc.norm] + [b.norm1 for b in enc.blocks] + [b.norm2 for b in enc.blocks]:
        nn.init.ones_(ln.weight)
        nn.init.zeros_(ln.bias)
    for blk in enc.blocks:
        for lin in (*blk.mlp.children(), blk.attn.qkv, blk.attn.proj):
            _trunc_normal_(lin.weight, 0.02, generator)
            nn.init.zeros_(lin.bias)
        blk.ls1.gamma.fill_(cfg.layerscale_init)
        blk.ls2.gamma.fill_(cfg.layerscale_init)


def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` with the f32 parameters cast to x's dtype."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 regardless of the activation dtype, eps 1e-6."""
    out = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)
    return out.to(x.dtype)


def _attn_core(attn: Attention, qkv: torch.Tensor, num_heads: int,
               attn_fn=multi_head_attention) -> torch.Tensor:
    """Split → attention (``attn_fn`` on ``[B, S, H, Dh]``) → out-projection,
    shared by the float and the W8A8 QKV producers.  qkv: ``[B, S, 3D]`` →
    ``[B, S, D]``."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    hd = D // num_heads
    q, k, v = qkv.split(D, dim=-1)
    q, k, v = (t.reshape(B, S, num_heads, hd).contiguous() for t in (q, k, v))
    out = attn_fn(q, k, v).reshape(B, S, D)
    return linear(attn.proj, out)


def _mlp(mlp: Mlp | SwiGLU, x: torch.Tensor) -> torch.Tensor:
    if isinstance(mlp, SwiGLU):
        gate, value = linear(mlp.w12, x).chunk(2, dim=-1)
        return linear(mlp.w3, F.silu(gate) * value)
    return linear(mlp.fc2, F.gelu(linear(mlp.fc1, x), approximate="tanh"))


def _mlp_w8a8(mlp: Mlp | SwiGLU, x8: torch.Tensor, xs: torch.Tensor, dtype) -> torch.Tensor:
    """Both MLP GEMMs int8: the first takes the layernorm's fused quantize,
    the second a quantize fused after the nonlinearity."""
    if isinstance(mlp, SwiGLU):
        gate, value = mlp.w12(x8, xs, dtype).chunk(2, dim=-1)
        return mlp.w3(*quantize_rows(F.silu(gate) * value), dtype)
    h8, hs = quantize_rows(F.gelu(mlp.fc1(x8, xs, dtype), approximate="tanh"))
    return mlp.fc2(h8, hs, dtype)


def _block(blk: Block, x: torch.Tensor, num_heads: int, cross_view: bool,
           cross_attn_impl=None) -> torch.Tensor:
    """x: ``[N, S, D]`` (N views).  Cross-view blocks fold the views into one
    sequence.

    ``cross_attn_impl`` lets cross-view blocks take another attention (e.g.
    the ring over a view-sharded mesh axis, ``parallel/ring_attention.py``)
    while intra-view blocks stay local: a function on ``[B, S, H, Dh]``, or
    None for ``multi_head_attention``."""
    N, S, D = x.shape
    h = x.reshape(1, N * S, D) if cross_view else x
    attn_fn = cross_attn_impl if cross_view and cross_attn_impl is not None \
        else multi_head_attention
    if isinstance(blk.attn.qkv, Int8Linear):  # made by quantize_encoder
        x8, xs = layer_norm_quant(blk.norm1.weight, blk.norm1.bias, h, blk.norm1.eps)
        a = _attn_core(blk.attn, blk.attn.qkv(x8, xs, x.dtype), num_heads, attn_fn)
        h = h + a * blk.ls1.gamma.to(x.dtype)
        m8, ms = layer_norm_quant(blk.norm2.weight, blk.norm2.bias, h, blk.norm2.eps)
        m = _mlp_w8a8(blk.mlp, m8, ms, x.dtype)
    else:
        a = _attn_core(blk.attn, linear(blk.attn.qkv, layer_norm(blk.norm1, h)), num_heads,
                       attn_fn)
        h = h + a * blk.ls1.gamma.to(x.dtype)
        m = _mlp(blk.mlp, layer_norm(blk.norm2, h))
    h = h + m * blk.ls2.gamma.to(x.dtype)
    return h.reshape(N, S, D)


def interpolate_pos_embed(pos: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Resample the learned ``[G, G, D]`` pos-embed grid to the patch grid:
    antialiased bilinear (the 37→36 resample at 504² is a downscale)."""
    if pos.shape[0] == hp and pos.shape[1] == wp:
        return pos.reshape(1, hp * wp, -1)
    out = F.interpolate(pos.permute(2, 0, 1)[None], size=(hp, wp), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).reshape(1, hp * wp, -1)


def embed(
    enc: ViTEncoder, images: torch.Tensor, cfg: ModelConfig, dtype=torch.float32
) -> tuple[torch.Tensor, tuple[int, int]]:
    """Patch conv + pos embed + [camera, register] prefix.

    ``images: [N, H, W, 3]`` → ``([N, S, D] tokens, (Hp, Wp) patch grid)``.
    """
    N, H, W, _ = images.shape
    P = cfg.patch_size
    hp, wp = H // P, W // P
    proj = enc.patch_embed.proj
    x = F.conv2d(images.permute(0, 3, 1, 2).to(dtype), proj.weight.to(dtype),
                 proj.bias.to(dtype), stride=P)
    x = x.flatten(2).transpose(1, 2)  # [N, hp*wp, D], row-major over the grid
    G = enc.base_grid
    pos = enc.pos_embed[0, 1:].reshape(G, G, cfg.embed_dim)
    x = x + interpolate_pos_embed(pos, hp, wp).to(dtype)
    cam = enc.cls_token.to(dtype).expand(N, 1, cfg.embed_dim)
    reg = enc.register_tokens.to(dtype).expand(N, cfg.num_register_tokens, cfg.embed_dim)
    return torch.cat([cam, reg, x], dim=1), (hp, wp)


def encode(
    enc: ViTEncoder, images: torch.Tensor, cfg: ModelConfig, dtype=torch.float32,
    cross_attn_impl=None,
) -> tuple[list[torch.Tensor], torch.Tensor, tuple[int, int]]:
    """Run the encoder over a chunk of views.

    Args:
      images: ``[N, H, W, 3]`` float, ImageNet-normalised, H/W multiples of
              ``patch_size``.
      cross_attn_impl: the cross-view blocks' attention (``_block``).

    Returns:
      taps:  list of ``[N, S, D]`` activations at ``cfg.dpt_layers`` (post-block)
      final: ``[N, S, D]`` final-norm output
      grid:  (Hp, Wp) patch grid
    """
    x, grid = embed(enc, images, cfg, dtype)
    taps: list[torch.Tensor] = []
    tap_set = set(cfg.dpt_layers)
    for i, blk in enumerate(enc.blocks):
        cross = (i % cfg.cross_view_interval) == (cfg.cross_view_interval - 1)
        if cfg.remat:
            # recompute the block's activations in the backward pass (trade
            # FLOPs for memory when training the large tiers)
            x = checkpoint(_block, blk, x, cfg.num_heads, cross, cross_attn_impl,
                           use_reentrant=False)
        else:
            x = _block(blk, x, cfg.num_heads, cross, cross_attn_impl)
        if i in tap_set:
            taps.append(x)
    return taps, layer_norm(enc.norm, x), grid


def num_prefix_tokens(cfg: ModelConfig) -> int:
    return 1 + cfg.num_register_tokens
