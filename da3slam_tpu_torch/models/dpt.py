"""DPT dense prediction head: patch tokens → depth + confidence + ray maps
(counterpart of ``da3slam_tpu/models/dpt.py``).

Module names follow the released DPT/MiDaS heads (``projects.k``,
``resize_layers.k``, ``scratch.layerN_rn``, ``scratch.refinenetN.
resConfUnitM.convK``, ``scratch.output_conv1/2``).  The public function keeps
the JAX package's NHWC layouts; inside, the convolutions run NCHW.

Output contract: depth ``[N, H, W]`` positive, conf ``[N, H, W]`` ≥ 1,
rays ``[N, H, W, 6]`` = [unit direction | moment ⊥ direction].

VGGT's depth head (``models/vggt.py``) is the same network with three
additions, each absent from DA3's head, whose numbers they leave as they
were: a LayerNorm over each tap (``norm``), a 2D sin-cos embedding of a uv
grid added after each projection and before the last convolutions
(:func:`uv_embed`), and ``exp`` outputs (:func:`apply_dpt_uv`).  Its
``layerN_rn`` convolutions have no bias and its deepest fusion block no first
residual unit, as VGGT's checkpoint stores them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from da3slam_tpu_torch.models.config import ModelConfig
from da3slam_tpu_torch.models.vit import layer_norm


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    # k=3 with padding 1 is the JAX package's stride-1 "SAME"; the stride-2
    # resize conv pads symmetrically by 1 as well (torch's convention)
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


class ResConfUnit(nn.Module):
    def __init__(self, F_: int):
        super().__init__()
        self.conv1 = _conv(F_, F_, 3)
        self.conv2 = _conv(F_, F_, 3)


class FusionBlock(nn.Module):
    def __init__(self, F_: int):
        super().__init__()
        self.resConfUnit1 = ResConfUnit(F_)
        self.resConfUnit2 = ResConfUnit(F_)
        self.out_conv = _conv(F_, F_, 1)


class Scratch(nn.Module):
    def __init__(self, cfg: ModelConfig, vggt: bool = False):
        super().__init__()
        F_ = cfg.dpt_dim
        for k, f in enumerate(cfg.dpt_features):
            rn = nn.Conv2d(f, F_, 3, padding=1, bias=not vggt)
            setattr(self, f"layer{k + 1}_rn", rn)
            setattr(self, f"refinenet{k + 1}", FusionBlock(F_))
        if vggt:  # the deepest stage has one input: VGGT stores no unit for a second
            del self.refinenet4.resConfUnit1
        self.output_conv1 = _conv(F_, F_ // 2, 3)
        out_dim = 2 if vggt else 8  # VGGT: depth and confidence; DA3: and the ray maps
        self.output_conv2 = nn.Sequential(_conv(F_ // 2, 32, 3), nn.ReLU(), _conv(32, out_dim, 1))


class DPTHead(nn.Module):
    """DA3's head; ``vggt=True`` builds VGGT's (taps of the frame and global
    outputs side by side, ``2 · embed_dim`` wide, a LayerNorm over them,
    depth and confidence only)."""

    def __init__(self, cfg, vggt: bool = False):
        super().__init__()
        f = cfg.dpt_features
        in_dim = 2 * cfg.embed_dim if vggt else cfg.embed_dim
        if vggt:
            self.norm = nn.LayerNorm(in_dim)  # torch's eps, 1e-5, as VGGT's
        self.projects = nn.ModuleList([_conv(in_dim, fk, 1) for fk in f])
        # learned tap resampling: 4x / 2x transposed convs (kernel == stride),
        # identity, stride-2 3x3 conv
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(f[0], f[0], 4, stride=4),
            nn.ConvTranspose2d(f[1], f[1], 2, stride=2),
            nn.Identity(),
            _conv(f[3], f[3], 3, stride=2),
        ])
        self.scratch = Scratch(cfg, vggt)


def _convs(head: DPTHead) -> list[nn.Module]:
    return [m for m in head.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]


@torch.no_grad()
def init_dpt(head: DPTHead, generator: torch.Generator) -> None:
    """He-normal kernels (std sqrt(2 / fan_in), fan_in = kh·kw·cin as the JAX
    package counts it) and zero biases."""
    for m in _convs(head):
        kh, kw = m.kernel_size
        cin = m.in_channels
        m.weight.normal_(0.0, (2.0 / (kh * kw * cin)) ** 0.5, generator=generator)
        if m.bias is not None:
            nn.init.zeros_(m.bias)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """NCHW conv with the f32 parameters cast to x's dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, stride=conv.stride, padding=conv.padding)


def _deconv_exact(deconv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """ConvTranspose with kernel == stride: each input pixel expands to an
    independent s×s tile."""
    return F.conv_transpose2d(x, deconv.weight.to(x.dtype), deconv.bias.to(x.dtype),
                              stride=deconv.stride)


def _resize_ac(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Align-corners bilinear resize of NCHW ``x`` (the published heads'
    ``interpolate(align_corners=True)``)."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def _rcu(rcu: ResConfUnit, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(rcu.conv1, F.relu(x))
    h = conv2d(rcu.conv2, F.relu(h))
    return x + h


def _stage(head: DPTHead, k: int, fmap: torch.Tensor, uv: bool = False) -> torch.Tensor:
    """Tap ``k`` as an NCHW map → its projection, (VGGT) uv embedding,
    learned resample and ``layer{k+1}_rn``."""
    fmap = conv2d(head.projects[k], fmap)
    if uv:
        fmap = add_uv_embed(fmap)
    if k in (0, 1):
        fmap = _deconv_exact(head.resize_layers[k], fmap)
    elif k == 3:
        fmap = conv2d(head.resize_layers[3], fmap)
    sc = head.scratch
    return conv2d((sc.layer1_rn, sc.layer2_rn, sc.layer3_rn, sc.layer4_rn)[k], fmap)


def _fuse(head: DPTHead, stages: list[torch.Tensor]) -> torch.Tensor:
    """Fusion, deepest → shallowest (MiDaS FeatureFusionBlock wiring), then
    ``output_conv1``.  The deepest stage has one input, so only its
    resConfUnit2 runs; each stage ends with an align-corners upsample to the
    next grid, then its out_conv."""
    sc = head.scratch
    refine = [sc.refinenet1, sc.refinenet2, sc.refinenet3, sc.refinenet4]
    y = _rcu(refine[3].resConfUnit2, stages[3])
    for k in (2, 1, 0):
        y = _resize_ac(y, stages[k].shape[2], stages[k].shape[3])
        y = conv2d(refine[k + 1].out_conv, y)
        x = _rcu(refine[k].resConfUnit1, stages[k])
        y = _rcu(refine[k].resConfUnit2, y + x)
    y = _resize_ac(y, 2 * stages[0].shape[2], 2 * stages[0].shape[3])
    y = conv2d(refine[0].out_conv, y)
    return conv2d(sc.output_conv1, y)


def apply_dpt(
    head: DPTHead,
    taps: list[torch.Tensor],
    grid: tuple[int, int],
    out_hw: tuple[int, int],
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """taps: 4 × ``[N, S, D]`` encoder activations (with prefix tokens).

    Returns f32 ``(depth [N, H, W], conf [N, H, W], rays [N, H, W, 6])``.
    """
    hp, wp = grid
    H, W = out_hw
    n_prefix = 1 + cfg.num_register_tokens
    sc = head.scratch
    stages = []
    for k, tap in enumerate(taps):
        t = tap[:, n_prefix:, :]
        stages.append(_stage(head, k, t.reshape(t.shape[0], hp, wp, -1).permute(0, 3, 1, 2)))
    y = _resize_ac(_fuse(head, stages), H, W)
    y = F.relu(conv2d(sc.output_conv2[0], y))
    out = conv2d(sc.output_conv2[2], y).float().permute(0, 2, 3, 1)  # [N, H, W, 8]

    depth = F.softplus(out[..., 0])
    conf = 1.0 + F.softplus(out[..., 1])
    d = out[..., 2:5]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)
    m = out[..., 5:8]
    m = m - torch.sum(m * d, dim=-1, keepdim=True) * d  # moment ⊥ direction
    return depth, conf, torch.cat([d, m], dim=-1)


# -- VGGT's head ------------------------------------------------------------------

UV_OMEGA0 = 100.0  # VGGT's position_grid_to_embed
UV_RATIO = 0.1  # the scale of the embedding added to the maps


def uv_embed(h: int, w: int, channels: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """VGGT's ``create_uv_grid`` + ``position_grid_to_embed``, in float32:
    ``[channels, h, w]``.  The grid spans the map's diagonal-normalised
    extent (with aspect a = w / h: x over ``a / √(a² + 1)``, y over
    ``1 / √(a² + 1)``, cell centres); each axis gets ``channels / 2``
    channels, sin ‖ cos of ``pos · ω₀^(−2i / (channels / 2))``, x first.
    Every map of the head keeps the image's aspect, VGGT's ``W / H``.  Made
    in float64, so the grid's coordinates do not take the activations'
    rounding."""
    aspect = w / h
    diag = (aspect * aspect + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, w, dtype=torch.float64, device=device)
    ys = torch.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, h, dtype=torch.float64, device=device)
    half = channels // 2
    omega = 1.0 / UV_OMEGA0 ** (torch.arange(half // 2, dtype=torch.float64, device=device)
                                / (half / 2.0))

    def sincos(pos):  # [n] → [n, half]
        ang = pos[:, None] * omega[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    emb = torch.cat([sincos(xs)[None, :, :].expand(h, w, half),
                     sincos(ys)[:, None, :].expand(h, w, half)], dim=-1)
    return emb.permute(2, 0, 1).float()


def add_uv_embed(x: torch.Tensor) -> torch.Tensor:
    """``x + 0.1 · uv_embed`` on an NCHW map, the embedding rounded to x's
    dtype."""
    _, c, h, w = x.shape
    return x + (UV_RATIO * uv_embed(h, w, c, x.device)).to(x.dtype)[None]


def apply_dpt_uv(
    head: DPTHead,
    taps: list[torch.Tensor],
    grid: tuple[int, int],
    out_hw: tuple[int, int],
    n_prefix: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """VGGT's depth head.  taps: 4 × ``[N, S, 2D]`` (with prefix tokens).

    Each tap's patch tokens are layer-normed (in f32), projected, given the
    uv embedding and resampled; the fusion is DA3's; after ``output_conv1``
    and the resize to the image the uv embedding is added again.  Returns f32
    ``(depth = exp(y₀), conf = 1 + exp(y₁))``, each ``[N, H, W]``."""
    hp, wp = grid
    H, W = out_hw
    sc = head.scratch
    stages = []
    for k, tap in enumerate(taps):
        t = layer_norm(head.norm, tap[:, n_prefix:, :])
        stages.append(_stage(head, k, t.reshape(t.shape[0], hp, wp, -1).permute(0, 3, 1, 2),
                             uv=True))
    y = add_uv_embed(_resize_ac(_fuse(head, stages), H, W))
    y = F.relu(conv2d(sc.output_conv2[0], y))
    out = conv2d(sc.output_conv2[2], y).float()
    return torch.exp(out[:, 0]), 1.0 + torch.exp(out[:, 1])
