"""DPT dense prediction head: patch tokens → depth + confidence + ray maps
(counterpart of ``da3slam_tpu/models/dpt.py``).

Module names follow the released DPT/MiDaS heads (``projects.k``,
``resize_layers.k``, ``scratch.layerN_rn``, ``scratch.refinenetN.
resConfUnitM.convK``, ``scratch.output_conv1/2``).  The public function keeps
the JAX package's NHWC layouts; inside, the convolutions run NCHW.

Output contract: depth ``[N, H, W]`` positive, conf ``[N, H, W]`` ≥ 1,
rays ``[N, H, W, 6]`` = [unit direction | moment ⊥ direction].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from da3slam_tpu_torch.models.config import ModelConfig


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
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        F_ = cfg.dpt_dim
        for k, f in enumerate(cfg.dpt_features):
            setattr(self, f"layer{k + 1}_rn", _conv(f, F_, 3))
            setattr(self, f"refinenet{k + 1}", FusionBlock(F_))
        self.output_conv1 = _conv(F_, F_ // 2, 3)
        self.output_conv2 = nn.Sequential(_conv(F_ // 2, 32, 3), nn.ReLU(), _conv(32, 8, 1))


class DPTHead(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        f = cfg.dpt_features
        self.projects = nn.ModuleList([_conv(cfg.embed_dim, fk, 1) for fk in f])
        # learned tap resampling: 4x / 2x transposed convs (kernel == stride),
        # identity, stride-2 3x3 conv
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(f[0], f[0], 4, stride=4),
            nn.ConvTranspose2d(f[1], f[1], 2, stride=2),
            nn.Identity(),
            _conv(f[3], f[3], 3, stride=2),
        ])
        self.scratch = Scratch(cfg)


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
        nn.init.zeros_(m.bias)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """NCHW conv with the f32 parameters cast to x's dtype."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    stride=conv.stride, padding=conv.padding)


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
    refine = [sc.refinenet1, sc.refinenet2, sc.refinenet3, sc.refinenet4]
    stage_rn = [sc.layer1_rn, sc.layer2_rn, sc.layer3_rn, sc.layer4_rn]

    stages = []
    for k, tap in enumerate(taps):
        t = tap[:, n_prefix:, :]
        fmap = t.reshape(t.shape[0], hp, wp, -1).permute(0, 3, 1, 2)
        fmap = conv2d(head.projects[k], fmap)
        if k in (0, 1):
            fmap = _deconv_exact(head.resize_layers[k], fmap)
        elif k == 3:
            fmap = conv2d(head.resize_layers[3], fmap)
        stages.append(conv2d(stage_rn[k], fmap))

    # fusion, deepest → shallowest (MiDaS FeatureFusionBlock wiring): the
    # deepest stage has one input, so only its resConfUnit2 runs; each stage
    # ends with an align-corners upsample to the next grid, then its out_conv
    y = _rcu(refine[3].resConfUnit2, stages[3])
    for k in (2, 1, 0):
        y = _resize_ac(y, stages[k].shape[2], stages[k].shape[3])
        y = conv2d(refine[k + 1].out_conv, y)
        x = _rcu(refine[k].resConfUnit1, stages[k])
        y = _rcu(refine[k].resConfUnit2, y + x)
    y = _resize_ac(y, 2 * stages[0].shape[2], 2 * stages[0].shape[3])
    y = conv2d(refine[0].out_conv, y)

    y = conv2d(sc.output_conv1, y)
    y = _resize_ac(y, H, W)
    y = F.relu(conv2d(sc.output_conv2[0], y))
    out = conv2d(sc.output_conv2[2], y).float().permute(0, 2, 3, 1)  # [N, H, W, 8]

    depth = F.softplus(out[..., 0])
    conf = 1.0 + F.softplus(out[..., 1])
    d = out[..., 2:5]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)
    m = out[..., 5:8]
    m = m - torch.sum(m * d, dim=-1, keepdim=True) * d  # moment ⊥ direction
    return depth, conf, torch.cat([d, m], dim=-1)
