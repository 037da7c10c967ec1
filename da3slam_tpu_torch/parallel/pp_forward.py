"""Pipeline-parallel (pp) encoder forward for the big DA3 tiers (counterpart
of ``da3slam_tpu/parallel/pp_forward.py``).

GPipe over the ranks of a ``pp`` mesh axis: the encoder's blocks are split
into ``n_stages`` contiguous stages, and rank s holds only its stage's
``depth / n_stages`` blocks (a ``ModuleList``) plus the small replicated
rest (patch embedding, tokens, final norm): that split is the per-rank
weight memory the JAX package gets from stacking the blocks and sharding
them over the axis.  Microbatches of views flow down the stages over
M + S − 1 ticks: at tick t stage s runs microbatch m = t − s, if there is
one (the JAX scan also computes the bubble's ticks and discards them), and
sends its activations to stage s + 1.

- **Alternating intra-/cross-view blocks.**  Whether a block is cross-view
  follows from its global index, ``s · depth/S + j``: a Python int here,
  where the JAX stage id is traced and picks the branch with ``lax.cond``.
- **DPT taps.**  The head reads four interior layers (``cfg.dpt_layers``),
  which generally live on different stages.  Taps never travel down the
  pipeline: each stage keeps those of its own layers, and after the last
  tick each is broadcast from its owner (the JAX package sums the stages'
  disjoint slots, an assembly too).  The final activations come from the
  last stage the same way.
"""

from __future__ import annotations

import torch
from torch import nn

from da3slam_tpu_torch.models import vit
from da3slam_tpu_torch.models.config import ModelConfig
from da3slam_tpu_torch.parallel import comm
from da3slam_tpu_torch.parallel.mesh import DeviceMesh, axis_size


class EncoderRest(nn.Module):
    """The encoder without its blocks: what ``vit.embed`` and the final norm
    read, shared with (not copied from) the encoder it came from."""

    def __init__(self, enc: vit.ViTEncoder):
        super().__init__()
        self.base_grid = enc.base_grid
        self.patch_embed = enc.patch_embed
        self.cls_token = enc.cls_token
        self.register_tokens = enc.register_tokens
        self.pos_embed = enc.pos_embed
        self.norm = enc.norm


def stage_range(depth: int, n_stages: int, stage: int) -> range:
    """The global block indices of ``stage``."""
    if depth % n_stages != 0:
        raise ValueError(f"n_stages={n_stages} must divide depth={depth}")
    per = depth // n_stages
    return range(stage * per, (stage + 1) * per)


def split_encoder_params(enc: vit.ViTEncoder, n_stages: int, stage: int
                         ) -> tuple[nn.ModuleList, EncoderRest]:
    """Encoder → (``stage``'s blocks, the rest).  The blocks are the
    encoder's own modules: drop the encoder afterwards to free the others."""
    blocks = nn.ModuleList(enc.blocks[i] for i in stage_range(len(enc.blocks), n_stages, stage))
    return blocks, EncoderRest(enc)


def make_pp_encode(
    cfg: ModelConfig,
    mesh: DeviceMesh,
    n_stages: int | None = None,
    dtype: torch.dtype = torch.float32,
):
    """Build the pipelined encoder forward.

    Returns ``encode_pp(stage_blocks, rest, images_mb)`` with ``images_mb:
    [M, N, H, W, 3]`` (M microbatches of N views, the same on every rank) and
    this rank's stage blocks, producing on every rank ``(taps [M, n_taps, N,
    S, D], final [M, N, S, D])``: the contract of ``vit.encode`` per
    microbatch, so the DPT and camera heads apply unchanged downstream.
    """
    size = axis_size(mesh, "pp")
    if n_stages is None:
        n_stages = size
    if size != n_stages:
        raise ValueError(f"mesh pp axis is {size}, expected {n_stages} stages")
    stage_range(cfg.depth, n_stages, 0)  # raises unless the stages divide the depth
    S = n_stages
    stage = mesh.get_local_rank("pp")
    group = mesh.get_group("pp")
    owned = stage_range(cfg.depth, S, stage)
    interval = cfg.cross_view_interval

    @torch.no_grad()
    def encode_pp(stage_blocks: nn.ModuleList, rest: EncoderRest, images_mb: torch.Tensor):
        M, N, H, W, _ = images_mb.shape
        hp, wp = H // cfg.patch_size, W // cfg.patch_size
        x_like = torch.empty(N, vit.num_prefix_tokens(cfg) + hp * wp, cfg.embed_dim,
                             dtype=dtype, device=images_mb.device)
        taps = torch.empty(len(cfg.dpt_layers), M, *x_like.shape, dtype=dtype,
                           device=x_like.device)
        final = torch.empty(M, *x_like.shape, dtype=dtype, device=x_like.device)
        sends = []
        for t in range(M + S - 1):
            m = t - stage
            if not 0 <= m < M:
                continue  # the bubble: this stage has no microbatch at tick t
            if stage == 0:
                x, _ = vit.embed(rest, images_mb[m], cfg, dtype)
            else:
                x, = comm.start_exchange([], None, comm.peer(group, -1), group,
                                         recv_like=[x_like]).wait()
            for g, blk in zip(owned, stage_blocks):
                x = vit._block(blk, x, cfg.num_heads, g % interval == interval - 1)
                if g in cfg.dpt_layers:
                    taps[cfg.dpt_layers.index(g), m] = x
            if stage < S - 1:
                sends.append(comm.start_exchange([x], comm.peer(group, 1), None, group))
            else:
                final[m] = vit.layer_norm(rest.norm, x)
        for s in sends:
            s.wait()
        # assemble: each tap from the stage that owns its layer, final from the last
        per = cfg.depth // S
        for k, layer in enumerate(cfg.dpt_layers):
            comm.broadcast(taps[k], layer // per, group)
        comm.broadcast(final, S - 1, group)
        return taps.transpose(0, 1), final

    return encode_pp
