"""Ring attention: cross-view attention sharded over the view/sequence axis
(counterpart of ``da3slam_tpu/parallel/ring_attention.py``).

Each rank keeps its views' Q and passes K/V shards around the ring, so the
full [S, S] attention exists on no rank.  On CUDA tensors every hop's block
is the bound flash forward (``ops/flash_attention.py:flash_attention_bound``),
which returns the block's output O_i and lse_i = log2 Σ_j 2^s_ij (base 2,
log2(e)/√D folded into q); the blocks fold by lse, in f32:

    lse = log2 Σ_i 2^lse_i,    O = Σ_i 2^(lse_i − lse) · O_i

which is what the JAX package's online softmax (``_block_update``) computes,
without forming a score tensor.  On CPU tensors the ring runs that online
softmax itself (:func:`ring_attention_reference`, the plain version).

n − 1 rotate-and-fold hops, then the last block folds without rotating; the
next hop's K/V are in flight while a block computes.  The kernel takes one S
for q, k and v: the shards are equal because the view count divides the axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from da3slam_tpu_torch.ops.flash_attention import flash_attention_bound
from da3slam_tpu_torch.parallel import comm
from da3slam_tpu_torch.parallel.mesh import DeviceMesh


def _block_update(q, k_blk, v_blk, m, l, acc, scale):
    """Fold one K/V block into the online-softmax state (the JAX package's
    ``_block_update``).  q: ``[B, Sq, H, D]``; k_blk/v_blk: ``[B, Sk, H, D]``;
    m, l: ``[B, Sq, H, 1]``; acc: ``[B, Sq, H, D]`` f32."""
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k_blk.float()) * scale
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bqhk,bkhd->bqhd", p.to(v_blk.dtype).float(), v_blk.float())
    return m_new, l_new, acc * alpha + pv


def fold_lse(o_acc, lse_acc, o_blk, lse_blk):
    """Fold one block's ``(O [B, S, H, D], lse [B*H, S] base 2)`` into the
    running f32 pair; O_blk is upcast."""
    B, S, H, _ = o_blk.shape
    lse_new = torch.logaddexp2(lse_acc, lse_blk)

    def weight(lse):
        return torch.exp2(lse - lse_new).reshape(B, H, S).transpose(1, 2)[..., None]

    return o_acc * weight(lse_acc) + o_blk.float() * weight(lse_blk), lse_new


def _ring(q, k, v, group, init, fold, finish):
    """The hop schedule shared by both versions: fold the resident block,
    then n − 1 times fold the block received from the previous rank."""
    n = 1 if group is None else dist.get_world_size(group)
    state = init()
    for hop in range(n):
        xfer = (comm.start_exchange([k, v], comm.peer(group, 1), comm.peer(group, -1), group)
                if hop < n - 1 else None)
        state = fold(state, k, v)
        if xfer is not None:
            k, v = xfer.wait()
    return finish(state)


def ring_attention_reference(q, k, v, group) -> torch.Tensor:
    """The plain version on any device: the JAX online softmax over the
    ring's blocks, with the ring's hops."""
    scale = 1.0 / q.shape[-1] ** 0.5

    def init():
        zeros = torch.zeros(*q.shape[:-1], 1, dtype=torch.float32, device=q.device)
        return zeros - torch.inf, zeros, torch.zeros(q.shape, dtype=torch.float32,
                                                     device=q.device)

    def fold(state, k_blk, v_blk):
        return _block_update(q, k_blk, v_blk, *state, scale)

    def finish(state):
        _, l, acc = state
        return (acc / l.clamp_min(1e-30)).to(q.dtype)

    return _ring(q, k, v, group, init, fold, finish)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group) -> torch.Tensor:
    """Full (non-causal) attention over the concatenation of the group's
    shards, K/V rotating around it.  Per-rank ``[B, S_shard, H, D]``; returns
    this rank's shard of the output.  ``group=None`` is a ring of one."""
    if q.device.type == "cpu":
        return ring_attention_reference(q, k, v, group)
    return ring_attention_flash(q, k, v, group)


def ring_attention_flash(q, k, v, group) -> torch.Tensor:
    """The card's ring: the bound flash forward on each hop's block, folded by
    lse (module docstring).  On CPU tensors each hop runs the forward's plain
    version."""

    def fold(state, k_blk, v_blk):
        o, lse = flash_attention_bound(q, k_blk, v_blk)
        if state is None:
            return o.float(), lse
        return fold_lse(*state, o, lse)

    return _ring(q, k, v, group, lambda: None, fold, lambda s: s[0].to(q.dtype))


def make_ring_cross_view_attention(mesh: DeviceMesh, axis_name: str = "dp"):
    """Ring attention over ``mesh``'s ``axis_name`` group: each rank passes
    its own shards of q, k, v (views sharded on S over the axis)."""
    group = mesh.get_group(axis_name)

    def attn(q, k, v):
        return ring_attention(q, k, v, group)

    return attn
