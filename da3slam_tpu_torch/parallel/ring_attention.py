"""Ring attention: cross-view attention sharded over the view/sequence axis
(counterpart of ``da3slam_tpu/parallel/ring_attention.py``).

Each rank keeps its views' Q and passes K/V shards around the ring, so the
full [S, S] attention exists on no rank.  On CUDA tensors every hop's block
is the bound flash forward (``ops/flash_attention.py:flash_attention_bound``),
which returns the block's output O_i and lse_i = log2 Σ_j 2^s_ij (base 2,
log2(e)/√D folded into q); the blocks fold by lse, in f32:

    lse = log2 Σ_i 2^lse_i,    O = Σ_i 2^(lse_i − lse) · O_i

which is what the JAX package's online softmax (``_block_update``) computes,
without forming a score tensor.  On CPU tensors each hop runs the stable
forward's plain version, which holds logits of any norm (the bound forward
underflows at logits of norm ~1e3 by design), folded the same way.
:func:`ring_attention_reference` is the JAX online softmax itself, on any
device: the plain version the card's ring is held to.

n − 1 rotate-and-fold hops, then the last block folds without rotating; the
next hop's K/V are in flight while a block computes.  The kernel takes one S
for q, k and v: the shards are equal because the view count divides the axis.

:func:`ring_attention` is differentiable (:class:`RingAttention`, what
``jax.grad`` through ``ppermute`` gives the JAX ring).  The forward saves q,
the resident K/V shards, O and the *global* lse; the backward takes Δ =
rowsum(dO·O) locally and rotates K/V around the ring once more, with each
block's dk/dv accumulators (f32) travelling beside it:

    dq += dq_kernel(q, K_b, V_b, dO, lse, Δ)      dK_b, dV_b += dkv_kernel(...)

The kernels recompute p = exp2(q'·K_bᵀ − lse); with the global lse that is
the true softmax over all blocks, so the hop sums are the whole gradients.
After the n-th hop the accumulators take one more hop, to the block's owner.
On CUDA tensors the hops run the flash backward kernels
(``ops/flash_attention.py``: ``flash_attention_bwd_dq``,
``flash_attention_bwd_dkv``), on CPU tensors their plain versions; both share
this hop schedule.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from da3slam_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention_bound,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_stable_reference,
)
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


def _ring_lse(q, k, v, group, forward) -> tuple[torch.Tensor, torch.Tensor]:
    """``forward`` (a flash forward: ``(O, lse)``) on each hop's block, folded
    by lse: ``(O, lse [B*H, S] f32, base 2)`` over all blocks."""

    def fold(state, k_blk, v_blk):
        o, lse = forward(q, k_blk, v_blk)
        if state is None:
            return o.float(), lse
        return fold_lse(*state, o, lse)

    return _ring(q, k, v, group, lambda: None, fold, lambda s: (s[0].to(q.dtype), s[1]))


def _ring_forward(q, k, v, group) -> tuple[torch.Tensor, torch.Tensor]:
    """The bound flash forward a hop on CUDA tensors, the stable forward's
    plain version on CPU tensors: ``(O, lse)``."""
    if q.device.type == "cpu":
        return _ring_lse(q, k, v, group, flash_attention_stable_reference)
    return _ring_lse(q, k, v, group, flash_attention_bound)


def ring_attention_flash(q, k, v, group) -> torch.Tensor:
    """The card's ring: the bound flash forward on each hop's block, folded by
    lse (module docstring).  On CPU tensors each hop runs the forward's plain
    version."""
    return _ring_lse(q, k, v, group, flash_attention_bound)[0]


def ring_attention_backward(q, k, v, o, lse, do, group, dq_fn=flash_attention_bwd_dq,
                            dkv_fn=flash_attention_bwd_dkv):
    """``(dq, dk, dv)`` of this rank's shards from the global ``lse``: the hop
    schedule of the module docstring, each hop's block through ``dq_fn`` and
    ``dkv_fn`` (the flash backward's wrappers; their plain versions give the
    plain ring).  dO is rounded to q's dtype; the sums over hops are f32."""
    do = do.to(q.dtype).contiguous()
    delta = attention_delta(o, do)
    n = 1 if group is None else dist.get_world_size(group)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for hop in range(n):
        dq += dq_fn(q, k, v, do, lse, delta).float()
        dk_hop, dv_hop = dkv_fn(q, k, v, do, lse, delta)
        dk += dk_hop.float()
        dv += dv_hop.float()
        if n > 1:  # the block moves on with its sums; after the last hop only the sums
            send = [k, v, dk, dv] if hop < n - 1 else [dk, dv]
            got = comm.start_exchange(send, comm.peer(group, 1), comm.peer(group, -1),
                                      group).wait()
            if hop < n - 1:
                k, v, dk, dv = got
            else:
                dk, dv = got
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """The ring, differentiable (module docstring).  The forward
    (:func:`_ring_forward`) gives the global lse the backward needs; without
    a graph it is the ring's output all the same."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        o, lse = _ring_forward(q, k, v, group)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group = group
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*ring_attention_backward(q, k, v, o, lse, do, ctx.group), None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group) -> torch.Tensor:
    """Full (non-causal) attention over the concatenation of the group's
    shards, K/V rotating around it, differentiable.  Per-rank ``[B, S_shard,
    H, D]``; returns this rank's shard of the output.  ``group=None`` is a
    ring of one."""
    return RingAttention.apply(q, k, v, group)


def make_ring_cross_view_attention(mesh: DeviceMesh, axis_name: str = "dp"):
    """Ring attention over ``mesh``'s ``axis_name`` group: each rank passes
    its own shards of q, k, v (views sharded on S over the axis)."""
    group = mesh.get_group(axis_name)

    def attn(q, k, v):
        return ring_attention(q, k, v, group)

    return attn
