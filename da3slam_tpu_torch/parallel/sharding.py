"""Tensor-parallel sharding rules for DA3 parameters and batches (counterpart
of ``da3slam_tpu/parallel/sharding.py``).

The Megatron pattern: the first projection of each pair is column-parallel
(``attn.qkv``, ``mlp.fc1``, SwiGLU's ``mlp.w12``: each tp rank holds a slice
of the output features), the second row-parallel (``attn.proj``,
``mlp.fc2``, ``mlp.w3``: a slice of the input features).  Everything else
(norms, LayerScales, embeddings, the heads, the row-parallel linears'
biases) is replicated.  Where GSPMD inserts the collectives for the JAX
package, a tp shard here runs them itself (``models/vit.py:_block``): the
column-parallel input goes through ``comm.copy_to_group`` (Megatron's *f*),
the row-parallel output through ``comm.reduce_from_group`` (*g*), and the
row-parallel bias is added once, after the sum.

The fused tensors are cut by their parts, not contiguously: ``qkv`` is
``[q | k | v]`` and rank r holds heads ``r·H/tp .. (r+1)·H/tp`` of each of
the three, so attention runs on its ``H/tp`` heads locally; ``w12`` is
``[gate | value]`` and rank r holds the same slice of both, so
``silu(gate)·value`` stays on the rank (the JAX package keeps ``wg`` and
``wv`` apart and shards them alike).

:func:`param_shardings` gives each parameter's rule by its name in
``net.named_parameters()`` as a partition spec over the torch tensor's
dimensions (``("tp", None)``: dim 0 split over the tp axis; ``()``:
replicated).  Torch linears are ``[out, in]``, the JAX package's
``[in, out]``: the same rule reads transposed.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist
from torch import nn

from da3slam_tpu_torch.parallel import comm
from da3slam_tpu_torch.parallel.mesh import DeviceMesh, axis_size

# (pattern of an encoder block's parameter name, spec over the torch
# tensor's dims, fused parts along the split dim).  Only encoder blocks: the
# camera head's own mlp.fc1/fc2 are replicated, as in the JAX package
_BLOCK_RULES = (
    (r"attn\.qkv\.weight$", ("tp", None), 3),
    (r"attn\.qkv\.bias$", ("tp",), 3),
    (r"mlp\.w12\.weight$", ("tp", None), 2),
    (r"mlp\.w12\.bias$", ("tp",), 2),
    (r"mlp\.fc1\.weight$", ("tp", None), 1),
    (r"mlp\.fc1\.bias$", ("tp",), 1),
    (r"attn\.proj\.weight$", (None, "tp"), 1),
    (r"mlp\.fc2\.weight$", (None, "tp"), 1),
    (r"mlp\.w3\.weight$", (None, "tp"), 1),
)
_RULES = tuple((re.compile(r"^blocks\.\d+\." + pattern), spec, parts)
               for pattern, spec, parts in _BLOCK_RULES)


def _rule(name: str) -> tuple[tuple, int]:
    for pattern, spec, parts in _RULES:
        if pattern.search(name):
            return spec, parts
    return (), 1


def spec_for(name: str) -> tuple:
    """The partition spec of one parameter, by its name."""
    return _rule(name)[0]


def param_shardings(net: nn.Module) -> dict[str, tuple]:
    """Each parameter's partition spec, keyed by its name in
    ``net.named_parameters()``."""
    return {name: spec_for(name) for name, _ in net.named_parameters()}


def batch_sharding(mesh: DeviceMesh, n_windows: int) -> slice:
    """The windows of a ``[B, ...]`` batch this rank takes: batches shard over
    dp on the leading axis."""
    dp = axis_size(mesh, "dp")
    if n_windows % dp:
        raise ValueError(f"{n_windows} windows do not divide over the dp axis of {dp}")
    per = n_windows // dp
    r = mesh.get_local_rank("dp")
    return slice(r * per, (r + 1) * per)


def replicated(name: str) -> bool:
    return spec_for(name) == ()


def shard_tensor(name: str, whole: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s shard of the whole tensor ``name``."""
    spec, parts = _rule(name)
    if not spec or size == 1:
        return whole
    dim = spec.index("tp")
    n = whole.shape[dim]
    if n % (parts * size):
        raise ValueError(f"tp={size} must divide {name}'s {n // parts} features")
    chunk = n // (parts * size)
    moved = whole.movedim(dim, 0)
    t = moved.reshape(parts, size, chunk, *moved.shape[1:])
    return t[:, rank].reshape(parts * chunk, *t.shape[3:]).movedim(0, dim).contiguous()


def unshard_tensor(name: str, shards: list[torch.Tensor]) -> torch.Tensor:
    """The whole tensor ``name`` from its tp shards in rank order (the
    inverse of :func:`shard_tensor`)."""
    spec, parts = _rule(name)
    if not spec or len(shards) == 1:
        return shards[0]
    dim = spec.index("tp")
    moved = [s.movedim(dim, 0) for s in shards]
    chunk = moved[0].shape[0] // parts
    t = torch.stack([m.reshape(parts, chunk, *m.shape[1:]) for m in moved], dim=1)
    return t.reshape(parts * len(shards) * chunk, *t.shape[3:]).movedim(0, dim).contiguous()


class TensorParallel:
    """What a tp shard's blocks run their collectives with (``vit._block``)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return comm.copy_to_group(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return comm.reduce_from_group(x, self.group)


def check_tp(cfg, tp: int) -> None:
    """``tp`` must divide the head count and the MLP hidden width (the error
    ``make_mesh`` raises for a tp that does not divide the devices)."""
    for what, n in (("num_heads", cfg.num_heads), ("mlp_hidden", cfg.mlp_hidden)):
        if n % tp:
            raise ValueError(f"tp={tp} must divide {what} {n}")


def shard_tp(net: nn.Module, cfg, group) -> nn.Module:
    """Cut a whole network into this rank's tp shard, in place: each
    column- and row-parallel tensor becomes the rank's slice, and every
    encoder block runs its collectives over ``group``.  The replicated
    parameters stay as they are."""
    size = dist.get_world_size(group)
    if size == 1:
        return net
    check_tp(cfg, size)
    rank = dist.get_rank(group)
    modules = dict(net.named_modules())
    for name, p in list(net.named_parameters()):
        if replicated(name):
            continue
        owner, _, attr = name.rpartition(".")
        shard = shard_tensor(name, p.detach(), rank, size).clone()
        setattr(modules[owner], attr, nn.Parameter(shard, requires_grad=p.requires_grad))
    tp = TensorParallel(group)
    for blk in net.blocks:
        blk.tp = tp
    return net


def gather_tp(named: dict[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """The whole tensors from every tp rank's shards of ``named`` (a
    collective: every rank of ``group`` calls it; every rank gets them)."""
    size = 1 if group is None else dist.get_world_size(group)
    out = {}
    for name, t in named.items():
        if replicated(name) or size == 1:
            out[name] = t
            continue
        out[name] = unshard_tensor(name, list(comm.all_gather(t.contiguous()[None], group)))
    return out
