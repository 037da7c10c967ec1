"""The collectives of the multi-device paths: the ring's hop, the pipeline's
point-to-point sends, all-gather, all-reduce and broadcast, and the
differentiable operators the train steps put around them.

On NCCL groups, and on gloo groups with CPU tensors, each is the
``torch.distributed`` call.  On a gloo group with CUDA tensors (several ranks
sharing one card, where NCCL refuses a second rank on the same GPU) what
gloo does depends on the call, and the choice here is made by the group's
backend alone:

- gloo's collectives (``all_gather``, ``all_reduce``, ``broadcast``) take
  CUDA tensors and copy them through host memory themselves;
- gloo's point-to-point calls (``isend``/``irecv``/``batch_isend_irecv``) read
  a CUDA tensor's pointer as host memory (``writev``: Bad address;
  ``tools/gloo_cuda_probe.py`` checks each call), so they are staged here
  through pinned host buffers: the sender copies the tensor out before the
  send, the receiver copies the received bytes in after the wait.

Nothing computes on the host: only a hop's bytes pass through it.
``host_bytes`` counts, on this rank, the CUDA tensor bytes that gloo calls
move through host memory (sent plus received; an all-gather counts its input
and its output, an all-reduce its tensor twice).

The train steps' operators (``torch.autograd.Function``s) follow one
convention: what comes after them is computed whole and alike on every rank
of the group, so the gradient that reaches them is the same on every rank.

- :func:`copy_to_group` (Megatron's *f*, before a column-parallel linear):
  identity forward; the backward sums the ranks' partial gradients.
- :func:`reduce_from_group` (Megatron's *g*, after a row-parallel linear, and
  the sp loss's global sums): all-reduce forward; identity backward.
- :func:`gather_from_group` (the sp step's camera tokens): all-gather
  forward; the backward takes this rank's slice of the whole gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

host_bytes = 0


def _through_host(t: torch.Tensor, group) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _count(t: torch.Tensor, group) -> None:
    global host_bytes
    if _through_host(t, group):
        host_bytes += t.numel() * t.element_size()


def peer(group, offset: int) -> int:
    """Global rank of the group member ``offset`` places after this rank."""
    n = dist.get_world_size(group)
    return dist.get_global_rank(group, (dist.get_rank(group) + offset) % n)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0, in group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    _count(t, group)
    _count(out, group)
    dist.all_gather(list(out.chunk(n)), t, group=group)
    return out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``t``, in place (every rank gets the same bits)."""
    if dist.get_world_size(group) > 1:
        _count(t, group)
        _count(t, group)
        dist.all_reduce(t, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` from group rank ``src`` on every member (in place on the others)."""
    if dist.get_world_size(group) > 1:
        _count(t, group)
        dist.broadcast(t, dist.get_global_rank(group, src), group=group)
    return t


def _flat_collective(ts: list[torch.Tensor], op) -> None:
    """``op`` on the concatenation of ``ts`` (one dtype, one device), in one
    call, the results copied back into ``ts``."""
    flat = op(torch.cat([t.reshape(-1) for t in ts]))
    offset = 0
    for t in ts:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_tensors(ts: list[torch.Tensor], group) -> None:
    """The group's sum of each of ``ts``, in place, in one collective."""
    if ts and dist.get_world_size(group) > 1:
        _flat_collective(ts, lambda flat: all_reduce(flat, group))


def broadcast_tensors(ts: list[torch.Tensor], src: int, group) -> None:
    """Each of ``ts`` from group rank ``src`` on every member, in one collective."""
    if ts and dist.get_world_size(group) > 1:
        _flat_collective(ts, lambda flat: broadcast(flat, src, group))


class Exchange:
    """Point-to-point transfers in flight: ``wait()`` returns the received
    tensors, on the device of the tensors they replace."""

    def __init__(self, works, received, targets, keep):
        self._works, self._received, self._targets = works, received, targets
        self._keep = keep  # the sent tensors (or their host copies), alive until the wait

    def wait(self) -> list[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._keep = None
        return [r if t is None else t.copy_(r)
                for r, t in zip(self._received, self._targets)]


def start_exchange(send: list[torch.Tensor], dst: int | None, src: int | None, group,
                   recv_like: list[torch.Tensor] | None = None) -> Exchange:
    """Send ``send`` to global rank ``dst`` and receive as many tensors shaped
    like ``recv_like`` (default: like ``send``) from global rank ``src``
    (either may be None), without waiting.  On a gloo group CUDA tensors go
    through pinned host buffers (module docstring)."""
    recv_like = send if recv_like is None else recv_like
    ops, keep, received, targets = [], [], [], []
    if dst is not None:
        for t in send:
            t = t.contiguous()
            _count(t, group)
            if _through_host(t, group):
                t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
            keep.append(t)
            ops.append(dist.P2POp(dist.isend, t, dst, group))
    if src is not None:
        for like in recv_like:
            _count(like, group)
            if _through_host(like, group):
                received.append(torch.empty(like.shape, dtype=like.dtype, pin_memory=True))
                targets.append(torch.empty_like(like, memory_format=torch.contiguous_format))
            else:
                received.append(torch.empty_like(like, memory_format=torch.contiguous_format))
                targets.append(None)
            ops.append(dist.P2POp(dist.irecv, received[-1], src, group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return Exchange(works, received, targets, keep)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, the group's sum of the gradient backward."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum forward, the gradient unchanged backward."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` concatenated along dim 0 forward, this rank's rows of
    the gradient backward."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _GatherFromGroup.apply(x, group)
