"""The collectives of the multi-device paths: the ring's hop, the pipeline's
point-to-point sends, all-gather and broadcast.

On NCCL groups, and on gloo groups with CPU tensors, each is the
``torch.distributed`` call.  On a gloo group with CUDA tensors (several ranks
sharing one card, where NCCL refuses a second rank on the same GPU) what
gloo does depends on the call, and the choice here is made by the group's
backend alone:

- gloo's collectives (``all_gather``, ``broadcast``) take CUDA tensors and
  copy them through host memory themselves;
- gloo's point-to-point calls (``isend``/``irecv``/``batch_isend_irecv``) read
  a CUDA tensor's pointer as host memory (``writev``: Bad address;
  ``tools/gloo_cuda_probe.py`` checks each call), so they are staged here
  through pinned host buffers: the sender copies the tensor out before the
  send, the receiver copies the received bytes in after the wait.

Nothing computes on the host: only a hop's bytes pass through it.
``host_bytes`` counts, on this rank, the CUDA tensor bytes that gloo calls
move through host memory (sent plus received; an all-gather counts its input
and its output).
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


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` from group rank ``src`` on every member (in place on the others)."""
    if dist.get_world_size(group) > 1:
        _count(t, group)
        dist.broadcast(t, dist.get_global_rank(group, src), group=group)
    return t


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
