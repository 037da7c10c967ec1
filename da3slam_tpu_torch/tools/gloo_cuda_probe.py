"""Which gloo calls take CUDA tensors.

    python -m da3slam_tpu_torch.tools.gloo_cuda_probe

Each call runs on two gloo ranks sharing card 0 (``parallel/mesh.py:run_ranks``),
with CUDA tensors, and every rank checks what it got.  One JSON line a call:
``takes CUDA tensors``, or the failure's last line.  ``parallel/comm.py``
stages the calls that fail through pinned host memory; the point-to-point
ones failed on an H100 with torch 2.11 ("writev ... Bad address": gloo read
the CUDA pointer as host memory).  The train steps use these calls only:
``all_reduce`` (the Megatron operators, the gradient sums), ``broadcast``
(replicated gradients, pp taps), ``all_gather`` (sp camera tokens, tp
shards) and the staged point-to-point hops; no ``reduce_scatter``.
"""

from __future__ import annotations

import json

import torch
import torch.distributed as dist

from da3slam_tpu_torch.parallel.mesh import run_ranks

CALLS = ("broadcast", "all_reduce", "all_gather", "all_gather_into_tensor",
         "batch_isend_irecv")
TIMEOUT_S = 60


def probe_call(name: str) -> None:
    """One call on this rank's CUDA tensor ``rank + 1``; raises unless every
    element came out as the call defines it."""
    rank, world = dist.get_rank(), dist.get_world_size()
    t = torch.full((1024,), float(rank + 1), device="cuda")
    if name == "broadcast":
        dist.broadcast(t, 0)
        got, want = t, [1.0]
    elif name == "all_reduce":
        dist.all_reduce(t)
        got, want = t, [world * (world + 1) / 2]
    elif name == "all_gather":
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        got, want = torch.stack(parts), [float(r + 1) for r in range(world)]
    elif name == "all_gather_into_tensor":
        flat = torch.empty(world * t.numel(), device="cuda")
        dist.all_gather_into_tensor(flat, t)
        got, want = flat.reshape(world, -1), [float(r + 1) for r in range(world)]
    else:
        got = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, (rank + 1) % world),
               dist.P2POp(dist.irecv, got, (rank - 1) % world)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        want = [float((rank - 1) % world + 1)]
    torch.cuda.synchronize()
    want = torch.tensor(want, device="cuda").reshape(-1, *([1] * (got.ndim - 1)))
    if not torch.equal(got, want.expand_as(got)):
        raise AssertionError(f"{name} on rank {rank}: wrong values")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gloo_cuda_probe needs a CUDA card")
    for name in CALLS:
        try:
            run_ranks(probe_call, 2, "gloo", "cuda", TIMEOUT_S, name)
            verdict = "takes CUDA tensors"
        except (RuntimeError, TimeoutError) as e:
            verdict = "fails: " + str(e).strip().splitlines()[-1]
        print(json.dumps({"call": name, "verdict": verdict}), flush=True)


if __name__ == "__main__":
    main()
