"""What each spawned rank of the multi-device training tests runs
(``tests/test_torch_sharding.py``, ``tests/test_torch_train_tp.py``,
``tests/test_torch_train_sp.py``, ``tests/test_torch_train_pp.py``).

Spawned ranks import this module by name, so it imports only numpy, torch
and the port: no rank may import JAX or the JAX package (each reports what
it imported).  Weights come in as a whole state dict of numpy arrays and
batches as numpy; the bodies return numpy from rank 0, after gathering what
every rank computed.  No tests here.
"""

import hashlib
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.parallel import comm
from da3slam_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
from da3slam_tpu_torch.parallel.mesh import make_mesh
from da3slam_tpu_torch.parallel.ring_attention import ring_attention
from da3slam_tpu_torch.parallel.sharding import replicated
from da3slam_tpu_torch.parallel.train import (
    make_pp_train_step,
    make_sp_train_step,
    make_train_step,
)


def foreign_modules() -> list[str]:
    return sorted(m for m in sys.modules if m in ("jax", "da3slam_tpu")
                  or m.startswith(("jax.", "jaxlib", "da3slam_tpu.")))


def gather(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def axis_mesh(name: str) -> DeviceMesh:
    return DeviceMesh("cpu", torch.arange(dist.get_world_size()), mesh_dim_names=(name,))


def load_whole(state, whole: dict) -> None:
    """Put a whole state dict's tensors into this rank's parameters."""
    with torch.no_grad():
        for name, p in state.net.named_parameters():
            w = state.layout.whole_name(name)
            p.copy_(state.layout.local(w, torch.from_numpy(whole[w])))


def whole_grads(state) -> dict:
    """Every parameter's gradient, put back together (a collective)."""
    named = {state.layout.whole_name(n): p.grad for n, p in state.net.named_parameters()}
    return {k: v.numpy().copy() for k, v in state.layout.gather(named).items()}


def run_steps(step_fn, place, state, batches, grads_at: int = 0) -> tuple[list, dict]:
    losses, grads = [], None
    for i, b in enumerate(batches):
        state, loss = step_fn(state, place(b))
        losses.append(loss.item())
        if i == grads_at:
            grads = whole_grads(state)
    return losses, grads


# ---------------------------------------------------------------------------
# the Megatron operators
# ---------------------------------------------------------------------------

def operator_checks(x: np.ndarray, w: np.ndarray) -> dict:
    """``copy_to_group``, ``reduce_from_group`` and ``gather_from_group`` on
    this rank's row of ``x [n, 5]`` against loss weights ``w [n, 5]`` (row r
    on rank r for f; every row on every rank for g and the gather): each
    rank's output and input gradient."""
    r = dist.get_rank()
    group = dist.group.WORLD
    out = {}
    xr = torch.from_numpy(x[r]).requires_grad_()
    y = comm.copy_to_group(xr, group)
    (y * torch.from_numpy(w[r])).sum().backward()
    out["f"] = (y.detach().numpy(), xr.grad.numpy())
    xr = torch.from_numpy(x[r]).requires_grad_()
    y = comm.reduce_from_group(xr, group)
    (y * torch.from_numpy(w[0])).sum().backward()
    out["g"] = (y.detach().numpy(), xr.grad.numpy())
    xr = torch.from_numpy(x[r][None]).requires_grad_()
    y = comm.gather_from_group(xr, group)
    (y * torch.from_numpy(w)).sum().backward()
    out["gather"] = (y.detach().numpy(), xr.grad.numpy())
    return {"ops": gather(out), "foreign": gather(foreign_modules())}


# ---------------------------------------------------------------------------
# dp x tp
# ---------------------------------------------------------------------------

def tp_run(cfg_kw: dict, n: int, tp: int, whole: dict, batches: list, ckpt: str | None) -> dict:
    """``make_train_step`` on ``make_mesh(n, tp)`` from the whole weights over
    ``batches``: the losses, step 1's gradients put back together, each rank's
    digest of its replicated parameters after the last step and its shard's
    parameter names and shapes.  With ``ckpt``, the state after step 2 is
    saved there and a fresh state restored from it runs the remaining
    batches (``resumed``)."""
    cfg = get_preset("tiny").with_overrides(**cfg_kw)
    init_fn, step_fn, place = make_train_step(cfg, "cpu", mesh=make_mesh(n, tp, device="cpu"))
    state = init_fn(seed=0)
    load_whole(state, whole)
    losses, grads = [], None
    for i, b in enumerate(batches):
        state, loss = step_fn(state, place(b))
        losses.append(loss.item())
        if i == 0:
            grads = whole_grads(state)
        if ckpt is not None and i == 1:
            save_train_state(ckpt, state)
    out = {"losses": losses, "grads": grads,
           "replicated": gather(digest(p for nm, p in state.net.named_parameters()
                                       if replicated(nm))),
           "shapes": gather({nm: tuple(p.shape) for nm, p in state.net.named_parameters()}),
           "moment_shapes": gather({nm: tuple(state.optimizer.state[p]["exp_avg"].shape)
                                    for nm, p in state.net.named_parameters()}),
           "foreign": gather(foreign_modules())}
    if ckpt is not None:
        fresh = restore_train_state(ckpt, init_fn(seed=1))
        out["resumed_step"] = fresh.step
        out["resumed"] = [step_fn(fresh, place(b))[1].item() for b in batches[2:]]
    return out


def tp_checks(runs: dict) -> dict:
    """One spawn's worth of ``tests/test_torch_train_tp.py``: :func:`tp_run`
    for each named argument tuple."""
    return {name: tp_run(*args) for name, args in runs.items()}


# ---------------------------------------------------------------------------
# sp
# ---------------------------------------------------------------------------

def ring_grads(cases: dict) -> dict:
    """Each case's ``(q, k, v, dO)`` ``[B, S, H, D]`` split on S over the
    ring: the ring's output and dq, dk, dv by autograd (the flash backward's
    plain versions a hop), put back together."""
    r, n = dist.get_rank(), dist.get_world_size()
    group = dist.group.WORLD
    out = {}
    for name, (q, k, v, do) in cases.items():
        s = q.shape[1] // n
        q, k, v, do = (torch.from_numpy(np.ascontiguousarray(t[:, r * s:(r + 1) * s]))
                       for t in (q, k, v, do))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = ring_attention(q, k, v, group)
        o.backward(do)
        out[name] = [np.concatenate(gather(t.detach().numpy()), axis=1)
                     for t in (o, q.grad, k.grad, v.grad)]
    return out


def sp_run(cfg_kw: dict, whole: dict, window: dict, steps: int) -> dict:
    """``make_sp_train_step`` over a ``("sp",)`` mesh of every rank from the
    whole weights, ``steps`` steps on one window: the losses, step 1's
    gradients and each rank's digest of its parameters after the last step."""
    cfg = get_preset("tiny").with_overrides(**cfg_kw)
    init_fn, step_fn, place = make_sp_train_step(cfg, axis_mesh("sp"), axis="sp")
    state = init_fn(seed=0)
    load_whole(state, whole)
    losses, grads = run_steps(step_fn, place, state, [window] * steps)
    return {"losses": losses, "grads": grads, "params": gather(digest(state.net.parameters()))}


def sp_checks(whole: dict, window: dict, ring_cases: dict) -> dict:
    """One spawn's worth of ``tests/test_torch_train_sp.py``: the ring's
    gradients, the sp step (two steps) and one step with ``remat``."""
    out = {"ring": ring_grads(ring_cases), "sp": sp_run({}, whole, window, 2)}
    host = comm.host_bytes
    out["remat"] = sp_run({"remat": True}, whole, window, 1)
    out["foreign"] = gather(foreign_modules())
    out["host_bytes"] = gather(host)
    return out


# ---------------------------------------------------------------------------
# pp
# ---------------------------------------------------------------------------

def pp_run(whole: dict, batches: list) -> dict:
    """``make_pp_train_step`` over a ``("pp",)`` mesh of every rank from the
    whole weights: the losses, step 1's gradients, each rank's parameter
    names, and each rank's digest of the replicated rest and DPT head."""
    cfg = get_preset("tiny")
    n = dist.get_world_size()
    init_fn, step_fn, place = make_pp_train_step(cfg, axis_mesh("pp"), n)
    state = init_fn(seed=0)
    load_whole(state, whole)
    losses, grads = run_steps(step_fn, place, state, batches)
    names = [state.layout.whole_name(nm) for nm, _ in state.net.named_parameters()]
    return {"losses": losses, "grads": grads, "names": gather(names),
            "moments": gather(sorted(state.layout.whole_name(nm) for nm, p
                                     in state.net.named_parameters()
                                     if p in state.optimizer.state)),
            "replicated": gather(digest(p for nm, p in state.net.named_parameters()
                                        if not nm.startswith("blocks."))),
            "foreign": gather(foreign_modules())}
