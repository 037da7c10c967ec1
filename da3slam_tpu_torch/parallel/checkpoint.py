"""Training checkpoint save / restore (counterpart of
``da3slam_tpu/parallel/checkpoint.py``, with ``torch.save`` in place of orbax).

A checkpoint is one file of whole tensors: the network's parameters by name
(``model``), the AdamW moments and step count of each parameter by the same
name (``optimizer``) and the train step (``step``).  Orbax saves the JAX
package's global arrays and restores them into a template's shardings; here
every rank of a multi-device state calls :func:`save_train_state`, the
parameters and moments are gathered whole over tp and pp
(``TrainState.layout``), and rank 0 writes them.  It writes to a temporary
file beside the target and moves it over the target with ``os.replace``, so
an interrupted save leaves the previous checkpoint whole.  Every rank then
restores its own part from the whole tensors (:func:`restore_train_state`),
so a checkpoint resumes on another mesh too (a tp 2 one at tp 1).
"""

from __future__ import annotations

import os
from pathlib import Path

import torch
import torch.distributed as dist

from da3slam_tpu_torch.parallel.train import TrainState


def _whole(state: TrainState) -> dict:
    """The checkpoint's content (a collective over the state's groups).  The
    AdamW step count is one number for every parameter."""
    layout = state.layout
    named = [(layout.whole_name(n), p) for n, p in state.net.named_parameters()]
    opt = state.optimizer.state
    model = layout.gather({n: p.detach() for n, p in named})
    moments = {key: layout.gather({n: opt[p][key] for n, p in named if p in opt})
               for key in ("exp_avg", "exp_avg_sq")}
    step = next((s["step"].cpu() for s in opt.values()), None)
    optimizer = {n: {"step": step, **{key: moments[key][n].cpu() for key in moments}}
                 for n in moments["exp_avg"]}
    return {"model": {n: t.cpu() for n, t in model.items()},
            "optimizer": {"state": optimizer}, "step": state.step}


def save_train_state(path: str | Path, state: TrainState) -> None:
    """Write ``state`` to ``path``; with a process group, call it on every
    rank (rank 0 writes, the others wait until the file is in place)."""
    ckpt = _whole(state)
    if not dist.is_initialized() or dist.get_rank() == 0:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
    if dist.is_initialized():
        dist.barrier()


def restore_train_state(path: str | Path, template: TrainState) -> TrainState:
    """Restore into ``template`` in place (build it with the same config via
    ``make_*train_step(...)[0]()``, on any mesh) and return it.  The
    optimizer keeps the template's hyperparameters (the learning rate of the
    run that resumes, as the JAX package's optax state holds none)."""
    ckpt = torch.load(Path(path), map_location="cpu", weights_only=True)
    layout = template.layout
    saved = ckpt["optimizer"]["state"]
    opt_sd = template.optimizer.state_dict()
    opt_sd["state"] = {}
    with torch.no_grad():
        for i, (name, p) in enumerate(template.net.named_parameters()):
            whole = layout.whole_name(name)
            if whole not in ckpt["model"]:
                raise KeyError(f"{path}: no parameter {whole}")
            p.copy_(layout.local(whole, ckpt["model"][whole]))
            if whole in saved:
                m = saved[whole]
                opt_sd["state"][i] = {"step": m["step"].clone(),  # AdamW counts in place
                                      **{k: layout.local(whole, m[k]).to(p.device)
                                         for k in ("exp_avg", "exp_avg_sq")}}
    template.optimizer.load_state_dict(opt_sd)
    template.step = int(ckpt["step"])
    return template
