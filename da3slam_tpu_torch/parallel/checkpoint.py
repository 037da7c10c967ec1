"""Training checkpoint save / restore (counterpart of
``da3slam_tpu/parallel/checkpoint.py``, with ``torch.save`` in place of orbax).

A checkpoint is one file: the network's state dict, the optimizer's state
dict and the step.  It is written to a temporary file beside the target and
moved over it with ``os.replace``, so an interrupted save leaves the previous
checkpoint whole.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from da3slam_tpu_torch.parallel.train import TrainState


def save_train_state(path: str | Path, state: TrainState) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save({"model": state.net.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)


def restore_train_state(path: str | Path, template: TrainState) -> TrainState:
    """Restore into ``template`` in place (build it with the same config and
    device via ``make_train_step(...)[0]()``) and return it."""
    device = next(template.net.parameters()).device
    ckpt = torch.load(Path(path), map_location=device, weights_only=True)
    template.net.load_state_dict(ckpt["model"], strict=True)
    template.optimizer.load_state_dict(ckpt["optimizer"])
    template.step = int(ckpt["step"])
    return template
