"""A configuration file → the port's model with the benchmark's weights, the
same weights for the reference, and the operations of one chunk.

Each configuration names its ``kind``; the module ``kinds/<kind>.py`` of the
benchmark folder builds that kind's network and supplies:

- ``build(config, seed, device) -> Built``: the port's model on ``device``,
  its weights drawn from one generator seeded with ``seed``, and what the
  reference needs;
- ``reference_forward(built, raw, process_res, act) -> dict``: the plain
  reference over one chunk of uint8 views (``depth``, ``conf``,
  ``extrinsics``, ``intrinsics``, ``frame_desc``, and ``metric_scale`` where
  the kind has one), activations stored in ``act``;
- ``chunk_flops(config, views, hw, process_res) -> float``: the reference's
  matmul and convolution operations for one chunk (``FlopCounterMode`` on
  the meta device);
- ``CONTROLS``: the controls of ``tools/readings.py`` the kind supports.

The functions here dispatch to it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from slambench.lib.spec import BENCH_DIR, load_module


@dataclasses.dataclass
class Built:
    model: object  # what the solver is given: DepthAnything3, DepthAnything3Nested, ...
    state_dicts: dict[str, dict[str, torch.Tensor]]  # role -> the weights, shared with the port
    ref_cfgs: dict[str, dict]  # role -> the reference's sizes
    act: torch.dtype  # the dtype the port stores activations in on this device
    kind: object = None  # the module kinds/<kind>.py that built it


def kind(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``kinds/<name>.py`` of ``bench_dir``."""
    path = bench_dir / "kinds" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"configuration kind {name!r}: no file {path}")
    return load_module(path)


def _part(module, name: str):
    if not hasattr(module, name):
        raise AttributeError(f"{module.__file__} defines no {name}")
    return getattr(module, name)


def build(config: dict, seed: int, device: torch.device, bench_dir: Path = BENCH_DIR) -> Built:
    """The configuration's model on ``device`` with weights drawn from ``seed``."""
    module = kind(config["kind"], bench_dir)
    return dataclasses.replace(_part(module, "build")(config, seed, device), kind=module)


def reference_forward(built: Built, raw: torch.Tensor, process_res: int, act: torch.dtype) -> dict:
    """The plain reference over one chunk of uint8 views, activations stored
    in ``act``."""
    return _part(built.kind, "reference_forward")(built, raw, process_res, act)


def chunk_flops(config: dict, views: int, hw: tuple[int, int], process_res: int,
                bench_dir: Path = BENCH_DIR) -> float:
    """Operations of one chunk of ``views`` views as the plain reference
    computes them."""
    return _part(kind(config["kind"], bench_dir), "chunk_flops")(config, views, hw, process_res)


def controls(config: dict, bench_dir: Path = BENCH_DIR) -> tuple[str, ...]:
    """The controls of ``tools/readings.py`` that the configuration's kind supports."""
    return tuple(_part(kind(config["kind"], bench_dir), "CONTROLS"))
