"""Seeded random weights, made on the device in a few large calls.

Every tensor of a network's state dict is a view into one flat float32
buffer: one ``normal_`` from a generator on the device, then one multiply by
the per-tensor scale and one add of the per-tensor constant.  The scale and
the constant of each tensor come from its configuration kind's rule
(``kinds/<kind>.py``), which knows the network's parameter names.
"""

from __future__ import annotations

from typing import Callable

import torch

# (name, shape) -> (std, constant): value = std · N(0, 1) + constant
Rule = Callable[[str, tuple[int, ...]], tuple[float, float]]


def make_state_dict(shapes: dict[str, tuple[int, ...]], rule: Rule,
                    generator: torch.Generator, device: torch.device) -> dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` for every name in ``shapes`` (a state dict's
    names and shapes, in its order), drawn from ``generator`` on ``device``
    and scaled by ``rule``."""
    names = list(shapes)
    sizes = [int(torch.Size(shapes[n]).numel()) for n in names]
    rules = [rule(n, tuple(shapes[n])) for n in names]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(generator=generator)
    counts = torch.tensor(sizes, device=device)
    std = torch.tensor([r[0] for r in rules], dtype=torch.float32, device=device)
    const = torch.tensor([r[1] for r in rules], dtype=torch.float32, device=device)
    flat.mul_(torch.repeat_interleave(std, counts, output_size=flat.numel()))
    flat.add_(torch.repeat_interleave(const, counts, output_size=flat.numel()))
    return {n: part.view(shapes[n]) for n, part in zip(names, flat.split(sizes))}
