"""Kernel probes: the counterparts of the JAX package's ``tools/`` scripts that
drive a hand-written kernel (``probe_conv3x3``, ``flash_nomax_probe``,
``flash_bound_bisect``, ``flash_lab``, ``int8_flash_probe``).  Each is run as
``python -m da3slam_tpu_torch.tools.<name> [args]``, on ``cuda`` unless
``--device cpu`` is given, and prints one line per case: the kernel's time
over repeated launches, its rate, and its max abs error against the plain
version.  ``main(argv)`` also returns the cases as a list of dicts.
``flash_fwd_stages``, ``flash_bwd_stages``, ``conv3x3_stages`` and
``int8_flash_stages`` have no JAX counterpart: they build a kernel's source as
it stands and in changed copies and time the builds in turns (CUDA only)."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``--device``: a CUDA device must exist; the CPU only when asked for."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return device


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()
