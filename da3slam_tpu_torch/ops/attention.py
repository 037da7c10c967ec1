"""Multi-head attention dispatch (counterpart of ``da3slam_tpu/ops/attention.py``).

Every encoder attention call runs the max-free bound forward
(``ops/flash_attention.py``): on a CUDA tensor the hand-written kernel at
every sequence length (the TPU's sequence-length gates existed for VMEM and
lane padding, which the card does not have), on a CPU tensor its plain torch
version.  Nothing else is a fallback: the kernel's wrapper raises on a CUDA
input it does not take (a head width other than 64, another dtype).
"""

from __future__ import annotations

import torch

from da3slam_tpu_torch.ops.flash_attention import flash_attention_bound


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention on ``[B, S, H, Dh]``; returns ``[B, S, H, Dh]``."""
    return flash_attention_bound(q, k, v)[0]
