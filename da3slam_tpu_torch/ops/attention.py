"""Multi-head attention dispatch (counterpart of ``da3slam_tpu/ops/attention.py``).

Every encoder attention call runs ``flash_attention(stable=False)``
(``ops/flash_attention.py``): the max-free bound forward, differentiable
through the flash backward.  On a CUDA tensor the hand-written kernels run
at every sequence length (the TPU's sequence-length gates existed for VMEM
and lane padding, which the card does not have); on a CPU tensor their plain
torch versions.  Nothing else is a fallback: the kernels' wrappers raise on
a CUDA input they do not take (a head width other than 64, another dtype).
"""

from __future__ import annotations

import torch

from da3slam_tpu_torch.ops.flash_attention import flash_attention
from da3slam_tpu_torch.utils.profiling import span


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention on ``[B, S, H, Dh]``; returns ``[B, S, H, Dh]``."""
    B, S, H, D = q.shape
    with span("model.attention", B=B, S=S, H=H, D=D):
        return flash_attention(q, k, v, stable=False)
