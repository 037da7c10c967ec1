"""Device→host transfers shared by the solver and the viewer."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def fetch_packed(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Device tensors → numpy arrays in their own dtypes, in ONE device→host
    transfer: they are packed into one f64 buffer on the device, and f64
    holds every f32 (and every index below 2^53) exactly."""
    packed = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors]).cpu()
    return [part.reshape(t.shape).to(t.dtype).numpy()
            for part, t in zip(packed.split([t.numel() for t in tensors]), tensors)]
