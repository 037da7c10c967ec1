#!/usr/bin/env python
"""What the LayerNorm tests share (``tests/test_torch_layer_norm.py`` on the
CPU, ``tests/test_torch_layer_norm_cuda.py`` on the card).

``layer_norm_jax.npz`` holds the JAX package's ``layer_norm``
(``da3slam_tpu/models/vit.py``: f32 mean and variance, f32 affine, one cast
back) on bf16 rows at DA3's widths.  The card, which has no JAX, holds the
port's one-pass LayerNorm kernel to these outputs; a CPU test checks that they
are still what the JAX package computes.  ``inputs(width)`` makes the rows,
weight and bias from a seed with numpy alone, so both sides read the same bf16
values; ``jax_outputs(width)`` runs the JAX package on them.  Regenerate with

    python tests/fixtures/layer_norm_ref.py

``ulps(got, want)`` is the measure every LayerNorm comparison is held to.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

WIDTHS = (384, 1024, 1536)  # SMALL, LARGE and the metric ViT-L, the giant
ROWS = 37  # odd: the last block of rows is partly empty
EPS = 1e-6
PATH = Path(__file__).with_name("layer_norm_jax.npz")
# the smallest magnitude, as a share of the largest |want|, whose ulp ulps() takes
FLOOR = 2.0 ** -12


def bf16_values(a: np.ndarray) -> np.ndarray:
    """f32 ``a`` rounded to bf16 (to nearest, ties to even), held as f32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).view(np.float32)


def from_bits(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) as f32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def inputs(width: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x [ROWS, width] bf16 values as f32, weight f32, bias f32)."""
    rng = np.random.default_rng(width)
    x = bf16_values(2 * rng.standard_normal((ROWS, width)) + 0.7)
    w = (1 + 0.5 * rng.standard_normal(width)).astype(np.float32)
    b = (0.3 * rng.standard_normal(width)).astype(np.float32)
    return x, w, b


def jax_outputs(width: int) -> np.ndarray:
    """The JAX package's ``layer_norm`` of ``inputs(width)`` in bf16, as
    uint16 bit patterns."""
    import jax.numpy as jnp

    from da3slam_tpu.models.vit import layer_norm

    x, w, b = inputs(width)
    out = layer_norm({"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                     jnp.asarray(x).astype(jnp.bfloat16), EPS)
    return (np.asarray(out.astype(jnp.float32)).view(np.uint32) >> 16).astype(np.uint16)


def load() -> dict[int, np.ndarray]:
    """The stored outputs by width, as f32."""
    with np.load(PATH) as f:
        return {w: from_bits(f[f"w{w}"]) for w in WIDTHS}


def ulps(got, want, floor: float = FLOOR) -> float:
    """Max |got − want| (torch tensors) in bf16 units in the last place of
    the larger of the two, taken no smaller than at ``floor`` of the largest
    |want|.  Nearer zero, where x − mean (or a RoPE pair) cancels, the f32
    sums' own rounding, a few 2^-24 of terms as large as the largest value,
    sets the last bits of any two f32 computations that sum in another order
    (``test_torch_layer_norm.py``'s lane model reads them); ``floor=0`` is
    the raw measure."""
    import torch

    a, b = got.detach().float(), want.detach().float()
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()), floor * b.abs().max())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
    return float(((a - b).abs() / ulp).max())


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(PATH, **{f"w{w}": jax_outputs(w) for w in WIDTHS})
    print(f"wrote {PATH}")
