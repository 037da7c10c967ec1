"""LayerNorm of bf16 rows in one pass on the card, and VGGT's QK-norm with
its 2D RoPE in the same pass (``csrc/layer_norm.cu``).

The model's bf16 inference normalises in f32 and rounds once to bf16
(``models/vit.py:layer_norm``, ``models/vggt.py:qk_norm_rope``: their plain
versions, the composition ``x.float()`` → ``F.layer_norm`` → ``.to(bf16)``).
On a CUDA bf16 tensor that needs no gradient those two functions call
``layer_norm`` / ``layer_norm_rope`` here instead: one kernel reads the bf16
rows and the f32 weight and bias, takes the mean and variance in f32, applies
the affine (and RoPE) in f32 and writes bf16, the same rounding points in one
pass.  A view whose last dimension is contiguous is read in place: the q and k
thirds of a qkv projection, a DPT tap with its prefix tokens cut.

``takes`` decides by what it can see of the input: bf16 on a CUDA device, and
no gradient wanted of it or of the parameters (the kernel has no backward); a
shape the kernel does not hold then raises.  ``layer_norm.launches`` counts
the kernel's launches (both epilogues), ``layer_norm.eager`` the CUDA bf16
norms left to the composition (under autograd); f32 and CPU norms count in
neither.  ``count_norms`` records both over a block in a span's attributes.
"""

from __future__ import annotations

import contextlib

import torch

from da3slam_tpu_torch.ops.flash_attention import launch_kernel

VEC = 8  # bf16 values a 16-byte load
MAX_WIDTH = 2048  # 32 lanes × 8 vectors of 8 a row
HEAD = 64  # the RoPE epilogue's head width


def takes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether LayerNorm over x's last dimension (or QK-norm and RoPE of x's
    heads) runs the kernel: x bf16 on a CUDA device, and no gradient wanted of
    it or of the parameters.  A CUDA bf16 x left to the composition counts in
    ``layer_norm.eager``."""
    if x.dtype != torch.bfloat16 or x.device.type != "cuda":
        return False
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias))):
        return True
    layer_norm.eager += 1
    return False


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and t.stride(-1) == 1 \
        and all(s % VEC == 0 for s in t.stride()[:-1])


def _rows(x: torch.Tensor, merge: bool) -> tuple[torch.Tensor, list[int], list[int]]:
    """x (copied where the kernel cannot read it in place) and the sizes and
    strides of its row indices, three of them (leading size-1 indices of
    stride 0 added).  ``merge`` joins neighbouring indices that step evenly and
    drops indices of size 1; without it the indices are x's own."""
    if not _aligned(x):
        x = x.clone(memory_format=torch.contiguous_format)
    dims = list(zip(x.shape[:-1], x.stride()[:-1]))
    if merge:
        kept: list[tuple[int, int]] = []
        for size, stride in dims:
            if size == 1:
                continue
            if kept and kept[-1][1] == size * stride:
                kept[-1] = (kept[-1][0] * size, stride)
            else:
                kept.append((size, stride))
        dims = kept
        if len(dims) > 3:
            x = x.contiguous()
            dims = [(x.numel() // x.shape[-1], x.shape[-1])]
    dims = [(1, 0)] * (3 - len(dims)) + dims
    return x, [d[0] for d in dims], [d[1] for d in dims]


def _param(t: torch.Tensor, width: int, device: torch.device) -> torch.Tensor:
    if t.shape != (width,) or t.device != device:
        raise ValueError(f"weight and bias must be [{width}] on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    t = t.float()
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone()


def _check(x: torch.Tensor) -> None:
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"layer_norm: bf16 on a CUDA device only, got {x.dtype} on {x.device}")


def layer_norm(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last dimension of a CUDA bf16 ``x`` (its width a
    multiple of 8 up to ``MAX_WIDTH``) with f32 ``weight`` and ``bias``: f32
    statistics and affine, bf16 out, contiguous in x's shape."""
    W = x.shape[-1]
    if W % VEC or not 0 < W <= MAX_WIDTH:
        raise ValueError(f"layer_norm: width {W} is not a multiple of {VEC} up to {MAX_WIDTH}")
    _check(x)
    w, b = _param(weight, W, x.device), _param(bias, W, x.device)
    x, (_, d1, d2), (s0, s1, s2) = _rows(x, merge=True)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    launch_kernel("layer_norm_bf16", x, x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(),
                  out.numel() // W, d1, d2, s0, s1, s2, W, eps)
    layer_norm.launches += 1
    return out


def layer_norm_rope(weight: torch.Tensor, bias: torch.Tensor, t: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor, eps: float) -> torch.Tensor:
    """QK-norm then 2D RoPE of a CUDA bf16 ``t [B, P, H, 64]`` (a view of a
    qkv projection is read in place), position p = t's second index, tables
    ``[P, 2, 16]`` f32 (``models/vggt.py:rope_tables``): bf16 out, contiguous
    ``[B, P, H, 64]``."""
    if t.ndim != 4 or t.shape[-1] != HEAD or cos.shape != (t.shape[1], 2, HEAD // 4) \
            or sin.shape != cos.shape:
        raise ValueError(f"layer_norm_rope: t [B, P, H, {HEAD}] and tables [P, 2, {HEAD // 4}], "
                         f"got {tuple(t.shape)}, {tuple(cos.shape)}, {tuple(sin.shape)}")
    _check(t)
    B, P, H, D = t.shape
    w, b = _param(weight, D, t.device), _param(bias, D, t.device)
    c, s = (_param(u.reshape(-1), P * D // 2, t.device) for u in (cos, sin))
    t, (_, d1, d2), (s0, s1, s2) = _rows(t, merge=False)
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    if out.numel() == 0:
        return out
    launch_kernel("layer_norm_rope_bf16", t, t.data_ptr(), out.data_ptr(), w.data_ptr(),
                  b.data_ptr(), c.data_ptr(), s.data_ptr(), B * P * H, d1, d2, s0, s1, s2, eps)
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
layer_norm.eager = 0


@contextlib.contextmanager
def count_norms(attrs: dict):
    """Record in ``attrs`` the kernel's launches (``norms_kernel``) and the
    CUDA bf16 norms left to the composition (``norms_eager``) in the block."""
    kernel, eager = layer_norm.launches, layer_norm.eager
    try:
        yield
    finally:
        attrs["norms_kernel"] = layer_norm.launches - kernel
        attrs["norms_eager"] = layer_norm.eager - eager
