"""3×3 convolution with fused bias and ReLU for the DPT head's narrow-channel
output stages (counterpart of ``da3slam_tpu/ops/conv3x3.py``).

``conv3x3_fused(kernel, bias, x, relu=False)`` is a SAME-padded stride-1 3×3
convolution of NHWC ``x`` with an HWIO ``[3, 3, C, COUT]`` kernel cast to
``x.dtype``, accumulated in f32, plus an f32 bias, optionally through a ReLU,
returned in ``x.dtype``.  A CUDA tensor launches the hand-written kernel
(``csrc/conv3x3.cu``) or raises; a CPU tensor runs ``conv3x3_reference``, the
same sum written as nine shifted matrix products.  ``conv3x3_fused.launches``
counts the kernel's launches.

As in the JAX package the function is not wired into ``models/dpt.py``, whose
convolutions stay with ``F.conv2d``; ``tools/probe_conv3x3.py`` drives it at
the head's shapes.  Unlike the TPU kernel it takes any height: the ragged
edge is masked in the kernel.
"""

from __future__ import annotations

import torch

from da3slam_tpu_torch.core.transforms import highest_precision
from da3slam_tpu_torch.ops.flash_attention import DTYPE_CODES, launch_kernel

TILE_H, TILE_W = 16, 32  # output pixels per thread block in the kernel (kTileH, kTileW)


def conv3x3_eligible(x: torch.Tensor, kernel: torch.Tensor) -> bool:
    """Whether ``conv3x3_fused`` takes these operands: a 4-D ``x`` of f32 or
    bf16, a 3×3 HWIO kernel whose input channels match ``x``'s, at most
    65535 frames."""
    return (
        x.ndim == 4
        and kernel.ndim == 4
        and tuple(kernel.shape[:2]) == (3, 3)
        and kernel.shape[2] == x.shape[-1]
        and x.dtype in DTYPE_CODES
        and 0 < x.shape[0] <= 65535
        and min(x.shape[1:]) > 0
        and kernel.shape[3] > 0
    )


@highest_precision()
def conv3x3_reference(
    kernel: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, *, relu: bool = False
) -> torch.Tensor:
    """Plain-torch version: nine shifted ``[N·H·W, C] @ [C, COUT]`` products of
    the zero-padded input, summed in f32 (TF32 off), with the kernel rounded
    to ``x.dtype`` first and the result rounded to ``x.dtype`` last."""
    N, H, W, C = x.shape
    k = kernel.to(x.dtype).float()
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    out = bias.float().expand(N, H, W, -1).clone()
    for dh in range(3):
        for dw in range(3):
            out += xp[:, dh:dh + H, dw:dw + W] @ k[dh, dw]
    if relu:
        out = out.clamp_min_(0.0)
    return out.to(x.dtype)


def conv3x3_fused(
    kernel: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, *, relu: bool = False
) -> torch.Tensor:
    """SAME 3×3 stride-1 conv (+ optional fused ReLU) of ``[N, H, W, C]`` with an
    HWIO ``[3, 3, C, COUT]`` kernel.  Accumulates in f32, returns ``x.dtype``."""
    if not conv3x3_eligible(x, kernel):
        raise ValueError(f"conv3x3_fused: unsupported operands x {x.dtype} {tuple(x.shape)}, "
                         f"kernel {tuple(kernel.shape)}")
    COUT = kernel.shape[3]
    if bias.shape != (COUT,):
        raise ValueError(f"bias must be [{COUT}], got {tuple(bias.shape)}")
    if all(t.device.type == "cpu" for t in (kernel, bias, x)):
        return conv3x3_reference(kernel, bias, x, relu=relu)
    if x.device.type != "cuda" or any(t.device != x.device for t in (kernel, bias)):
        raise ValueError(f"conv3x3_fused: tensors on {[str(t.device) for t in (kernel, bias, x)]}")
    w = kernel.float().contiguous()
    b = bias.float().contiguous()
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3x3_fused: x must be contiguous NHWC and 16-byte aligned")
    N, H, W, C = x.shape
    out = torch.empty(N, H, W, COUT, dtype=x.dtype, device=x.device)
    launch_kernel("conv3x3_fwd", x, x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                  N, H, W, C, COUT, DTYPE_CODES[x.dtype], int(relu))
    conv3x3_fused.launches += 1
    return out


conv3x3_fused.launches = 0
