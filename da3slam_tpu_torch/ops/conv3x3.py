"""3×3 convolution with fused bias and ReLU for the DPT head's narrow-channel
output stages (counterpart of ``da3slam_tpu/ops/conv3x3.py``).

``conv3x3_fused(kernel, bias, x, relu=False)`` is a SAME-padded stride-1 3×3
convolution of NHWC ``x`` with an HWIO ``[3, 3, C, COUT]`` kernel cast to
``x.dtype``, accumulated in f32, plus an f32 bias, optionally through a ReLU,
returned in ``x.dtype``.  A CPU tensor runs ``conv3x3_reference``, the same
sum written as nine shifted matrix products.  A CUDA tensor launches one of
two hand-written kernels (``csrc/conv3x3.cu``) or raises, by a rule on dtype
and shape alone (``uses_wgmma``): bf16 with ``C % 8 == 0`` (the input comes
by TMA, whose strides must be multiples of 16 bytes) and at most 1024 output
channels runs the implicit GEMM on ``wgmma``, its weights cast to bf16 into
the kernel's B-operand layout (``pack_weights``) once for a kernel tensor
(``packed_weights``); f32, and bf16 with other channel counts, run the direct
kernel on the FMA pipes.  ``conv3x3_fused.launches`` counts every launch,
``conv3x3_fused.direct_launches`` those of the direct kernel.

As in the JAX package the function is not wired into ``models/dpt.py``, whose
convolutions stay with ``F.conv2d``; ``tools/probe_conv3x3.py`` drives it at
the head's shapes.  Unlike the TPU kernel it takes any height: the ragged
edge is masked in the kernels.
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from da3slam_tpu_torch.core.transforms import highest_precision
from da3slam_tpu_torch.ops.flash_attention import DTYPE_CODES, launch_kernel

# A pixel-tile edge of every kernel: the wgmma kernel's tiles are 16 x 32
# (strips of 32 channels) and 16 x 16 (strips of 128), the direct kernel's
# 16 x 32.  chip_smoke.py drops the halo there.
TILE_H, TILE_W = 16, 32
CHUNK = 64  # input channels a staged box of the wgmma kernel (kChunk)
SWIZZLE = 8  # 16-byte chunks a 128-byte row, permuted within 8-row groups
MAX_COUT = 1024  # output channels (strips rounded up) the wgmma kernel's bias stage holds


def strip_width(cout: int) -> int:
    """Output channels a CTA of the wgmma kernel computes (its wgmma N)."""
    return 32 if cout <= 64 else 128


def uses_wgmma(x: torch.Tensor, cout: int) -> bool:
    """Whether a CUDA ``x`` convolved to ``cout`` channels runs the wgmma
    kernel (else the direct kernel): bf16 with a channel count TMA can
    stride over (C % 8 == 0) and at most ``MAX_COUT`` output channels."""
    n = strip_width(cout)
    return x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0 and -(-cout // n) * n <= MAX_COUT


def pack_weights(kernel: torch.Tensor, n_tile: int) -> torch.Tensor:
    """The HWIO f32 kernel as the wgmma kernel's B operand: rounded to bf16,
    zero-padded to whole 64-channel chunks and ``n_tile``-channel strips, laid
    out ``[strip][chunk][tap][n_tile][64]`` (one tap's slice is one bulk copy)
    with each 128-byte row's 16-byte chunk j stored at j ^ (row % 8), the
    128-byte swizzle the kernel's descriptors read."""
    _, _, C, COUT = kernel.shape
    nc, ns = -(-C // CHUNK), -(-COUT // n_tile)
    w = torch.zeros(9, nc * CHUNK, ns * n_tile, dtype=torch.bfloat16, device=kernel.device)
    w[:, :C, :COUT] = kernel.reshape(9, C, COUT).to(torch.bfloat16)
    w = w.view(9, nc, CHUNK, ns, n_tile).permute(3, 1, 0, 4, 2)  # [strip, chunk, tap, n, c]
    w = w.reshape(ns, nc, 9, n_tile, SWIZZLE, CHUNK // SWIZZLE)
    rows = torch.arange(n_tile, device=kernel.device)[:, None]
    src = torch.arange(SWIZZLE, device=kernel.device)[None, :] ^ (rows % SWIZZLE)
    return w[:, :, :, rows, src].contiguous()


# kernel tensor -> ((its version, n_tile), its packed weights), while it lives
_PACKED = WeakIdKeyDictionary()


def packed_weights(kernel: torch.Tensor, n_tile: int) -> torch.Tensor:
    """``pack_weights(kernel, n_tile)``, made once for a kernel tensor and kept
    while that tensor lives and its version counter (bumped by every in-place
    update) stands: a layer's weights are packed once, not on every call."""
    key = (kernel._version, n_tile)
    hit = _PACKED.get(kernel)
    if hit is None or hit[0] != key:
        hit = _PACKED[kernel] = (key, pack_weights(kernel, n_tile))
    return hit[1]


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
    b = bias.float().contiguous()
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3x3_fused: x must be contiguous NHWC and 16-byte aligned")
    N, H, W, C = x.shape
    out = torch.empty(N, H, W, COUT, dtype=x.dtype, device=x.device)
    if uses_wgmma(x, COUT):
        n_tile = strip_width(COUT)
        w = packed_weights(kernel, n_tile)
        launch_kernel("conv3x3_wgmma_fwd", x, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                      out.data_ptr(), N, H, W, C, COUT, n_tile, int(relu))
    else:
        w = kernel.float().contiguous()
        launch_kernel("conv3x3_fwd", x, x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                      N, H, W, C, COUT, DTYPE_CODES[x.dtype], int(relu))
        conv3x3_fused.direct_launches += 1
    conv3x3_fused.launches += 1
    return out


conv3x3_fused.launches = 0
conv3x3_fused.direct_launches = 0
