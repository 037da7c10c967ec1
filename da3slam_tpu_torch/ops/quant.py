"""W8A8 int8 quantization for the encoder's projection GEMMs (counterpart of
``da3slam_tpu/ops/quant.py``).

The QKV and both MLP GEMMs of a block run int8 × int8 → int32 on
pre-quantized inputs.  Weights are quantized once, per output channel
(``quantize_weight``); activations per token (row), symmetric round to
nearest in both cases, and always inside an elementwise pass the encoder runs
anyway: the block's layernorm emits int8 and a per-token scale directly
(``layer_norm_quant``), and the MLP's nonlinearity quantizes its output the
same way (``quantize_rows``).  The attention out-projection stays float: its
input is the attention output, with no elementwise pass before it to carry
the quantize.  Attention itself stays float too.

The integer product is ``torch._int_mm`` (the JAX package leaves it to a
``dot_general`` outside any kernel).  What it refuses (on CUDA: fewer than 17
rows, or an inner or output width that is no multiple of 8) raises; nothing
falls back to a float product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

QMAX = 127.0


def _quantize(xf: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-30) / QMAX
    return torch.round(xf / scale).clamp(-QMAX, QMAX).to(torch.int8), scale


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (per-token) int8 quantization.

    ``x: [..., D]`` → ``(int8 values [..., D], f32 scales [..., 1])`` with
    ``x ≈ values * scales``.
    """
    return _quantize(x.float(), -1)


def quantize_weight(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a ``[D_in, D_out]``
    projection matrix (done once at load time, not in the forward).

    ``w8`` is ``[D_in, D_out]`` stored column-major (the transpose of a
    contiguous ``[D_out, D_in]``), the layout cuBLASLt's int8 product takes
    for its second operand; ``wscale`` is ``[D_out]``."""
    q, scale = _quantize(w.float(), 0)
    return {"w8": q.t().contiguous().t(), "wscale": scale[0]}


def int8_gemm(x8: torch.Tensor, xscale: torch.Tensor, wq: dict[str, torch.Tensor],
              bias: torch.Tensor | None, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``(x8 · w8) * xscale * wscale + bias``: int8 × int8 → int32, one f32
    rescale over the output.  ``x8: [..., D_in]`` is flattened to rows for the
    product."""
    lead = x8.shape[:-1]
    acc = torch._int_mm(x8.reshape(-1, x8.shape[-1]), wq["w8"])
    out = acc.float().view(*lead, -1) * (xscale * wq["wscale"])
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def layer_norm_quant(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                     eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Layernorm (f32 mean and variance, as ``models/vit.py:layer_norm``) with
    the per-token int8 quantize as its epilogue.  Returns ``(int8 [..., D],
    f32 scale [..., 1])``."""
    out = F.layer_norm(x.float(), weight.shape, weight.float(), bias.float(), eps)
    return _quantize(out, -1)
