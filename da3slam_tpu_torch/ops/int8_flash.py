"""The int8 flash-attention probe forward (counterpart of the JAX package's
``tools/int8_flash_probe.py:int8_flash``): wrapper, plain version, launch
counter.

An instrument for the work on the production forwards
(``ops/flash_attention.py``), not part of a model's path: softmax attention
with both products in integers.  q is quantized per row, k per block of
``block_k`` keys, v per channel (all symmetric, round to nearest even, 127
levels); p = exp2(s − m) is quantized with a fixed 127 against a running max
that steps once a block; the sums are int32 over a block and join an f32
carry once a block.  The quantization (``quantize_qkv``), the layout of V
the kernel reads (``value_layout``) and the final de-scale are plain tensor
code, as the first and last are plain ``jnp`` in the JAX tool; the body
between them is the kernel (``csrc/int8_flash_fwd.cu``, behind
``int8_attention``).

``block_k`` is part of the function, not a schedule: it groups k's scales and
it is the step of the running max, so every p of a block is rounded against
the max over that whole block.  As in the JAX tool the block in effect is
``min(block_k, ⌈S/128⌉·128)``, the keys are padded with zero rows to a whole
number of blocks, and a padded key's score, exactly 0, joins its block's
max (in a ragged last block m ≥ 0) while its weight in both sums is 0.
``block_q`` of the JAX signature only scheduled the TPU and is not taken.

``int8_flash`` and ``int8_attention`` dispatch on where their inputs live:
CUDA tensors launch the hand-written kernel or raise; CPU tensors run the
plain version beside it.  The launches are counted in ``int8_flash.launches``.
"""

from __future__ import annotations

import torch

from da3slam_tpu_torch.ops.flash_attention import HEAD_DIM, LOG2E, launch_kernel

QMAX = 127.0
NEG_INF = -1e30
TILE_K = 64  # the kernel's key tile: block_k is a multiple of it
# V^T's key order inside each group of 16: position 4c + i holds key
# 2c + (i & 1) + 8·(i >> 1), the key that the s32 score accumulator gives
# thread c = lane % 4 where the s8 A fragment of P·V takes inner index 4c + i
KEY_GROUP = 16
# int32 sums over a block: 127·127·block_k must stay under 2^31
MAX_BLOCK_K = 131072


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def effective_block_k(S: int, block_k: int) -> int:
    """The block the math runs at: ``block_k``, or the sequence rounded up to
    128 where that is shorter (the JAX tool's ``bk``)."""
    if block_k <= 0 or block_k % TILE_K or block_k > MAX_BLOCK_K:
        raise ValueError(f"block_k must be a multiple of {TILE_K} in (0, {MAX_BLOCK_K}], "
                         f"got {block_k}")
    return min(block_k, _round_up(S, 128))


def quantize_qkv(q, k, v, block_k: int):
    """The prologue on ``[B, S, H, D]``: ``(q8 [BH, S, D], k8, v8 [BH, Sk, D]
    int8, sq [BH, S], sk [BH, Sk/bk], va [D] f32, bk)`` with
    ``Sk = ⌈S/bk⌉·bk``; the padded k8 and v8 rows are zeros.

    ``sq`` carries the softmax scale in base 2: ``max|q_row|/127 ·
    log2(e)/√D``.  v's scale is one per channel over every batch, head and key.
    """
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected equal [B, S, H, D] shapes, got "
                         f"{[tuple(t.shape) for t in (q, k, v)]}")
    B, S, H, D = q.shape
    bk = effective_block_k(S, block_k)
    Sk = _round_up(S, bk)

    def fold(x):
        return x.float().transpose(1, 2).reshape(B * H, S, D)

    qf, kf, vf = fold(q), fold(k), fold(v)
    pad = (0, 0, 0, Sk - S)
    kf, vf = torch.nn.functional.pad(kf, pad), torch.nn.functional.pad(vf, pad)

    qa = qf.abs().amax(-1, keepdim=True)
    q8 = torch.round(qf / qa.clamp_min(1e-30) * QMAX).clamp(-QMAX, QMAX)
    sq = (qa[..., 0] / QMAX) * (LOG2E / D ** 0.5)

    kb = kf.abs().amax(-1).view(B * H, Sk // bk, bk).amax(-1).clamp_min(1e-30)  # [BH, nb]
    k8 = torch.round(kf / kb.repeat_interleave(bk, dim=-1)[..., None] * QMAX).clamp(-QMAX, QMAX)
    sk = kb / QMAX

    va = vf.abs().amax((0, 1)).clamp_min(1e-30)  # [D]
    v8 = torch.round(vf / va * QMAX).clamp(-QMAX, QMAX)
    return (q8.to(torch.int8).contiguous(), k8.to(torch.int8).contiguous(),
            v8.to(torch.int8).contiguous(), sq.contiguous(), sk.contiguous(), va, bk)


def _descale(out, va, shape) -> torch.Tensor:
    """The epilogue: the kernel's bf16 ``[BH, S, D]`` times v's channel scales
    in f32, unfolded to ``[B, S, H, D]`` and rounded to bf16 again."""
    B, S, H, D = shape
    o = out.float() * va
    return o.view(B, H, S, D).transpose(1, 2).to(torch.bfloat16)


def int8_attention_reference(q8, k8, v8, sq, sk, S: int, bk: int, drop=None) -> torch.Tensor:
    """Plain version of the kernel's body: ``O [BH, S, D]`` bf16.

    The integer products are taken in f64, where they are exact (a block's
    sums reach 127·127·bk, past f32's 2^24), and converted to f32 once a
    block, as the kernel converts its int32 accumulators.  ``drop = (lo, hi)``
    leaves keys ``[lo, hi)`` out of both sums, as a kernel that skipped them
    in its second pass would (the checks of the error bound use it)."""
    BH, Sk, D = k8.shape
    nb = Sk // bk
    idx = torch.arange(Sk, device=q8.device)
    in_l = idx < S  # padded keys stay out of the denominator
    kept = torch.ones_like(in_l) if drop is None else (idx < drop[0]) | (idx >= drop[1])
    out = torch.empty(BH, S, D, dtype=torch.bfloat16, device=q8.device)
    for bh in range(BH):
        qd = q8[bh].double()
        m = torch.full((S,), NEG_INF, dtype=torch.float32, device=q8.device)
        acc = torch.zeros(S, D, dtype=torch.float32, device=q8.device)
        l = torch.zeros(S, dtype=torch.float32, device=q8.device)
        for b in range(nb):
            blk = slice(b * bk, (b + 1) * bk)
            s = (qd @ k8[bh, blk].double().T).float() * (sq[bh, :, None] * sk[bh, b])
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p8 = (torch.exp2(s - m_new[:, None]) * QMAX + 0.5).trunc().double() * kept[blk]
            acc = acc * alpha[:, None] + (p8 @ v8[bh, blk].double()).float()
            l = l * alpha + ((p8 * in_l[blk]).sum(-1) * QMAX).float()
            m = m_new
        out[bh] = (acc / l.clamp_min(1e-30)[:, None]).to(torch.bfloat16)
    return out


def int8_flash_reference(q, k, v, block_k: int = 3584, drop=None) -> torch.Tensor:
    """Plain-torch int8 forward on ``[B, S, H, D]`` (bf16 or f32 in, bf16 out)."""
    q8, k8, v8, sq, sk, va, bk = quantize_qkv(q, k, v, block_k)
    out = int8_attention_reference(q8, k8, v8, sq, sk, q.shape[1], bk, drop)
    return _descale(out, va, q.shape)


def value_layout(v8: torch.Tensor) -> torch.Tensor:
    """v8 ``[BH, Sk, D]`` as the kernel reads it: ``vt [BH, D, Sk]``, keys
    contiguous (8-bit ``wgmma`` takes its shared-memory operands K-major
    only), key 16g + 8h + 2c + e at position 16g + 4c + 2h + e."""
    BH, Sk, D = v8.shape
    return v8.view(BH, Sk // KEY_GROUP, 2, 4, 2, D).permute(0, 5, 1, 3, 2, 4).reshape(BH, D, Sk)


def values_from_layout(vt: torch.Tensor) -> torch.Tensor:
    """``value_layout`` undone: ``vt [BH, D, Sk]`` back to ``v8 [BH, Sk, D]``."""
    BH, D, Sk = vt.shape
    return vt.reshape(BH, D, Sk // KEY_GROUP, 4, 2, 2).permute(0, 2, 4, 3, 5, 1).reshape(BH, Sk, D)


def int8_attention(q8, k8, vt, sq, sk, S: int, bk: int) -> torch.Tensor:
    """The kernel's body on quantized inputs (``quantize_qkv``'s, with V in
    ``value_layout``): ``O [BH, S, D]`` bf16.  CUDA tensors launch the kernel,
    CPU tensors run ``int8_attention_reference``."""
    ts = (q8, k8, vt, sq, sk)
    if all(t.device.type == "cpu" for t in ts):
        return int8_attention_reference(q8, k8, values_from_layout(vt), sq, sk, S, bk)
    if any(t.device.type != "cuda" or t.device != q8.device for t in ts):
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}: one CUDA device "
                         "(or all on the CPU) expected")
    BH, Sk, D = k8.shape
    if (q8.shape != (BH, S, D) or vt.shape != (BH, D, Sk) or D != HEAD_DIM
            or sq.shape != (BH, S) or sk.shape != (BH, Sk // bk)):
        raise ValueError(f"shapes {[tuple(t.shape) for t in ts]} do not fit S = {S}, "
                         f"bk = {bk}, head_dim {HEAD_DIM}")
    if any(t.dtype != torch.int8 for t in ts[:3]) or any(t.dtype != torch.float32 for t in ts[3:]):
        raise ValueError(f"int8 q8, k8, vt and f32 scales expected, got {[t.dtype for t in ts]}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in ts):
        raise ValueError("int8_attention inputs must be contiguous and 16-byte aligned")
    if BH > 65535 or bk % TILE_K or bk > MAX_BLOCK_K or Sk % bk or Sk < S:
        raise ValueError(f"unsupported shape: BH {BH}, S {S}, Sk {Sk}, bk {bk}")
    out = torch.empty(BH, S, D, dtype=torch.bfloat16, device=q8.device)
    launch_kernel("int8_flash_fwd", q8, q8.data_ptr(), k8.data_ptr(), vt.data_ptr(),
                  sq.data_ptr(), sk.data_ptr(), out.data_ptr(), BH, S, Sk, bk)
    int8_flash.launches += 1
    return out


def int8_flash(q, k, v, block_k: int = 3584) -> torch.Tensor:
    """Int8 flash forward on ``[B, S, H, D]`` (bf16 or f32 in, bf16 out)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return int8_flash_reference(q, k, v, block_k)
    if any(t.device.type != "cuda" or t.device != q.device for t in (q, k, v)):
        raise ValueError(f"tensors on {[str(t.device) for t in (q, k, v)]}: one CUDA device "
                         "(or all on the CPU) expected")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the kernel is compiled for head_dim {HEAD_DIM}, got {q.shape[-1]}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share bf16 or f32, got {[t.dtype for t in (q, k, v)]}")
    q8, k8, v8, sq, sk, va, bk = quantize_qkv(q, k, v, block_k)
    out = int8_attention(q8, k8, value_layout(v8), sq, sk, q.shape[1], bk)
    return _descale(out, va, q.shape)


int8_flash.launches = 0
