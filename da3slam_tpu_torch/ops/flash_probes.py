"""The flash-forward probe kernels (counterparts of the JAX package's
``tools/flash_nomax_probe.py``, ``tools/flash_bound_bisect.py`` and
``tools/flash_lab.py`` kernels): wrappers, plain versions, launch counters.

They are instruments for the work on the production forwards
(``ops/flash_attention.py``), not part of a user's path; the port's
``tools/`` scripts drive them.  Inputs are already folded over (batch, head):
``q [BH, Sq, 64]``, ``k, v [BH, Sk, 64]``, bf16 on the card.  Keys at index
``seq_k`` and beyond are padding that the arrays still hold.

- ``flash_nomax``: O = Σ_j p_ij v_j / max(Σ_j p_ij, 1e-30) with
  p = round(exp2(q·k − 15)): a constant in place of the softmax shift, no
  scale, no mask, every key of the array counted.
- ``flash_bisect``: the same plus lse = m + log2 Σ p, in five variants
  (``BISECT_VARIANTS``): the shift a constant (A) or a per-row input ``m``
  (B-E); the padding counted (``none``), given p = 0 (``cond``: tested only in
  the tile that holds it; ``always``: tested on every key; the same result),
  or counted and then taken out of the denominator as
  ``(Sk − seq_k)·exp2(−m)`` (``subtract``: exact when the padded k rows are
  zeros).
- ``flash_lab``: the online-softmax forward (running max over blocks of
  ``LAB_BLOCK_K`` keys, padding at −1e30) in three variants: ``old`` scales
  the logits in f32 and sums the denominator from the unrounded p; ``new``
  sums it from the rounded p; ``qs`` also folds the scale into q, rounded to
  q's dtype.  ``nh`` heads are walked by one thread block; it schedules only.

p is rounded to v's dtype before the PV sum in every variant.  Each wrapper
dispatches on where its inputs live: CUDA tensors launch the hand-written
kernel (``csrc/flash_probe_fwd.cu``) or raise; CPU tensors run the plain
version beside it.  Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from da3slam_tpu_torch.ops.flash_attention import HEAD_DIM, LOG2E, launch_kernel

PROBE_M = 15.0  # the tools' literal stand-in for the per-row norm bound
NEG_INF = -1e30
LAB_BLOCK_K = 16  # keys per online-softmax update in the lab kernel (kSub)
# variant -> (m is a per-row input, how the padded keys are treated)
BISECT_VARIANTS = {
    "A": (False, "none"),
    "B": (True, "none"),
    "C": (True, "cond"),
    "D": (True, "always"),
    "E": (True, "subtract"),
}
LAB_VARIANTS = ("old", "new", "qs")


def _check(q, k, v, seq_k: int | None = None) -> int:
    """Shapes every probe shares; returns ``seq_k`` (default: every key)."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"expected q [BH, Sq, D] and k, v [BH, Sk, D], got "
                         f"{[tuple(t.shape) for t in (q, k, v)]}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q, k, v must share a dtype, got {[t.dtype for t in (q, k, v)]}")
    seq_k = k.shape[1] if seq_k is None else int(seq_k)
    if not 0 < seq_k <= k.shape[1]:
        raise ValueError(f"seq_k {seq_k} outside (0, {k.shape[1]}]")
    return seq_k


def _check_cuda(q, k, v, *rows) -> None:
    """What the kernel takes: one CUDA device, bf16, head_dim 64, contiguous
    and 16-byte aligned; ``rows`` are f32 ``[BH, Sq]``."""
    ts = (q, k, v)
    if any(t.device.type != "cuda" or t.device != q.device for t in (*ts, *rows)):
        raise ValueError(f"tensors on {[str(t.device) for t in (*ts, *rows)]}: one CUDA "
                         "device (or all on the CPU) expected")
    if q.dtype != torch.bfloat16 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the probe kernels are compiled for bf16 and head_dim {HEAD_DIM}, "
                         f"got {q.dtype} {tuple(q.shape)}")
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("probe inputs must be contiguous and 16-byte aligned")
    for t in rows:
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"m must be contiguous f32 {tuple(q.shape[:2])}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts if t is not None)


# ---------------------------------------------------------------------------
# plain versions: [Sq, Sk] materialised one head at a time
# ---------------------------------------------------------------------------

def flash_bisect_reference(q, k, v, variant: str = "A", m=None, seq_k: int | None = None):
    """Plain-torch bisect forward: ``(O [BH, Sq, D] in q's dtype, lse [BH, Sq] f32)``."""
    use_m, mask = BISECT_VARIANTS[variant]
    seq_k = _check(q, k, v, seq_k)
    if use_m and m is None:
        raise ValueError(f"variant {variant} takes the per-row shift m [BH, Sq]")
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.empty(BH, Sq, D, dtype=torch.float32, device=q.device)
    lse = torch.empty(BH, Sq, dtype=torch.float32, device=q.device)
    for bh in range(BH):
        m_row = m[bh].float() if use_m else torch.full((Sq,), PROBE_M, device=q.device)
        p = torch.exp2(qf[bh] @ kf[bh].T - m_row[:, None])
        if mask in ("cond", "always"):
            p[:, seq_k:] = 0.0
        p = p.to(v.dtype).float()
        denom = p.sum(-1)
        if mask == "subtract":
            denom = denom - (Sk - seq_k) * torch.exp2(-m_row)
        denom = denom.clamp_min(1e-30)
        o[bh] = (p @ vf[bh]) / denom[:, None]
        lse[bh] = m_row + torch.log2(denom)
    return o.to(q.dtype), lse


def flash_nomax_reference(q, k, v) -> torch.Tensor:
    """Plain-torch constant-shift forward: the bisect's variant A without lse."""
    return flash_bisect_reference(q, k, v, "A")[0]


def flash_lab_reference(q, k, v, variant: str = "new", seq_k: int | None = None,
                        nh: int = 1) -> torch.Tensor:
    """Plain-torch online-softmax forward, the recurrence over blocks of
    ``LAB_BLOCK_K`` keys as the CUDA kernel runs it: p is rounded against the
    running max after its block and carried to the final max by
    exp2(m_b − m_final), the product of the kernel's rescales."""
    if variant not in LAB_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {LAB_VARIANTS}")
    seq_k = _check(q, k, v, seq_k)
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    if nh < 1 or BH % nh:
        raise ValueError(f"nh {nh} must divide BH {BH}")
    scale = LOG2E / D ** 0.5
    qf = (q.float() * scale).to(q.dtype).float() if variant == "qs" else q.float()
    kf, vf = k.float(), v.float()
    nb = -(-Sk // LAB_BLOCK_K)
    o = torch.empty(BH, Sq, D, dtype=torch.float32, device=q.device)
    for bh in range(BH):
        s = qf[bh] @ kf[bh].T
        if variant != "qs":
            s = s * scale
        s[:, seq_k:] = NEG_INF
        s = torch.nn.functional.pad(s, (0, nb * LAB_BLOCK_K - Sk), value=NEG_INF)
        s = s.view(Sq, nb, LAB_BLOCK_K)
        m_run = torch.cummax(s.amax(-1), dim=1).values  # [Sq, nb]
        pf = torch.exp2(s - m_run[..., None])
        carry = torch.exp2(m_run - m_run[:, -1:])[..., None]
        p = pf.to(v.dtype).float()
        denom = ((pf if variant == "old" else p) * carry).sum((-1, -2)).clamp_min(1e-30)
        o[bh] = ((p * carry).view(Sq, -1)[:, :Sk] @ vf[bh]) / denom[:, None]
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def flash_nomax(q, k, v) -> torch.Tensor:
    """Constant-shift forward: ``O [BH, Sq, 64]``."""
    _check(q, k, v)
    if _on_cpu(q, k, v):
        return flash_nomax_reference(q, k, v)
    _check_cuda(q, k, v)
    o = torch.empty_like(q)
    launch_kernel("flash_probe_nomax", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  q.shape[0], q.shape[1], k.shape[1])
    flash_nomax.launches += 1
    return o


def flash_bisect(q, k, v, variant: str = "A", m=None, seq_k: int | None = None):
    """Bisect forward: ``(O [BH, Sq, 64], lse [BH, Sq] f32)``; ``m [BH, Sq]``
    f32 is the per-row shift of variants B-E."""
    if variant not in BISECT_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {sorted(BISECT_VARIANTS)}")
    use_m = BISECT_VARIANTS[variant][0]
    if use_m and m is None:
        raise ValueError(f"variant {variant} takes the per-row shift m [BH, Sq]")
    seq_k = _check(q, k, v, seq_k)
    m = m if use_m else None
    if _on_cpu(q, k, v, m):
        return flash_bisect_reference(q, k, v, variant, m, seq_k)
    _check_cuda(q, k, v, *(() if m is None else (m,)))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    launch_kernel("flash_probe_bisect", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if m is None else m.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  q.shape[0], q.shape[1], k.shape[1], seq_k, sorted(BISECT_VARIANTS).index(variant))
    flash_bisect.launches += 1
    return o, lse


def flash_lab(q, k, v, variant: str = "new", seq_k: int | None = None,
              nh: int = 1) -> torch.Tensor:
    """Online-softmax lab forward: ``O [BH, Sq, 64]``."""
    if variant not in LAB_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {LAB_VARIANTS}")
    seq_k = _check(q, k, v, seq_k)
    if nh < 1 or q.shape[0] % nh:
        raise ValueError(f"nh {nh} must divide BH {q.shape[0]}")
    if _on_cpu(q, k, v):
        return flash_lab_reference(q, k, v, variant, seq_k, nh)
    _check_cuda(q, k, v)
    o = torch.empty_like(q)
    launch_kernel("flash_probe_lab", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  q.shape[0], q.shape[1], k.shape[1], seq_k, LAB_VARIANTS.index(variant), nh,
                  LOG2E / HEAD_DIM ** 0.5)
    flash_lab.launches += 1
    return o


flash_nomax.launches = 0
flash_bisect.launches = 0
flash_lab.launches = 0
