"""Flash attention: the CUDA kernels, their plain versions, and the
differentiable entry point (counterpart of ``da3slam_tpu/ops/flash_attention.py``).

Softmax runs in base 2, with log2(e)/√D folded into q (``q'``, rounded back
to the input dtype), and the forwards write lse = log2 Σ_j exp2(s_ij) [B·H, S]
for the backward:

- ``flash_attention_bound``: the max-free forward (``stable=False``, what
  the DA3 encoder runs).  The softmax shift is the per-row bound
  m_i = |q'_i|·max_j|k_j| ≥ every logit (Cauchy–Schwarz), so the forward is a
  plain accumulation: no running max, no rescale.
- ``flash_attention_stable``: the online-softmax forward (``stable=True``,
  the public default): running max, rescale by exp2(m_prev − m_new).
- Both forwards are two kernels each (``csrc/flash_attn_fwd.cu``), picked by
  dtype alone, all on the tensor cores (``wgmma`` for Q'·Kᵀ and P·V, K/V
  through a TMA ring).  bf16: 128-key tiles, q' and p bf16 operands.  f32
  (training and the f32 parity runs): every product is error-compensated
  TF32 (3xTF32: x = hi + lo, hi·hi + hi·lo + lo·hi, ~21 bits; TF32 flags do
  not govern it); a pre-pass writes K split and V split and transposed into
  a workspace, a CTA owns 128 query rows and streams 32 keys a stage.
- ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv``: the
  FlashAttention-2 backward, p recomputed from lse.  lse is the same quantity
  under either forward, so one backward serves both.  Two kernels each too
  (``csrc/flash_attn_bwd.cu``), by dtype alone, both on the tensor cores.
  bf16: a CTA owns 128 q rows or keys, the other side's 64- or 32-row tiles
  come through a TMA ring, the bf16-rounded p and dz are the A fragments of
  the gradient products.  f32: 3xTF32 on ``wgmma`` as in the forward; a
  pre-pass writes split and transposed copies of the operands into a
  workspace, a CTA owns 64 rows and streams 32 a stage.

Each wrapper dispatches on where its inputs live: a CUDA tensor launches the
hand-written kernel (``csrc/*.cu``, built with nvcc on first use and bound
through ctypes) or raises; a CPU tensor runs the plain torch version beside
it, the same formula at the same rounding points.  Each wrapper counts its
kernel's launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
HEAD_DIM = 64  # the kernels' compiled head width (every DA3 tier)
# the bf16 backward kernels' ring tiles: 64 keys a stage for dq, 32 q rows for
# dk/dv, whose (lse, Δ) pairs lie in rows padded to multiples of 64 (kPairTile)
BWD_TILE = 64
BWD_TILE_DKV = 32
# the f32 (3xTF32) backward kernels: 64 own rows a CTA and 32 rows of the
# other side a stage, both kernels
BWD_F32_ROWS = 64
BWD_F32_TILE = 32
# the f32 (3xTF32) forwards: 128 query rows a CTA, 32 keys a stage
FWD_F32_ROWS = 128
FWD_F32_TILE = 32
# every f32 workspace's split copies pad S to a multiple of this (kTf32Pad)
TF32_PAD = 64
# keys per online-softmax update of the stable forward: the bf16 kernel's key
# tile (kTileK), where p is rounded against the running max.  The f32 kernel
# steps by FWD_F32_TILE keys, which only reorders f32 sums: p is not rounded
# there.
STABLE_BLOCK_K = 128

_CSRC = Path(__file__).parent / "csrc"
_HEADERS = ("flash_common.cuh", "flash_wgmma.cuh", "flash_tf32.cuh", "flash_fwd_tile.cuh")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "da3slam_tpu_torch"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# source -> {C entry point: argtypes}
_SOURCES = {
    "flash_attn_fwd.cu": {
        "flash_attn_bound_fwd": [_P] * 7 + [_I] * 5 + [_F, _P],
        "flash_attn_stable_fwd": [_P] * 6 + [_I] * 5 + [_F, _P],
    },
    "flash_attn_bwd.cu": {
        "flash_attn_bwd_dq": [_P] * 8 + [_I] * 5 + [_F, _F, _P],
        "flash_attn_bwd_dkv": [_P] * 10 + [_I] * 5 + [_F, _F, _P],
    },
    # the probe forwards (ops/flash_probes.py) and the 3x3 conv (ops/conv3x3.py)
    "flash_probe_fwd.cu": {
        "flash_probe_nomax": [_P] * 4 + [_I] * 3 + [_P],
        "flash_probe_bisect": [_P] * 6 + [_I] * 5 + [_P],
        "flash_probe_lab": [_P] * 4 + [_I] * 6 + [_F, _P],
    },
    "conv3x3.cu": {
        "conv3x3_fwd": [_P] * 4 + [_I] * 7 + [_P],
        "conv3x3_wgmma_fwd": [_P] * 4 + [_I] * 7 + [_P],
    },
    # the int8 probe forward (ops/int8_flash.py)
    "int8_flash_fwd.cu": {
        "int8_flash_fwd": [_P] * 6 + [_I] * 4 + [_P],
    },
}


def _scale(D: int) -> float:
    return LOG2E / (D ** 0.5)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions accumulate in f32, or in f64 for f64 inputs (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _fold(q: torch.Tensor) -> torch.Tensor:
    """q' = round_to_dtype(q·log2(e)/√D), in the accumulation dtype."""
    acc = _acc_dtype(q.dtype)
    return (q.to(acc) * _scale(q.shape[-1])).to(q.dtype).to(acc)


# ---------------------------------------------------------------------------
# plain versions: [S, S] materialised one (batch, head) at a time
# ---------------------------------------------------------------------------

def flash_attention_bound_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch bound forward on ``[B, S, H, D]``.

    Returns ``(O [B, S, H, D] in q's dtype, lse [B*H, S] f32, base 2)``.
    Rounding points follow the TPU kernel: q' is rounded to the input dtype,
    m comes from the rounded q', p is rounded to V's dtype before both the
    PV product and the denominator.
    """
    B, S, H, D = q.shape
    acc = _acc_dtype(q.dtype)
    qs = _fold(q)
    kf = k.to(acc)
    vf = v.to(acc)
    kmax = torch.linalg.vector_norm(kf, dim=-1).amax(dim=1)  # [B, H]
    o = torch.empty(B, S, H, D, dtype=acc, device=q.device)
    lse = torch.empty(B, H, S, dtype=acc, device=q.device)
    for b in range(B):
        for h in range(H):
            qh = qs[b, :, h]
            m = torch.linalg.vector_norm(qh, dim=-1) * kmax[b, h]  # [S]
            p = torch.exp2(qh @ kf[b, :, h].T - m[:, None]).to(v.dtype).to(acc)
            denom = p.sum(-1).clamp_min(1e-30)
            o[b, :, h] = (p @ vf[b, :, h]) / denom[:, None]
            lse[b, h] = m + torch.log2(denom)
    return o.to(q.dtype), lse.reshape(B * H, S)


def flash_attention_stable_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch stable forward on ``[B, S, H, D]``: ``(O, lse [B*H, S])``.
    k and v may hold another number of keys than q rows (a check drops a key
    tile).

    The online recurrence over blocks of ``STABLE_BLOCK_K`` keys, as the bf16
    CUDA kernel runs it: p is rounded to V's dtype against the running max m_b
    after block b, and each block's terms are carried to the final max by
    exp2(m_b − m_final), the product of the kernel's rescales.  The JAX
    kernel's blocks are block_k keys (128 by default, as here); the math is
    the same at any split up to where p is rounded.
    """
    B, S, H, D = q.shape
    Sk = k.shape[1]
    acc = _acc_dtype(q.dtype)
    qs = _fold(q)
    kf = k.to(acc)
    vf = v.to(acc)
    nb = -(-Sk // STABLE_BLOCK_K)
    pad = nb * STABLE_BLOCK_K - Sk
    o = torch.empty(B, S, H, D, dtype=acc, device=q.device)
    lse = torch.empty(B, H, S, dtype=acc, device=q.device)
    for b in range(B):
        for h in range(H):
            # padded keys get s = -inf, so p = 0
            s = torch.nn.functional.pad(qs[b, :, h] @ kf[b, :, h].T, (0, pad), value=-torch.inf)
            s = s.view(S, nb, STABLE_BLOCK_K)
            m_run = torch.cummax(s.amax(-1), dim=1).values.clamp_min(-1e30)  # [S, nb]
            m = m_run[:, -1]
            p = torch.exp2(s - m_run[..., None]).to(v.dtype).to(acc)
            p = (p * torch.exp2(m_run - m[:, None])[..., None]).view(S, -1)[:, :Sk]
            denom = p.sum(-1).clamp_min(1e-30)
            o[b, :, h] = (p @ vf[b, :, h]) / denom[:, None]
            lse[b, h] = m + torch.log2(denom)
    return o.to(q.dtype), lse.reshape(B * H, S)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ_i = Σ_d dO·O per row, ``[B*H, S]`` f32 (the TPU computes it outside
    its kernels too)."""
    B, S, H, _ = o.shape
    acc = _acc_dtype(o.dtype)
    return (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2).reshape(B * H, S).contiguous()


def _bwd_terms(qs, kf, dof, vf, lse_row, delta_row):
    """p = exp2(q'·kᵀ − lse) and dz = p·(dO·vᵀ − Δ) for one (batch, head)."""
    p = torch.exp2(qs @ kf.T - lse_row[:, None])
    return p, p * (dof @ vf.T - delta_row[:, None])


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta) -> torch.Tensor:
    """Plain dq: ``(1/√D)·Σ_j round(dz_ij)·k_j``, dz rounded to k's dtype.

    q/dO ``[B, Sq, H, D]``, k/v ``[B, Sk, H, D]`` (Sk may differ: a test
    drops key tiles), lse/Δ ``[B*H, Sq]``.
    """
    B, Sq, H, D = q.shape
    acc = _acc_dtype(q.dtype)
    qs, kf, vf, dof = _fold(q), k.to(acc), v.to(acc), do.to(acc)
    lse, delta = lse.reshape(B, H, Sq), delta.reshape(B, H, Sq)
    dq = torch.empty(B, Sq, H, D, dtype=acc, device=q.device)
    for b in range(B):
        for h in range(H):
            _, dz = _bwd_terms(qs[b, :, h], kf[b, :, h], dof[b, :, h], vf[b, :, h],
                               lse[b, h], delta[b, h])
            dq[b, :, h] = (dz.to(k.dtype).to(acc) @ kf[b, :, h]) / (D ** 0.5)
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain dk/dv: ``dv_j = Σ_i round(p_ij)·dO_i`` (p rounded to dO's dtype),
    ``dk_j = ln2·Σ_i round(dz_ij)·q'_i`` (dz rounded to q's dtype).

    Shapes as :func:`flash_attention_bwd_dq_reference` (Sq may differ from Sk).
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    acc = _acc_dtype(q.dtype)
    qs, kf, vf, dof = _fold(q), k.to(acc), v.to(acc), do.to(acc)
    lse, delta = lse.reshape(B, H, Sq), delta.reshape(B, H, Sq)
    dk = torch.empty(B, Sk, H, D, dtype=acc, device=q.device)
    dv = torch.empty(B, Sk, H, D, dtype=acc, device=q.device)
    for b in range(B):
        for h in range(H):
            p, dz = _bwd_terms(qs[b, :, h], kf[b, :, h], dof[b, :, h], vf[b, :, h],
                               lse[b, h], delta[b, h])
            dv[b, :, h] = p.to(do.dtype).to(acc).T @ dof[b, :, h]
            dk[b, :, h] = LN2 * (dz.to(q.dtype).to(acc).T @ qs[b, :, h])
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, o, lse, do):
    """Plain backward of either forward: ``(dq, dk, dv)``, dO rounded to q's dtype."""
    do = do.to(q.dtype)
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta)
    return (dq, *flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta))


# ---------------------------------------------------------------------------
# build and launch
# ---------------------------------------------------------------------------

class _Kernel:
    """The nvcc-built shared libraries, compiled once per process on first use."""

    fns: dict[str, ctypes._CFuncPtr] = {}
    libs: list[ctypes.CDLL] = []
    paths: dict[str, Path] = {}
    build_logs: dict[str, str] = {}
    build_seconds: float | None = None


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(exe).exists():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build "
                           "the CUDA kernels")
    return exe


def nvcc_command(source: Path, out: Path, defines: tuple[str, ...] = ()) -> list[str]:
    """The nvcc call that builds one ``csrc`` source into a shared library for
    sm_90a (``-Xptxas -v``: registers, shared memory and spills go to stderr)."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", *(f"-D{d}" for d in defines),
            "-o", str(out), str(source)]


def build_kernel() -> dict[str, ctypes._CFuncPtr]:
    """Compile every ``csrc/*.cu`` for sm_90a and load it; returns the C entry
    points by name.

    One nvcc per source, all started together; each library is keyed by the
    hash of its source and the shared headers under ``build/da3slam_tpu_torch/``,
    so a second call (or process) reuses it.
    """
    if _Kernel.fns:
        return _Kernel.fns
    t0 = time.perf_counter()
    header = b"".join((_CSRC / h).read_bytes() for h in _HEADERS)
    jobs = []
    for src in _SOURCES:
        path = _CSRC / src
        key = hashlib.sha256(path.read_bytes() + header).hexdigest()[:12]
        out = _BUILD_DIR / f"lib{path.stem}_{key}.so"
        proc = tmp = None
        if not out.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(nvcc_command(path, tmp), stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:  # wait for every nvcc before raising
        if proc is None:
            continue
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {src} failed ({proc.returncode}):\n{err}")
            continue
        tmp.replace(out)
        _Kernel.build_logs[src] = err
    if failed:
        raise RuntimeError("\n".join(failed))
    fns = {}
    for src, out, _, _ in jobs:
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SOURCES[src].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _Kernel.libs.append(lib)
        _Kernel.paths[src] = out
    _Kernel.build_seconds = time.perf_counter() - t0
    _Kernel.fns = fns
    return fns


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_cuda_inputs(q: torch.Tensor, *others: torch.Tensor) -> None:
    """q and every other tensor: one CUDA device, one ``[B, S, H, 64]`` shape,
    one dtype of f32/bf16, contiguous and 16-byte aligned."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    ts = (q, *others)
    if any(t.device != q.device for t in ts):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in ts]}")
    if q.ndim != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"expected equal [B, S, H, D] shapes, got {[tuple(t.shape) for t in ts]}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the kernels are compiled for head_dim {HEAD_DIM}, got {q.shape[-1]}")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"tensors must share one dtype of {list(DTYPE_CODES)}, got "
                         f"{[t.dtype for t in ts]}")
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash attention inputs must be contiguous and 16-byte aligned")
    B, S, H, _ = q.shape
    if B * H > 65535 or S == 0:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")


def _check_rows(q: torch.Tensor, *rows: torch.Tensor) -> None:
    """lse / Δ: ``[B*H, S]`` f32, contiguous, on q's device."""
    B, S, H, _ = q.shape
    for t in rows:
        if t.shape != (B * H, S) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"lse/delta must be contiguous f32 [{B * H}, {S}] on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def launch_kernel(name: str, q: torch.Tensor, *args) -> None:
    fn = build_kernel()[name]
    with torch.cuda.device(q.device):
        rc = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _split_copies(q: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` split copies (natural or transposed) of a ``[B, S, H, D]`` f32
    tensor for the 3xTF32 kernels' pre-pass: ``B·H·S_pad·2·D`` floats each,
    S_pad = S rounded up to ``TF32_PAD``."""
    B, S, H, D = q.shape
    s_pad = -(-S // TF32_PAD) * TF32_PAD
    return torch.empty(n * B * H * s_pad * 2 * D, dtype=torch.float32, device=q.device)


def forward_workspace(q: torch.Tensor) -> torch.Tensor | None:
    """The f32 forwards' workspace on q's device: K split and V split and
    transposed (two copies).  None in bf16.  The caller holds it until the
    launch is queued: the allocator reuses it in stream order."""
    return _split_copies(q, 2) if q.dtype == torch.float32 else None


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def flash_attention_bound(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bound-mode forward on ``[B, S, H, D]``: ``(O, lse [B*H, S] f32)``."""
    if _on_cpu(q, k, v):
        return flash_attention_bound_reference(q, k, v)
    _check_cuda_inputs(q, k, v)
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    kmax = torch.empty(B * H, dtype=torch.float32, device=q.device)
    ws = forward_workspace(q)
    launch_kernel("flash_attn_bound_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), kmax.data_ptr(), _ptr(ws), B, S, H, D,
                  DTYPE_CODES[q.dtype], _scale(D))
    flash_attention_bound.launches += 1
    return o, lse


def flash_attention_stable(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax forward on ``[B, S, H, D]``: ``(O, lse [B*H, S] f32)``."""
    if _on_cpu(q, k, v):
        return flash_attention_stable_reference(q, k, v)
    _check_cuda_inputs(q, k, v)
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    ws = forward_workspace(q)
    launch_kernel("flash_attn_stable_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), _ptr(ws), B, S, H, D, DTYPE_CODES[q.dtype],
                  _scale(D))
    flash_attention_stable.launches += 1
    return o, lse


def backward_workspaces(q: torch.Tensor, dkv: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(ws, pairs)`` of a backward kernel on q's device.  bf16: ``ws`` takes
    the folded q' (``[B, S, H, D]``); f32: the pre-pass's split copies, five
    for dq (q', dO, K, V, Kᵀ) and six for dk/dv (K, V, q', dO, q'ᵀ, dOᵀ) of
    ``B·H·S_pad·2·D`` floats each (``_split_copies``).
    ``pairs`` (dk/dv only): the (lse, Δ) pairs in rows padded to whole
    ``BWD_TILE``s.  The caller holds both until the launch is queued: the
    allocator reuses them in stream order."""
    B, S, H, _ = q.shape
    ws = torch.empty_like(q) if q.dtype == torch.bfloat16 else _split_copies(q, 6 if dkv else 5)
    pairs = None
    if dkv:
        pairs = torch.empty(B * H, -(-S // BWD_TILE) * BWD_TILE, 2, dtype=torch.float32,
                            device=q.device)
    return ws, pairs


def flash_attention_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """dq on ``[B, S, H, D]`` from the saved lse and Δ (both ``[B*H, S]`` f32)."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta)
    _check_cuda_inputs(q, k, v, do)
    _check_rows(q, lse, delta)
    B, S, H, D = q.shape
    dq = torch.empty_like(q)
    ws, _ = backward_workspaces(q, dkv=False)
    launch_kernel("flash_attn_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), ws.data_ptr(),
                  B, S, H, D, DTYPE_CODES[q.dtype], _scale(D), 1.0 / D ** 0.5)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) on ``[B, S, H, D]`` from the saved lse and Δ."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta)
    _check_cuda_inputs(q, k, v, do)
    _check_rows(q, lse, delta)
    B, S, H, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ws, pairs = backward_workspaces(q, dkv=True)
    launch_kernel("flash_attn_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  ws.data_ptr(), pairs.data_ptr(), B, S, H, D, DTYPE_CODES[q.dtype], _scale(D),
                  LN2)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bound.launches = 0
flash_attention_stable.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_backward(q, k, v, o, lse, do):
    """Backward of either forward: ``(dq, dk, dv)``, dO rounded to q's dtype."""
    do = do.to(q.dtype).contiguous()
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta))


# ---------------------------------------------------------------------------
# differentiable entry point
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``_flash_attention`` custom VJP.

    ``forward`` runs the bound or the stable forward and saves q, k, v, O and
    lse; the backward recomputes the rounded q' from q exactly as the forward
    folds it.  ``backward`` runs the dq and dk/dv kernels (their plain
    versions on CPU tensors).  Under ``torch.no_grad()`` no graph is kept, so
    the saved tensors are freed with the call and no backward runs.
    """

    @staticmethod
    def forward(ctx, q, k, v, stable: bool):
        o, lse = (flash_attention_stable if stable else flash_attention_bound)(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, g)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, stable: bool = True
) -> torch.Tensor:
    """Softmax(QKᵀ/√D)·V for ``[B, S, H, D]`` inputs (full attention),
    differentiable through the flash backward kernels.

    ``stable=False`` selects the max-free forward, which the model's
    attention dispatch uses (``ops/attention.py``); the default ``stable=True``
    is safe for inputs of any norm.  The JAX signature's ``block_q``,
    ``block_k`` and ``k_splits`` only scheduled the TPU (the math is the same
    at any split) and are not taken.
    """
    return FlashAttention.apply(q, k, v, stable)
