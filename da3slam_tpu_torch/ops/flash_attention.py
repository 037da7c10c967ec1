"""Max-free ("bound") flash-attention forward: the CUDA kernel and its plain version.

Counterpart of ``da3slam_tpu/ops/flash_attention.py`` with ``stable=False``,
the only attention the DA3 encoder runs.  The softmax shift is the per-row
bound m_i = |q'_i|·max_j|k_j| ≥ every logit (Cauchy–Schwarz), so the forward
is a plain accumulation: no running max, no rescale.  Softmax runs in base 2,
with log2(e)/√D folded into q (``q'``, rounded back to the input dtype).

``flash_attention_bound`` dispatches on where its inputs live: a CUDA tensor
launches the hand-written kernel (``csrc/flash_attn_bound_fwd.cu``, built
with nvcc on first use and bound through ctypes) or raises; a CPU tensor runs
:func:`flash_attention_bound_reference`, the same formula in plain torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import time
from pathlib import Path

import torch

LOG2E = 1.4426950408889634
HEAD_DIM = 64  # the kernel's compiled head width (every DA3 tier)

_SRC = Path(__file__).parent / "csrc" / "flash_attn_bound_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "da3slam_tpu_torch"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scale(D: int) -> float:
    return LOG2E / (D ** 0.5)


def flash_attention_bound_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch bound forward on ``[B, S, H, D]``; materialises ``[S, S]``
    scores one (batch, head) at a time.

    Returns ``(O [B, S, H, D] in q's dtype, lse [B*H, S] f32, base 2)``.
    Rounding points follow the TPU kernel: q' is rounded to the input dtype,
    m comes from the rounded q', p is rounded to V's dtype before both the
    PV product and the denominator.
    """
    B, S, H, D = q.shape
    qs = (q.float() * _scale(D)).to(q.dtype).float()
    kf = k.float()
    vf = v.float()
    kmax = torch.linalg.vector_norm(kf, dim=-1).amax(dim=1)  # [B, H]
    o = torch.empty(B, S, H, D, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(H):
            qh = qs[b, :, h]
            m = torch.linalg.vector_norm(qh, dim=-1) * kmax[b, h]  # [S]
            p = torch.exp2(qh @ kf[b, :, h].T - m[:, None]).to(v.dtype).float()
            denom = p.sum(-1).clamp_min(1e-30)
            o[b, :, h] = (p @ vf[b, :, h]) / denom[:, None]
            lse[b, h] = m + torch.log2(denom)
    return o.to(q.dtype), lse.reshape(B * H, S)


class _Kernel:
    """The nvcc-built shared library, compiled once per process on first use."""

    lib = None
    path: Path | None = None
    build_seconds: float | None = None
    build_log = ""


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(exe).exists():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build "
                           "the flash-attention kernel")
    return exe


def build_kernel() -> ctypes.CDLL:
    """Compile ``csrc/flash_attn_bound_fwd.cu`` for sm_90a (once; the library
    is keyed by the source's hash under ``build/da3slam_tpu_torch/``) and
    load it."""
    if _Kernel.lib is not None:
        return _Kernel.lib
    src = _SRC.read_bytes()
    out = _BUILD_DIR / f"libflash_attn_bound_fwd_{hashlib.sha256(src).hexdigest()[:12]}.so"
    t0 = time.perf_counter()
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(_SRC),
        ]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        tmp.replace(out)
        _Kernel.build_log = res.stderr
    lib = ctypes.CDLL(str(out))
    fn = lib.flash_attn_bound_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _Kernel.lib, _Kernel.path = lib, out
    _Kernel.build_seconds = time.perf_counter() - t0
    return lib


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected equal [B, S, H, D] shapes, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the kernel is compiled for head_dim {HEAD_DIM}, got {q.shape[-1]}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype of {list(_DTYPE_CODES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    B, S, H, _ = q.shape
    if B * H > 65535 or S == 0:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")


def flash_attention_bound(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bound-mode attention on ``[B, S, H, D]``: ``(O, lse [B*H, S] f32)``.

    CUDA inputs launch the kernel (``flash_attention_bound.launches`` counts
    the launches); CPU inputs run the plain reference; anything else raises.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_bound_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bound: unsupported device {q.device}")
    _check_cuda_inputs(q, k, v)
    lib = build_kernel()
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    kmax = torch.empty(B * H, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_bound_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            kmax.data_ptr(), B, S, H, D, _DTYPE_CODES[q.dtype], _scale(D), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attn_bound_fwd launch failed: cudaError {rc}")
    flash_attention_bound.launches += 1
    return o, lse


flash_attention_bound.launches = 0
