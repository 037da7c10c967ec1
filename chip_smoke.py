"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero before the
final line:

1. env: the card (nvidia-smi name and power limit), torch and CUDA versions
2. build: nvcc build of every kernel (flash attention, the flash probes, the
   3x3 conv), with ptxas's registers, shared memory and spills per kernel
3. kernel vs plain, bound and stable forwards: each kernel against its plain
   torch version, both on the card, at the SMALL tier's shapes and, for the
   bound forward, the LARGE tier's (CUDA-event times, median of a few runs)
4. backward vs plain: the dq and dk/dv kernels against the plain backward at
   the training and SLAM shapes; the plain version with its last key or q
   tile dropped must break each bound
5. model f32 parity: the SMALL forward on a 2-frame 518² chunk, CUDA f32
   (kernel) against the same weights on the CPU (plain attention)
6. train grad parity: one SMALL window's loss gradients, card (kernels)
   against CPU (plain), every parameter
7. train: ``da3slam_tpu_torch.cli.train`` (SMALL, dp, 5 steps of 2 windows
   of 4 views at 504²), counting the kernels' launches, then a
   ``torch.profiler`` split of one step
8. flash_attention: the public entry point a user calls (``stable=True``, the
   default) forward and backward, counting the launches, and holding the
   output and the gradients against the plain stable forward and backward
9. main path: ``da3slam_tpu_torch.cli.main_slam`` over 31 generated frames
   (SMALL, chunk 15, overlap 1: two steady chunks and the re-anchored tail),
   counting the launches
10. conv3x3 vs plain: the 3x3 conv kernel against its plain version and beside
    ``F.conv2d`` at the DPT head's three shapes (bf16) and a ragged f32 shape;
    a dropped halo row or column must break the bound
11. flash probes vs plain: the constant-shift, bisect and online-softmax lab
    kernels against their plain versions at the tools' shapes and a ragged one
12. tools: ``da3slam_tpu_torch.tools``' four ``main``s, counting the launches
13. main_align: ``da3slam_tpu_torch.cli.main_align`` at the LARGE tier
    (``--method irls``, ray poses, chunk 15) over the same 31 frames: a finite
    PLY and diagnostics, 72 bound-forward launches; then a ``torch.profiler``
    split of one LARGE chunk
14. main_slam with ``Align.method: irls``: the main path again from a config
    file, device-resident, with the prefetcher's staging on and off, counting
    the launches and the host's waits for the device

Each driven path (7, 8, 9, 12, 13, 14) sets every launch count to 0 just
before it and reads them just after.  The ``kernels`` line gives each kernel's
launches, error, time, plain version's time, roofline bound (from the shapes
of this run, against the H100 SXM data sheet's peaks) and, where one PyTorch
call computes the same function, that call's time (timed here, used nowhere
in the port).  The last line is ``{"ok": true, "device": {...}}``.
There is no CPU fallback: without CUDA the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# (name, dtype, shape [B, S, H, D]).  Intra and cross are the SMALL tier at
# process_res 504, chunk 15: 15 views of 36*36 + 1 + 4 = 1301 tokens, folded
# into one sequence of 19515 for the cross-view blocks.  train_intra and
# train_cross are what the training path gives the forwards: f32, 4 views at
# 504² (4 x 1301 tokens, folded into 5204).
KERNEL_CASES = [
    ("intra", torch.bfloat16, (15, 1301, 6, 64)),
    ("cross", torch.bfloat16, (1, 19515, 6, 64)),
    ("ragged", torch.bfloat16, (2, 300, 3, 64)),
    ("f32", torch.float32, (2, 1301, 6, 64)),
    ("train_intra", torch.float32, (4, 1301, 6, 64)),
    ("train_cross", torch.float32, (1, 5204, 6, 64)),
]
# what the LARGE main_align path gives the bound forward: 16 heads
LARGE_CASES = [
    ("large_intra", torch.bfloat16, (15, 1301, 16, 64)),
    ("large_cross", torch.bfloat16, (1, 19515, 16, 64)),
]
# the stable forward adds the input where the bound forward underflows: q
# scaled 30x (diffuse logits of norm ~350); there the bound kernel gives zeros
STABLE_CASES = [(n, d, s, 1.0) for n, d, s in KERNEL_CASES] + [
    ("30x", torch.float32, (1, 1301, 6, 64), 30.0),
]
# the backward at the training shapes (4 views at 504²: intra 4 x 1301,
# cross 5204) in f32, the training dtype, a ragged f32 case, and the SLAM
# cross shape in bf16
BWD_CASES = [
    ("train_intra", torch.float32, (4, 1301, 6, 64)),
    ("train_cross", torch.float32, (1, 5204, 6, 64)),
    ("ragged", torch.float32, (2, 300, 3, 64)),
    ("slam_cross", torch.bfloat16, (1, 19515, 6, 64)),
]
# Bounds on max |kernel - plain|, forwards.  Both round p to V's dtype at the
# same place, so in bf16 they differ by the output's final rounding: at most
# one bf16 ulp of the largest |O|.  The bound is 2^-6 * max |O|, which is 2-4
# such ulps; it scales with |O|, which is ~0.04 at the cross shape, where a
# fixed 2e-2 would pass a dropped key tile.  f32 keeps the JAX package's own
# bound for this forward (tests/test_flash_attention.py: 5e-5).  lse sums
# every key's p, so a dropped or repeated key tile moves it by more than
# LSE_TOL: dropping the ragged last tile (59 keys) at the cross shape moves
# both lse and O by about 1e-2.  The stable kernel and its plain version
# both round p against the running max over 16-key blocks, so they too
# differ only in the order of f32 sums.
BF16_REL_TOL = 2.0 ** -6
F32_TOL = 5e-5
LSE_TOL = 1e-3
# At the 30x input the logits s and lse are 100-200 in magnitude (f32 ulp
# 1.5e-5), from 64-term dot products summed in another order: lse differs by
# ~10 ulps, and each p = exp2(s - m) by ~1e-5 relative, so O (|O| up to ~4,
# the best key's v) is held to 1e-4 of max |O| instead of F32_TOL.
LSE_TOL_30X = 2e-4
F32_REL_TOL_30X = 1e-4
# Bounds on max |kernel - plain| of each gradient, relative to its max |g|.
# f32: both take the same f32 products and differ in the order of sums over
# up to S terms (~sqrt(S)·2^-24 of the terms: ~1e-6 of max|g| at S = 5204);
# 1e-4 is ~100x that.  bf16: dz and p are rounded to bf16 at the same points,
# but an f32 difference can tip a value at a rounding boundary, and the
# outputs are rounded to bf16 (one ulp = 2^-8 relative): 2^-6, as for O.  A
# kernel that skipped the ragged last key tile (dq) or q tile (dk/dv) moves
# the gradient by several percent of max|g|: the backward phase checks that
# each bound catches it at each shape.
BWD_F32_REL_TOL = 1e-4
# The 3x3 conv: (label, dtype, N, H, W, C, COUT, relu).  The three DPT-head
# shapes of the probe tool in bf16, and an f32 shape ragged in H, W (the 16 x
# 32 pixel tile), C (chunks of 8) and COUT (strips of 32).  Kernel and plain
# version take the same exact products of T-rounded values and differ in the
# order of up to 9*C f32 sums; bf16 outputs are then rounded (one ulp = 2^-8
# relative), so bf16 is held to 2^-6 * max |out| as the attention output is,
# and f32 to the JAX package's own 1e-4.  A kernel that dropped a tile's halo
# row or column would lose three taps x C terms there (~1 in magnitude):
# the phase checks that each bound catches it.
CONV_CASES = [
    ("head2-small", torch.bfloat16, 16, 504, 504, 64, 32, False),
    ("head2-large", torch.bfloat16, 16, 504, 504, 128, 32, True),
    ("head1-large", torch.bfloat16, 16, 288, 288, 256, 128, False),
    ("ragged_f32", torch.float32, 3, 45, 77, 21, 40, True),
]
CONV_F32_TOL = 1e-4
# The flash probes at the tools' shapes: S = 16 * 1301 = 20816 padded to the
# TPU tool's blocks (21504 queries and keys), the lab at S = 20480 (its padded
# length), BH = 6, bf16; and a ragged small case (Sq, Sk, seq_k).
PROBE_S, PROBE_PAD, LAB_S = 20816, 21504, 20480
PROBE_RAGGED = (300, 333, 290)
# The H100 SXM data sheet's dense peaks, for the roofline bounds
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# f32 card-vs-CPU parity: max |cuda - cpu| / max |cpu| per output / parameter
MODEL_PARITY_TOL = 1e-3
DPT_BIAS = 5.0  # keeps the DPT head's ReLU inputs off 0 (phase_train_grad_parity)
N_FRAMES = 31
EXPECTED_LAUNCHES = 12 * 3  # 12 encoder blocks x 3 chunks
ALIGN_ARGS = ["--model", "large", "--method", "irls", "--chunk_size", "15", "--overlap", "1",
              "--headless"]
ALIGN_EXPECTED_LAUNCHES = 24 * 3  # LARGE: 24 encoder blocks x 3 chunks
TRAIN_STEPS, TRAIN_BATCH, TRAIN_VIEWS, TRAIN_HW = 5, 2, 4, 504
TRAIN_ARGS = ["--preset", "small", "--mode", "dp", "--steps", str(TRAIN_STEPS),
              "--batch", str(TRAIN_BATCH), "--views", str(TRAIN_VIEWS),
              "--hw", str(TRAIN_HW), str(TRAIN_HW), "--log_every", "1"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def fwd_bound(o_ref: torch.Tensor, q_scale: float = 1.0) -> float:
    """Bound on max |O_kernel - O_plain| (see BF16_REL_TOL, F32_TOL and
    F32_REL_TOL_30X)."""
    if o_ref.dtype == torch.bfloat16:
        return BF16_REL_TOL * o_ref.float().abs().max().item()
    if q_scale != 1.0:
        return F32_REL_TOL_30X * o_ref.abs().max().item()
    return F32_TOL


def grad_bound(g_ref: torch.Tensor) -> float:
    """Bound on max |g_kernel - g_plain| (see BWD_F32_REL_TOL / BF16_REL_TOL)."""
    rel = BF16_REL_TOL if g_ref.dtype == torch.bfloat16 else BWD_F32_REL_TOL
    return rel * g_ref.float().abs().max().item()


def conv_bound(out_ref: torch.Tensor) -> float:
    """Bound on max |out_kernel - out_plain| of the 3x3 conv (see CONV_CASES)."""
    if out_ref.dtype == torch.bfloat16:
        return BF16_REL_TOL * out_ref.float().abs().max().item()
    return CONV_F32_TOL


def dropped_halo_errors(kernel, bias, x, out_ref, relu: bool) -> dict:
    """Max |Δ| at the first interior tile edge when the plain conv loses the
    halo there: what a kernel that staged its tile without the neighbouring
    column (or row) would show.  ``out_ref`` is the whole plain output."""
    from da3slam_tpu_torch.ops.conv3x3 import TILE_H, TILE_W, conv3x3_reference

    cut_w = conv3x3_reference(kernel, bias, x[:1, :, TILE_W:TILE_W + 4], relu=relu)
    cut_h = conv3x3_reference(kernel, bias, x[:1, TILE_H:TILE_H + 4], relu=relu)
    return {
        "column": (cut_w[:, :, 0].float() - out_ref[:1, :, TILE_W].float()).abs().max().item(),
        "row": (cut_h[:, 0].float() - out_ref[:1, TILE_H].float()).abs().max().item(),
    }


def roofline(flop: float, nbytes: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: the larger of operations over the
    peak rate of their type and bytes (each input read once, each output
    written once) over the memory rate.  f32 work is held to the 67 TFLOP/s
    f32 rate; the TF32 tensor-core figure stands beside it."""
    t_ops = flop / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    out = {"bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flop": flop, "bytes": nbytes}
    if dtype == torch.float32:
        out["bound_ms_tf32"] = max(flop / PEAK_TF32_FLOPS, t_bytes) * 1e3
    return out


def attention_roofline(shape, dtype, flop_per_score: int, n_tensors: int, n_rows: int) -> dict:
    """Roofline of an attention kernel on ``[B, S, H, D]``: ``flop_per_score``
    · B·H·S²·D operations (4 forward, 6 dq, 8 dk/dv), ``n_tensors`` tensors of
    the shape and ``n_rows`` f32 ``[B·H, S]`` rows in and out."""
    B, S, H, D = shape
    elem = torch.empty((), dtype=dtype).element_size()
    return roofline(flop_per_score * B * H * S * S * D,
                    n_tensors * B * S * H * D * elem + n_rows * B * H * S * 4, dtype)


def sdpa_ms(q, k, v, reps: int = 5, scale=None) -> float:
    """Time of one ``F.scaled_dot_product_attention`` call on ``[B, S, H, D]``
    inputs (viewed as ``[B, H, S, D]``): the library's forward."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, scale=scale), reps)


def sdpa_backward_ms(q, k, v, g, reps: int = 5) -> float:
    """Time of the autograd backward of one ``scaled_dot_product_attention``
    call (dq, dk and dv together): the library's backward."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    gt = g.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True), reps)


def dropped_tile_errors(q, k, v, do, lse, delta, grads) -> list[float]:
    """Max |Δ| of (dq, dk, dv) when the plain backward drops the last (ragged)
    key tile from dq and the last q tile from dk/dv: what a kernel with that
    fault would show.  ``grads`` are the whole plain gradients."""
    from da3slam_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq_reference,
    )

    B, S, H, _ = q.shape
    cut = (S - 1) // 64 * 64
    dq_cut = flash_attention_bwd_dq_reference(q, k[:, :cut], v[:, :cut], do, lse, delta)

    def rows(x):
        return x.reshape(B, H, S)[:, :, :cut].reshape(B * H, cut)

    dk_cut, dv_cut = flash_attention_bwd_dkv_reference(q[:, :cut], k, v, do[:, :cut],
                                                       rows(lse), rows(delta))
    return [(a.float() - b.float()).abs().max().item()
            for a, b in zip(grads, (dq_cut, dk_cut, dv_cut))]


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after one warm-up."""
    from da3slam_tpu_torch.utils.profiling import time_ms

    return time_ms(fn, "cuda", reps)


def counters():
    from da3slam_tpu_torch.ops import conv3x3, flash_probes
    from da3slam_tpu_torch.ops import flash_attention as fa

    return {"flash_attn_bound_fwd": fa.flash_attention_bound,
            "flash_attn_stable_fwd": fa.flash_attention_stable,
            "flash_attn_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attn_bwd_dkv": fa.flash_attention_bwd_dkv,
            "conv3x3": conv3x3.conv3x3_fused,
            "flash_probe_nomax": flash_probes.flash_nomax,
            "flash_probe_bisect": flash_probes.flash_bisect,
            "flash_probe_lab": flash_probes.flash_lab}


def expected_launches(**nonzero: int) -> dict:
    """Every kernel's expected count on a path: 0 unless named."""
    return {name: nonzero.get(name, 0) for name in counters()}


@contextlib.contextmanager
def counted(path_launches: dict, path: str):
    """Set every launch count to 0 just before a driven path, read them just
    after into ``path_launches[path]``."""
    for fn in counters().values():
        fn.launches = 0
    yield
    path_launches[path] = {name: fn.launches for name, fn in counters().items()}


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from da3slam_tpu_torch.ops import flash_attention as fa

    fa.build_kernel()
    ptxas = {src: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                   if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
             for src, log in fa._Kernel.build_logs.items()}
    emit("build", seconds=fa._Kernel.build_seconds,
         libraries=[str(p.relative_to(ROOT)) for p in fa._Kernel.paths.values()], ptxas=ptxas)


def _forward_case(fwd, ref, name, dtype, shape, scale, gen) -> dict:
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    q = (q.float() * scale).to(dtype)
    o, lse = fwd(q, k, v)
    o_ref, lse_ref = ref(q, k, v)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    tol = fwd_bound(o_ref, scale)
    lse_err = (lse - lse_ref).abs().max().item()
    lse_tol = LSE_TOL_30X if scale != 1.0 else LSE_TOL
    finite = bool(torch.isfinite(o).all().item())
    ms = cuda_ms(lambda: fwd(q, k, v), reps=5)
    plain_ms = cuda_ms(lambda: ref(q, k, v), reps=3)
    B, S, H, D = shape
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
           "q_scale": scale, "max_abs_err": err, "tol": tol,
           "plain_max_abs": o_ref.float().abs().max().item(), "lse_max_abs_err": lse_err,
           "lse_tol": lse_tol, "ms": ms, "plain_ms": plain_ms,
           "library_ms": sdpa_ms(q, k, v), "library": "F.scaled_dot_product_attention",
           "kernel_tflops": 4 * B * H * S * S * D / ms / 1e9,
           **attention_roofline(shape, dtype, 4, n_tensors=4, n_rows=1)}
    if scale != 1.0:
        from da3slam_tpu_torch.ops.flash_attention import flash_attention_bound

        row["bound_kernel_all_zero"] = bool((flash_attention_bound(q, k, v)[0] == 0).all().item())
        if not row["bound_kernel_all_zero"]:
            fail(f"the bound kernel did not underflow to zeros at {name}")
    if not finite or not err <= tol:
        fail(f"{fwd.__name__} disagrees with its plain version at {name}: {err} > {tol}")
    if not lse_err <= lse_tol:
        fail(f"{fwd.__name__} lse disagrees with its plain version at {name}: "
             f"{lse_err} > {lse_tol}")
    return row


def phase_forwards() -> dict:
    from da3slam_tpu_torch.ops import flash_attention as fa

    rows = {}
    for kernel, fwd, ref, cases in (
        ("flash_attn_bound_fwd", fa.flash_attention_bound, fa.flash_attention_bound_reference,
         [(n, d, s, 1.0) for n, d, s in KERNEL_CASES + LARGE_CASES]),
        ("flash_attn_stable_fwd", fa.flash_attention_stable, fa.flash_attention_stable_reference,
         STABLE_CASES),
    ):
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows[kernel] = []
        for name, dtype, shape, scale in cases:
            row = _forward_case(fwd, ref, name, dtype, shape, scale, gen)
            emit("kernel_vs_plain", kernel=kernel, **row)
            rows[kernel].append(row)
            torch.cuda.empty_cache()
    return rows


def phase_backward() -> dict:
    from da3slam_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"flash_attn_bwd_dq": [], "flash_attn_bwd_dkv": []}
    for name, dtype, shape in BWD_CASES:
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                      for _ in range(4))
        o, lse = fa.flash_attention_bound(q, k, v)
        delta = fa.attention_delta(o, g)
        dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta)
        refs = (fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta),
                *fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta))
        torch.cuda.synchronize()
        errs, tols = {}, {}
        for gname, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            if not bool(torch.isfinite(a).all().item()):
                fail(f"{gname} kernel output not finite at {name}")
            errs[gname] = (a.float() - r.float()).abs().max().item()
            tols[gname] = grad_bound(r)
        cut_errs = dict(zip(("dq", "dk", "dv"), dropped_tile_errors(q, k, v, g, lse, delta, refs)))
        dq_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta), reps=5)
        dkv_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta), reps=5)
        dq_plain = cuda_ms(lambda: fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta), 3)
        dkv_plain = cuda_ms(lambda: fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta), 3)
        B, S, H, D = shape
        flop = B * H * S * S * D
        library_ms = sdpa_backward_ms(q, k, v, g)
        row = {"case": name, "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
               "library_ms": library_ms,
               "library": "autograd backward of F.scaled_dot_product_attention "
                          "(dq, dk and dv together)",
               "max_abs_err": errs, "tol": tols, "dropped_tile_err": cut_errs,
               "dq_ms": dq_ms, "dkv_ms": dkv_ms, "dq_plain_ms": dq_plain,
               "dkv_plain_ms": dkv_plain,
               "bwd_tflops": 14 * flop / (dq_ms + dkv_ms) / 1e9,
               "dq_tflops": 6 * flop / dq_ms / 1e9, "dkv_tflops": 8 * flop / dkv_ms / 1e9}
        emit("backward_vs_plain", **row)
        for gname in errs:
            if not errs[gname] <= tols[gname]:
                fail(f"{gname} kernel disagrees with the plain backward at {name}: "
                     f"{errs[gname]} > {tols[gname]}")
            if not cut_errs[gname] > tols[gname]:
                fail(f"the {gname} bound at {name} ({tols[gname]}) would pass a dropped "
                     f"tile ({cut_errs[gname]})")
        # dq reads q, k, v, dO, lse, Δ and writes dq; dk/dv writes two tensors
        rows["flash_attn_bwd_dq"].append({
            **row, "max_abs_err": errs["dq"], "ms": dq_ms, "plain_ms": dq_plain,
            **attention_roofline(shape, dtype, 6, n_tensors=5, n_rows=2)})
        rows["flash_attn_bwd_dkv"].append({
            **row, "max_abs_err": max(errs["dk"], errs["dv"]), "ms": dkv_ms,
            "plain_ms": dkv_plain, **attention_roofline(shape, dtype, 8, n_tensors=6, n_rows=2)})
        del q, k, v, g, o, lse, delta, dq, dk, dv, refs
        torch.cuda.empty_cache()
    return rows


def make_frames(n: int, hw: int = 518, seed: int = 0) -> np.ndarray:
    """Smooth textured uint8 frames drifting sideways, made with numpy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    phases = rng.uniform(0, 2 * np.pi, size=(3, 3))
    frames = []
    for i in range(n):
        x = xx + 0.01 * i
        img = np.stack([
            0.5 + 0.25 * np.sin(2 * np.pi * (3 * x + 2 * yy) + phases[c, 0])
            + 0.2 * np.sin(2 * np.pi * (7 * yy - 5 * x) + phases[c, 1])
            for c in range(3)
        ], -1)
        img = img + rng.normal(scale=0.02, size=img.shape)
        frames.append(np.clip(img * 255, 0, 255).astype(np.uint8))
    return np.stack(frames)


def phase_model_parity() -> None:
    from da3slam_tpu_torch.core.transforms import highest_precision
    from da3slam_tpu_torch.models.da3 import DepthAnything3

    frames = make_frames(2)
    cpu = DepthAnything3.from_pretrained("small", seed=0, device="cpu")
    gpu = DepthAnything3(cpu.cfg, copy.deepcopy(cpu.net).to("cuda"), dtype=torch.float32)
    p_cpu = cpu.inference(image=frames)
    with highest_precision():  # no TF32 in cuBLAS or cuDNN
        p_gpu = gpu.inference(image=frames)
        torch.cuda.synchronize()
    errs = {}
    for field in ("depth", "conf", "extrinsics", "intrinsics"):
        a, b = getattr(p_gpu, field), getattr(p_cpu, field)
        if a.shape != b.shape or not np.isfinite(a).all():
            fail(f"model parity: {field} shape {a.shape} vs {b.shape} or non-finite")
        errs[field] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
    emit("model_f32_parity", preset="small", frames=2, input_hw=518,
         processed_hw=list(p_gpu.depth.shape[1:]), max_rel_err=errs, tol=MODEL_PARITY_TOL)
    if not all(e <= MODEL_PARITY_TOL for e in errs.values()):
        fail(f"model f32 parity beyond {MODEL_PARITY_TOL}: {errs}")


def phase_train_grad_parity() -> None:
    """One SMALL window (2 views at 280², f32): every parameter's gradient on
    the card (kernels, TF32 off) against the CPU's (plain versions).

    The weights are conditioned so that every gradient is a quantity and not
    f32 noise: the poses are relative to view 0, so with the init's
    LayerScale 1e-5 (the views' camera tokens nearly equal) and its 1e-3
    camera output layer (every rotation near the identity) the camera head's
    gradients cancel to noise.  LayerScale 0.5, the output layer x300 and
    random target poses fix that (tests/test_torch_train.py does the same
    against JAX).  The DPT head's convolutions get bias DPT_BIAS: with the
    init's zero biases, a few of its ~10^7 ReLU inputs lie within f32
    rounding of 0, the two devices round them to opposite sides, and each
    such unit moves one position's whole term of a weight gradient (f32
    against f64 on the CPU: 4e-3 of max |g| at bias 0, 8e-5 at bias 5)."""
    from da3slam_tpu_torch.core.transforms import highest_precision
    from da3slam_tpu_torch.models.config import get_preset
    from da3slam_tpu_torch.models.da3 import init_params
    from da3slam_tpu_torch.parallel.train import UNUSED_PARAMS, synthetic_batch, window_loss

    cfg = get_preset("small")
    batch = synthetic_batch(cfg, 1, 2, (280, 280), seed=0)
    batch["extrinsics"] = batch["extrinsics"] + np.random.default_rng(9).normal(
        scale=0.3, size=batch["extrinsics"].shape).astype(np.float32)
    cpu = init_params(cfg, seed=0)
    with torch.no_grad():
        for blk in cpu.blocks:
            blk.ls1.gamma.fill_(0.5)
            blk.ls2.gamma.fill_(0.5)
        cpu.camera_head.out.weight.mul_(300.0)
        for m in cpu.depth_head.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.bias.fill_(DPT_BIAS)
    gpu = copy.deepcopy(cpu).to("cuda")
    losses, grads = {}, {}
    for dev, net in (("cpu", cpu), ("cuda", gpu)):
        b = {k: torch.from_numpy(x[0]).to(dev) for k, x in batch.items()}
        with highest_precision():  # the forward AND the backward: no TF32
            loss = window_loss(net, cfg, b["images"], b["depth"], b["extrinsics"])
            loss.backward()
        losses[dev] = loss.item()
        grads[dev] = {n: p.grad for n, p in net.named_parameters()}
    no_grad = {dev: sorted(n for n, g in gs.items() if g is None) for dev, gs in grads.items()}
    expected_none = sorted(n for n in grads["cpu"] if n.startswith(UNUSED_PARAMS))
    worst, worst_name, n_zero = 0.0, None, 0
    for name, g_cpu in grads["cpu"].items():
        g_gpu = grads["cuda"][name]
        if g_cpu is None:
            continue
        if g_gpu is None or not bool(torch.isfinite(g_gpu).all().item()):
            fail(f"train grad parity: {name} has no finite gradient on the card")
        g_gpu = g_gpu.cpu()
        ref = g_cpu.abs().max().item()
        diff = (g_gpu - g_cpu).abs().max().item()
        if ref == 0.0:
            n_zero += 1
            if diff != 0.0:
                fail(f"train grad parity: {name} is exactly zero on the CPU, not on the card")
            continue
        if diff / ref > worst:
            worst, worst_name = diff / ref, name
    emit("train_grad_parity", preset="small", views=2, hw=[280, 280], dtype="float32",
         loss=losses, params=len(grads["cpu"]), params_without_grad=no_grad["cuda"],
         params_zero_grad=n_zero, max_rel_err=worst, worst_param=worst_name,
         tol=MODEL_PARITY_TOL)
    if no_grad["cuda"] != expected_none or no_grad["cpu"] != expected_none:
        fail(f"train grad parity: parameters without a gradient {no_grad}, expected only "
             f"{expected_none} (never read by the forward)")
    if not worst <= MODEL_PARITY_TOL:
        fail(f"train grad parity: {worst_name} off by {worst} relative")


def _kernel_category(name: str) -> str:
    if any(s in name for s in ("flash_fwd", "key_norm_max", "flash_probe")):
        return "attention_fwd"
    if "flash_bwd" in name:
        return "attention_bwd"
    low = name.lower()
    if any(s in low for s in ("conv", "cudnn", "fprop", "dgrad", "wgrad")):
        return "conv (DPT head, patch embed)"
    if any(s in low for s in ("gemm", "cutlass", "matmul", "nvjet")):  # nvjet: cuBLAS on sm_90
        return "gemm"
    if "upsample" in low:
        return "upsample (DPT head)"
    if "layer_norm" in low:
        return "layernorm"
    if "multi_tensor_apply" in low:  # AdamW's foreach kernels
        return "optimizer"
    return "other"


def _profile(phase: str, fn, **fields) -> None:
    """``torch.profiler`` over one warm call of ``fn`` (synchronised): wall,
    device busy time, idle share and the busy time split by kind of kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat: dict[str, float] = {}
    top = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue  # an annotation spans kernels that are counted on their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us <= 0:
            continue
        cat = _kernel_category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:90]))
    busy = sum(by_cat.values())
    emit(phase, **fields, wall_ms=wall_ms, device_busy_ms=busy,
         idle_share=(1 - busy / wall_ms) if busy else None,
         split_ms=by_cat, split_share={k: v / busy for k, v in by_cat.items()} if busy else {},
         top_kernels=sorted(top, reverse=True)[:15])


def _profile_step(cfg) -> None:
    from da3slam_tpu_torch.parallel.train import make_train_step, synthetic_batch

    init_fn, step_fn, place = make_train_step(cfg, "cuda")
    state = init_fn(seed=1)
    batch = place(synthetic_batch(cfg, TRAIN_BATCH, TRAIN_VIEWS, (TRAIN_HW, TRAIN_HW), seed=7))
    _profile("train_profile", lambda: step_fn(state, batch))


def phase_train(path_launches: dict) -> None:
    from da3slam_tpu_torch.cli import train
    from da3slam_tpu_torch.models.config import get_preset

    cfg = get_preset("small")
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with counted(path_launches, "train"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train.main(TRAIN_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(out.getvalue(), end="", flush=True)
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    losses = [ln["loss"] for ln in lines if "loss" in ln and "step" in ln]
    launches = path_launches["train"]
    per_attention = TRAIN_STEPS * TRAIN_BATCH * cfg.depth
    expected = expected_launches(flash_attn_bound_fwd=per_attention,
                                 flash_attn_bwd_dq=per_attention,
                                 flash_attn_bwd_dkv=per_attention)
    emit("train", args=TRAIN_ARGS, wall_s=wall, steps_per_s=TRAIN_STEPS / wall,
         windows_per_s=TRAIN_STEPS * TRAIN_BATCH / wall,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), losses=losses,
         launches=launches, expected_launches=expected,
         launch_formula=f"steps {TRAIN_STEPS} x windows {TRAIN_BATCH} x blocks {cfg.depth} "
                        "(windows run one after another; remat off)")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"train: losses {losses}")
    if launches != expected:
        fail(f"train: launches {launches} != {expected}")
    _profile_step(cfg)


def phase_public_flash_attention(path_launches: dict) -> None:
    """A user's call of the public entry point (stable=True, the default),
    forward and backward, at the training cross-view shape; the output and
    q/k/v's gradients against the plain stable forward and plain backward on
    the same inputs (bounds: fwd_bound, grad_bound)."""
    from da3slam_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_backward_reference,
        flash_attention_stable_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = (1, 5204, 6, 64)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").requires_grad_()
               for _ in range(3))
    g = torch.randn(shape, generator=gen, device="cuda")
    with counted(path_launches, "flash_attention"):
        out = flash_attention(q, k, v)
        out.backward(g)
        torch.cuda.synchronize()
    launches = path_launches["flash_attention"]
    expected = expected_launches(flash_attn_stable_fwd=1, flash_attn_bwd_dq=1,
                                 flash_attn_bwd_dkv=1)
    finite = all(bool(torch.isfinite(t).all().item()) for t in (out, q.grad, k.grad, v.grad))
    with torch.no_grad():
        o_ref, lse_ref = flash_attention_stable_reference(q, k, v)
        refs = dict(zip(("dq", "dk", "dv"), flash_attention_backward_reference(
            q.detach(), k.detach(), v.detach(), o_ref, lse_ref, g)))
    errs = {"out": (out.detach() - o_ref).abs().max().item()}
    tols = {"out": fwd_bound(o_ref)}
    for name, t in zip(("dq", "dk", "dv"), (q, k, v)):
        errs[name] = (t.grad - refs[name]).abs().max().item()
        tols[name] = grad_bound(refs[name])
    emit("flash_attention", shape=list(shape), dtype="float32", stable=True,
         finite=finite, launches=launches, expected_launches=expected,
         max_abs_err=errs, tol=tols)
    if not finite or launches != expected:
        fail(f"flash_attention: finite={finite}, launches {launches} != {expected}")
    for name in errs:
        if not errs[name] <= tols[name]:
            fail(f"flash_attention: {name} disagrees with the plain version: "
                 f"{errs[name]} > {tols[name]}")


def frames_dir() -> Path:
    """The 31 generated 518² PNG frames the SLAM and alignment paths read."""
    from PIL import Image

    image_dir = WORK / "frames"
    if not image_dir.exists():
        image_dir.mkdir(parents=True)
        for i, f in enumerate(make_frames(N_FRAMES, seed=1)):
            Image.fromarray(f).save(image_dir / f"{i:06d}.png")
    return image_dir


def phase_main_path(path_launches: dict) -> None:
    from da3slam_tpu_torch.cli import main_slam

    image_dir = frames_dir()
    out_dir = WORK / "out"
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with counted(path_launches, "main_slam"):
        t0 = time.perf_counter()
        main_slam.main(["--image_dir", str(image_dir), "--output_dir", str(out_dir), "--headless"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = path_launches["main_slam"]
    expected = expected_launches(flash_attn_bound_fwd=EXPECTED_LAUNCHES)
    poses = np.loadtxt(out_dir / "camera_poses.txt", ndmin=2)
    ok = poses.shape == (N_FRAMES, 16) and np.isfinite(poses).all()
    emit("main_path", frames=N_FRAMES, wall_s=wall, frames_per_s=N_FRAMES / wall,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         poses_shape=list(poses.shape), poses_finite=bool(np.isfinite(poses).all()),
         kernel_launches=launches, expected_launches=expected)
    if not ok:
        fail(f"camera_poses.txt: shape {poses.shape}, finite={np.isfinite(poses).all()}")
    if launches != expected:
        fail(f"kernel launches on the main path: {launches} != {expected}")


def probe_roofline(Sq: int, Sk: int, n_rows: int) -> dict:
    """4·BH·Sq·Sk·D operations; q, O, k, v in bf16 and ``n_rows`` f32 [BH, Sq] rows."""
    return roofline(4 * 6 * Sq * Sk * 64, 6 * 64 * 2 * (2 * Sq + 2 * Sk) + n_rows * 6 * Sq * 4,
                    torch.bfloat16)


def phase_conv3x3() -> dict:
    from da3slam_tpu_torch.ops.conv3x3 import conv3x3_fused, conv3x3_reference
    from da3slam_tpu_torch.tools.probe_conv3x3 import conv_inputs, library_conv

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for label, dtype, N, H, W, C, COUT, relu in CONV_CASES:
        # the tool's inputs from another seed, and a bias that is not zero
        x, k = conv_inputs(N, H, W, C, COUT, "cuda", dtype, seed=3)
        b = torch.randn(COUT, generator=gen, device="cuda")
        out = conv3x3_fused(k, b, x, relu=relu)
        ref = conv3x3_reference(k, b, x, relu=relu)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = conv_bound(ref)
        halo = dropped_halo_errors(k, b, x, ref, relu)
        lib = library_conv(k, b, x)
        # F.conv2d rounds its bf16 bias add and, in f32, runs cuDNN in TF32 by
        # torch's default: a yardstick of speed, not held to the bound
        lib_out = lib().permute(0, 2, 3, 1)
        if relu:
            lib_out = lib_out.relu()
        lib_diff = (lib_out.float() - ref.float()).abs().max().item()
        elem = x.element_size()
        row = {"case": label, "dtype": str(dtype).replace("torch.", ""),
               "shape": [N, H, W, C, COUT], "relu": relu, "max_abs_err": err, "tol": tol,
               "plain_max_abs": ref.float().abs().max().item(), "dropped_halo_err": halo,
               "ms": cuda_ms(lambda: conv3x3_fused(k, b, x, relu=relu), reps=5),
               "plain_ms": cuda_ms(lambda: conv3x3_reference(k, b, x, relu=relu), reps=3),
               "library_ms": cuda_ms(lib, reps=5),
               "library": "F.conv2d (channels-last, same dtype)",
               "library_max_abs_diff": lib_diff,
               **roofline(2 * 9 * C * COUT * H * W * N,
                          N * H * W * (C + COUT) * elem + 9 * C * COUT * 4 + COUT * 4, dtype)}
        row["kernel_tflops"] = row["flop"] / row["ms"] / 1e9
        emit("conv3x3_vs_plain", **row)
        if not bool(torch.isfinite(out).all().item()) or not err <= tol:
            fail(f"conv3x3 disagrees with its plain version at {label}: {err} > {tol}")
        for edge, cut in halo.items():
            if not cut > tol:
                fail(f"the conv3x3 bound at {label} ({tol}) would pass a dropped halo "
                     f"{edge} ({cut})")
        rows.append(row)
        del x, out, ref, lib, lib_out
        torch.cuda.empty_cache()
    return {"conv3x3": rows}


def phase_flash_probes() -> dict:
    """Each probe kernel against its plain version: O to 2^-6·max|O| (bf16: the
    two round p at the same points and differ by the output's rounding), lse
    to 1e-3 (a dropped or double-counted key tile moves it by more)."""
    from da3slam_tpu_torch.ops import flash_probes as fp
    from da3slam_tpu_torch.tools.flash_lab import lab_inputs
    from da3slam_tpu_torch.tools.flash_nomax_probe import probe_inputs

    gen = torch.Generator(device="cuda").manual_seed(4)
    ln2 = 0.6931471805599453

    def sdpa_call(q, k, v, n, scale=None):
        """One SDPA call over the first ``n`` keys of folded [BH, S, D] inputs."""
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None, :, :n], v[None, :, :n], scale=scale)[0]

    rows = {"flash_probe_nomax": [], "flash_probe_bisect": [], "flash_probe_lab": []}
    for case, (Sq, Sk, seq_k) in (("tool", (PROBE_PAD, PROBE_PAD, PROBE_S)),
                                  ("ragged", PROBE_RAGGED)):
        # the tools' inputs (padded k, v rows zeros) and a per-row shift m in [15, 16)
        q, k, v = probe_inputs(Sq, Sk, "cuda", seed=4, seq_k=seq_k)
        m = 15.0 + torch.rand(6, Sq, generator=gen, device="cuda")
        # (kernel, variant, kernel call, plain call, rows of f32 in/out, library call)
        # O = softmax(ln2·q·kᵀ)·v for any shift, so SDPA with scale ln2 is the
        # library's call for O: over every key where the padding is counted
        # (nomax, A), over the first seq_k where it is masked or subtracted
        # (the padded v rows are zeros).  As for the production forwards, the
        # lse output has no library call of its own.
        jobs = [("flash_probe_nomax", "nomax", lambda: (fp.flash_nomax(q, k, v), None),
                 lambda: (fp.flash_nomax_reference(q, k, v), None), 0,
                 sdpa_call(q, k, v, Sk, ln2))]
        for var in "ACE":
            jobs.append(("flash_probe_bisect", var,
                         lambda var=var: fp.flash_bisect(q, k, v, var, m, seq_k=seq_k),
                         lambda var=var: fp.flash_bisect_reference(q, k, v, var, m, seq_k=seq_k),
                         1 if var == "A" else 2,
                         sdpa_call(q, k, v, Sk if var == "A" else seq_k, ln2)))
        for kernel, var, run, plain, n_rows, library in jobs:
            rows[kernel].append(_probe_case(kernel, case, var, run, plain, library,
                                            probe_roofline(Sq, Sk, n_rows), (Sq, Sk, seq_k)))
        del q, k, v, m
        torch.cuda.empty_cache()
    # the lab's q is as long as its padded keys
    for case, (Sk, seq_k) in (("tool", (LAB_S, LAB_S)), ("ragged", PROBE_RAGGED[1:])):
        q, k, v = lab_inputs(Sk, "cuda", seed=4)
        for var in fp.LAB_VARIANTS:
            rows["flash_probe_lab"].append(_probe_case(
                "flash_probe_lab", case, var,
                lambda var=var: (fp.flash_lab(q, k, v, var, seq_k=seq_k), None),
                lambda var=var: (fp.flash_lab_reference(q, k, v, var, seq_k=seq_k), None),
                sdpa_call(q, k, v, seq_k),
                probe_roofline(Sk, seq_k, 0), (Sk, Sk, seq_k)))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def _probe_case(kernel, case, variant, run, plain, library, bound, shape) -> dict:
    o, lse = run()
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    tol = fwd_bound(o_ref)
    lse_err = None if lse is None else (lse - lse_ref).abs().max().item()
    row = {"case": case, "variant": variant, "dtype": "bfloat16",
           "shape": dict(zip(("Sq", "Sk", "seq_k"), shape)), "max_abs_err": err, "tol": tol,
           "plain_max_abs": o_ref.float().abs().max().item(), "lse_max_abs_err": lse_err,
           "lse_tol": LSE_TOL, "ms": cuda_ms(run, reps=5), "plain_ms": cuda_ms(plain, reps=3),
           "library_ms": cuda_ms(library, reps=5), "library": "F.scaled_dot_product_attention",
           # a yardstick of speed: it rounds p and O at other points, so it is
           # recorded beside the bound and not held to it
           "library_max_abs_diff": (library().float() - o_ref.float()).abs().max().item(),
           **bound}
    row["kernel_tflops"] = row["flop"] / row["ms"] / 1e9
    emit("probe_vs_plain", kernel=kernel, **row)
    if not bool(torch.isfinite(o).all().item()) or not err <= tol:
        fail(f"{kernel} {variant} disagrees with its plain version at {case}: {err} > {tol}")
    if lse_err is not None and not lse_err <= LSE_TOL:
        fail(f"{kernel} {variant} lse disagrees with its plain version at {case}: {lse_err}")
    return row


def phase_tools(path_launches: dict) -> None:
    """The four probe tools through their ``main``: every line they print
    carries the kernel's error against its plain version, held here to the
    bounds of the phases above."""
    from da3slam_tpu_torch.tools import flash_bound_bisect, flash_lab, flash_nomax_probe
    from da3slam_tpu_torch.tools import probe_conv3x3

    with counted(path_launches, "tools"):
        t0 = time.perf_counter()
        out = {"probe_conv3x3": probe_conv3x3.main([]),
               "flash_nomax_probe": flash_nomax_probe.main(["1024,3584"]),
               "flash_bound_bisect": flash_bound_bisect.main(["A", "C", "E"]),
               "flash_lab": flash_lab.main([])}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = path_launches["tools"]
    emit("tools", wall_s=wall, launches=launches, rows=out)
    for name in ("conv3x3", "flash_probe_nomax", "flash_probe_bisect", "flash_probe_lab"):
        if not launches[name]:
            fail(f"tools: {name} was launched no time")
    if any(launches[name] for name in launches if name.startswith("flash_attn")):
        fail(f"tools: a production kernel was launched: {launches}")
    for tool, rows in out.items():
        for row in rows:
            tol = BF16_REL_TOL * row["plain_max_abs"]
            if not row["max_abs_err"] <= tol or not row.get("lse_max_abs_err", 0.0) <= LSE_TOL:
                fail(f"tools: {tool} reports {row}")


def read_ply(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """Vertices and colors of a binary PLY as ``inout/ply.py:write_ply`` writes it."""
    data = path.read_bytes()
    head, _, body = data.partition(b"end_header\n")
    n = int(next(ln.split()[2] for ln in head.decode("ascii").splitlines()
                 if ln.startswith("element vertex")))
    rec = np.frombuffer(body, dtype=[("xyz", "<f4", 3), ("rgb", np.uint8, 3)], count=n)
    return rec["xyz"], rec["rgb"]


def phase_main_align(path_launches: dict) -> None:
    from da3slam_tpu_torch.cli import main_align
    from da3slam_tpu_torch.models.da3 import DepthAnything3

    ply = WORK / "align" / "fused.ply"
    args = ["--image_dir", str(frames_dir()), *ALIGN_ARGS, "--output_ply", str(ply)]
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with counted(path_launches, "main_align"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main_align.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(out.getvalue(), end="", flush=True)
    stats = [[float(x) for x in ln.replace("=", " ").split()[3::2]]
             for ln in out.getvalue().splitlines() if ln.startswith("chunk ")]
    launches = path_launches["main_align"]
    expected = expected_launches(flash_attn_bound_fwd=ALIGN_EXPECTED_LAUNCHES)
    pts, cols = read_ply(ply)
    emit("main_align", args=ALIGN_ARGS, frames=N_FRAMES, wall_s=wall,
         frames_per_s=N_FRAMES / wall,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         chunk_stats_scale_fitness_rmse=stats, ply_points=int(len(pts)),
         ply_finite=bool(np.isfinite(pts).all()), kernel_launches=launches,
         expected_launches=expected)
    if len(stats) != 2 or not np.isfinite(np.array(stats)).all():
        fail(f"main_align: chunk diagnostics {stats}")
    if len(pts) == 0 or not np.isfinite(pts).all() or cols.shape != pts.shape:
        fail(f"main_align: PLY with {len(pts)} points, finite={np.isfinite(pts).all()}")
    if launches != expected:
        fail(f"kernel launches on the main_align path: {launches} != {expected}")
    # where one warm LARGE chunk's device time goes
    model = DepthAnything3.from_pretrained("large", device="cuda")
    frames = make_frames(15, seed=1)
    _profile("large_chunk_profile", lambda: model.inference(image=frames, use_ray_pose=True),
             preset="large", frames=15, dtype="bfloat16")
    del model
    torch.cuda.empty_cache()


def _count_syncs(fn) -> int:
    """How many times ``fn`` made the host wait for the device, as
    ``torch.cuda.set_sync_debug_mode`` reports it."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_main_slam_irls(path_launches: dict) -> None:
    """The main path again from a config file: device-resident solver, IRLS
    alignment with the config's IRLS block, the prefetcher staging each next
    chunk's upload on its side stream.  The host's waits for the device are
    counted over the whole run for IRLS with and without the prefetcher and
    for ICP: the differences are what IRLS (one ``torch.linalg.svd`` a step)
    and the staging add."""
    from da3slam_tpu_torch.cli import main_slam

    def run(tag: str, method: str, prefetch: bool) -> dict:
        cfg = WORK / f"slam_{tag}.yaml"
        cfg.write_text(
            "Weights: {DA3: small}\n"
            f"Model: {{chunk_size: 15, overlap_size: 1, keyframe_interval: 1, "
            f"device_resident: true, prefetch: {str(prefetch).lower()}}}\n"
            f"Align: {{method: {method}}}\n"
            "IRLS: {delta: 0.1, max_iters: 5, tol: 1.e-9}\n")
        out_dir = WORK / f"out_{tag}"
        torch.cuda.synchronize()
        with counted(path_launches, f"main_slam_{tag}"):
            t0 = time.perf_counter()
            syncs = _count_syncs(lambda: main_slam.main(
                ["--image_dir", str(frames_dir()), "--config", str(cfg),
                 "--output_dir", str(out_dir), "--headless"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        poses = np.loadtxt(out_dir / "camera_poses.txt", ndmin=2)
        launches = path_launches[f"main_slam_{tag}"]
        if poses.shape != (N_FRAMES, 16) or not np.isfinite(poses).all():
            fail(f"main_slam {tag}: poses {poses.shape}, finite={np.isfinite(poses).all()}")
        if launches != expected_launches(flash_attn_bound_fwd=EXPECTED_LAUNCHES):
            fail(f"main_slam {tag}: launches {launches}")
        return {"method": method, "prefetch_and_staging": prefetch, "wall_s": wall,
                "host_syncs": syncs, "poses_shape": list(poses.shape),
                "bound_launches": launches["flash_attn_bound_fwd"]}

    runs = {"irls": run("irls", "irls", True),
            "irls_no_prefetch": run("irls_no_prefetch", "irls", False),
            "icp": run("icp", "icp", True)}
    emit("main_slam_irls", frames=N_FRAMES, runs=runs,
         syncs_irls_adds_over_icp=runs["irls"]["host_syncs"] - runs["icp"]["host_syncs"],
         syncs_staging_adds=runs["irls"]["host_syncs"] - runs["irls_no_prefetch"]["host_syncs"])


SOURCES = {
    "flash_attn_bound_fwd": ("da3slam_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                             "da3slam_tpu/ops/flash_attention.py:116", "cross"),
    "flash_attn_stable_fwd": ("da3slam_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                              "da3slam_tpu/ops/flash_attention.py:41", "cross"),
    "flash_attn_bwd_dq": ("da3slam_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                          "da3slam_tpu/ops/flash_attention.py:298", "train_cross"),
    "flash_attn_bwd_dkv": ("da3slam_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                           "da3slam_tpu/ops/flash_attention.py:340", "train_cross"),
    "conv3x3": ("da3slam_tpu_torch/ops/csrc/conv3x3.cu",
                "da3slam_tpu/ops/conv3x3.py:74", "head1-large"),
    # the probes' headline is the first row at the tools' shape (variant A, old)
    "flash_probe_nomax": ("da3slam_tpu_torch/ops/csrc/flash_probe_fwd.cu",
                          "tools/flash_nomax_probe.py:31", "tool"),
    "flash_probe_bisect": ("da3slam_tpu_torch/ops/csrc/flash_probe_fwd.cu",
                           "tools/flash_bound_bisect.py:35", "tool"),
    "flash_probe_lab": ("da3slam_tpu_torch/ops/csrc/flash_probe_fwd.cu",
                        "tools/flash_lab.py:34", "tool"),
}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script runs only on a CUDA GPU")
    phase_env()
    phase_build()
    rows = phase_forwards()
    rows.update(phase_backward())
    phase_model_parity()
    phase_train_grad_parity()
    path_launches: dict = {}
    phase_train(path_launches)
    phase_public_flash_attention(path_launches)
    phase_main_path(path_launches)
    rows.update(phase_conv3x3())
    rows.update(phase_flash_probes())
    phase_tools(path_launches)
    phase_main_align(path_launches)
    phase_main_slam_irls(path_launches)
    kernels = []
    for name, (source, replaces, headline) in SOURCES.items():
        by_path = {path: counts[name] for path, counts in path_launches.items()}
        head = next(r for r in rows[name] if r["case"] == headline)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "headline_case": headline, "shapes": rows[name],
        })
        if not sum(by_path.values()):
            fail(f"{name} was launched no time on the driven paths")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
