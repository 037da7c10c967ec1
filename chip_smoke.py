"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before the
final line:

1. env: the card (nvidia-smi name and power limit), torch and CUDA versions
2. build: nvcc build of the flash-attention kernel
3. kernel vs plain: the kernel against its plain torch version, both on the
   card, at the SMALL tier's shapes (CUDA-event times, median of a few runs)
4. model f32 parity: the SMALL forward on a 2-frame 518² chunk, CUDA f32
   (kernel) against the same weights on the CPU (plain attention)
5. main path: ``da3slam_tpu_torch.cli.main_slam`` over 31 generated frames
   (SMALL, chunk 15, overlap 1: two steady chunks and the re-anchored tail),
   counting the kernel's launches

The last line is ``{"ok": true, "device": {...}}``.  There is no CPU fallback:
without CUDA the script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# (dtype, shape [B, S, H, D]).  Intra and cross are the SMALL tier at
# process_res 504, chunk 15: 15 views of 36*36 + 1 + 4 = 1301 tokens, folded
# into one sequence of 19515 for the cross-view blocks.
KERNEL_CASES = [
    ("intra", torch.bfloat16, (15, 1301, 6, 64)),
    ("cross", torch.bfloat16, (1, 19515, 6, 64)),
    ("ragged", torch.bfloat16, (2, 300, 3, 64)),
    ("f32", torch.float32, (2, 1301, 6, 64)),
]
# Bounds on max |kernel - plain|.  Both round p to V's dtype at the same
# place, so in bf16 they differ by the output's final rounding: at most one
# bf16 ulp of the largest |O|.  The bound is 2^-6 * max |O|, which is 2-4
# such ulps; it scales with |O|, which is ~0.04 at the cross shape, where a
# fixed 2e-2 would pass a dropped key tile.  f32 keeps the JAX package's own
# bound for this forward (tests/test_flash_attention.py: 5e-5).  lse sums
# every key's p, so a dropped or repeated key tile moves it by more than
# LSE_TOL: dropping the ragged last tile (59 keys) at the cross shape moves
# both lse and O by about 1e-2.
BF16_REL_TOL = 2.0 ** -6
F32_TOL = 5e-5
LSE_TOL = 1e-3
# f32 card-vs-CPU model parity: max |cuda - cpu| / max |cpu| per output
MODEL_PARITY_TOL = 1e-3
N_FRAMES = 31
EXPECTED_LAUNCHES = 12 * 3  # 12 encoder blocks x 3 chunks


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    ptxas = [ln.strip() for ln in fa._Kernel.build_log.splitlines() if "registers" in ln]
    emit("build", seconds=fa._Kernel.build_seconds, library=str(fa._Kernel.path.relative_to(ROOT)),
         ptxas=ptxas)


def phase_kernels() -> dict:
    from da3slam_tpu_torch.ops.flash_attention import (
        flash_attention_bound,
        flash_attention_bound_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    per_shape = []
    for name, dtype, shape in KERNEL_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        o, lse = flash_attention_bound(q, k, v)
        o_ref, lse_ref = flash_attention_bound_reference(q, k, v)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        o_max = o_ref.float().abs().max().item()
        tol = BF16_REL_TOL * o_max if dtype == torch.bfloat16 else F32_TOL
        lse_err = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o).all().item())
        ms = cuda_ms(lambda: flash_attention_bound(q, k, v), reps=5)
        plain_ms = cuda_ms(lambda: flash_attention_bound_reference(q, k, v), reps=3)
        B, S, H, D = shape
        row = {"case": name, "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
               "max_abs_err": err, "tol": tol, "plain_max_abs": o_max,
               "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL, "ms": ms,
               "plain_ms": plain_ms, "kernel_tflops": 4 * B * H * S * S * D / ms / 1e9}
        emit("kernel_vs_plain", **row)
        if not finite or not err <= tol:
            fail(f"kernel disagrees with its plain version at {name}: {err} > {tol}")
        if not lse_err <= LSE_TOL:
            fail(f"kernel lse disagrees with its plain version at {name}: {lse_err} > {LSE_TOL}")
        per_shape.append(row)
        del q, k, v, o, o_ref, lse, lse_ref
        torch.cuda.empty_cache()
    return {r["case"]: r for r in per_shape}


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


def phase_main_path() -> int:
    from PIL import Image

    from da3slam_tpu_torch.cli import main_slam
    from da3slam_tpu_torch.ops.flash_attention import flash_attention_bound

    image_dir = WORK / "frames"
    out_dir = WORK / "out"
    image_dir.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(make_frames(N_FRAMES, seed=1)):
        Image.fromarray(f).save(image_dir / f"{i:06d}.png")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    flash_attention_bound.launches = 0
    t0 = time.perf_counter()
    main_slam.main(["--image_dir", str(image_dir), "--output_dir", str(out_dir), "--headless"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_bound.launches
    poses = np.loadtxt(out_dir / "camera_poses.txt", ndmin=2)
    ok = poses.shape == (N_FRAMES, 16) and np.isfinite(poses).all()
    emit("main_path", frames=N_FRAMES, wall_s=wall, frames_per_s=N_FRAMES / wall,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         poses_shape=list(poses.shape), poses_finite=bool(np.isfinite(poses).all()),
         kernel_launches=launches, expected_launches=EXPECTED_LAUNCHES)
    if not ok:
        fail(f"camera_poses.txt: shape {poses.shape}, finite={np.isfinite(poses).all()}")
    if launches != EXPECTED_LAUNCHES:
        fail(f"kernel launches on the main path: {launches} != {EXPECTED_LAUNCHES}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script runs only on a CUDA GPU")
    phase_env()
    phase_build()
    shapes = phase_kernels()
    phase_model_parity()
    launches = phase_main_path()
    cross = shapes["cross"]
    print(json.dumps({"kernels": [{
        "name": "flash_attn_bound_fwd",
        "route": "cuda",
        "source": "da3slam_tpu_torch/ops/csrc/flash_attn_bound_fwd.cu",
        "replaces": "da3slam_tpu/ops/flash_attention.py:116",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
        "ms": cross["ms"],
        "plain_ms": cross["plain_ms"],
        "shapes": list(shapes.values()),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
