"""What each step of the bf16 forward's design bought, and what the f32
forward's time is made of: ``flash_attn_fwd.cu`` built at four stages of the
bf16 design (its ``FLASH_FWD_*`` macros) and timed in turns at the cross-view
shape, and built as it stands and in changed copies for f32, timed in turns
at the training cross-view shape, each beside the library's call.

  wgmma      both products on the tensor cores; a ring of two stages, too short
             to load ahead; one consumer warpgroup (64 query rows a CTA);
             softmax and products one after the other
  +ring      three stages: the next tile loads while this one is multiplied
  +128rows   two consumer warpgroups share every K/V stage
  +overlap   the softmax of tile j beside P.V of tile j-1: the kernel as built

The f32 variants (3xTF32 on ``wgmma``), both modes:

  f32_as_built      the source as the library builds it
  f32_one_product   one TF32 product (hi·hi) in place of three: what the
                    compensation costs (wrong beyond the f32 bound)
  f32_no_promotion  P·V summed on the tensor cores alone, no blocks of 8 tiles
                    promoted into f32 sums
  f32_64rows        one consumer warpgroup, 64 query rows a CTA (160 threads,
                    up to 255 registers; twice the K/V traffic from L2)
  f32_three_stages  a ring of three stages in place of four

    python -m da3slam_tpu_torch.tools.flash_fwd_stages
    python -m da3slam_tpu_torch.tools.flash_fwd_stages --shape 15 1301 6 --stage +overlap
    python -m da3slam_tpu_torch.tools.flash_fwd_stages --f32-variant f32_as_built --f32-shape 4 1301 6

``--parts`` times three cut-down copies of the kernel as built beside it, to
see what the whole is made of (their outputs are wrong by construction and are
not checked): the products without the softmax, the softmax without the
products, and everything but the K/V loads after the ring's first fill.

Each variant that is still the forward is held to the plain version before
it is timed (bf16 2^-6·max|O|, f32 the smoke's F32_TOL; lse 1e-3); the others'
errors are printed.  The last line is the host's own cost of one call of the
production wrapper (allocation, two tensor maps, two launches), taken on a
one-tile input with no wait for the device.  CUDA only: the variants are
builds of the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import torch

from da3slam_tpu_torch.ops import flash_attention as fa
from da3slam_tpu_torch.tools import max_abs_err
from da3slam_tpu_torch.utils.profiling import time_ms

# stage -> (FLASH_FWD_STAGES, FLASH_FWD_CONSUMERS, FLASH_FWD_OVERLAP)
STAGES = {"wgmma": (2, 1, 0), "+ring": (3, 1, 0), "+128rows": (3, 2, 0), "+overlap": (3, 2, 1)}
SOURCE = "flash_attn_fwd.cu"
# part -> lines of the consumer's tile loop (or the producer's) to replace; each
# must occur exactly once in the source
PARTS = {
    "products_only": [
        ("      softmax_tile<kStable>(s, p_next, m, alpha, S - t * kTileK, c2);\n", ""),
        ("      add_row_sums(l, p_next);\n", ""),
    ],
    "softmax_only": [
        ("      start_scores(s, q_desc, ring + stage * kStageBytes);\n", ""),
        ("      start_pv(acc, p, ring + prev * kStageBytes + kTileBytes);\n", ""),
    ],
    "no_loads_after_first_fill": [
        ("      for (int t = 0; t < n_tiles; ++t) {\n",
         "      for (int t = 0; t < min(n_tiles, kStages); ++t) {\n"),
        ("      mbar_wait(full_bar + stage * 8, parity);\n",
         "      if (t < kStages) mbar_wait(full_bar + stage * 8, parity);\n"),
    ],
}
# f32 variant -> (lines of the source to replace, each occurring exactly once;
#                 whether the result is still the forward)
F32_VARIANTS: dict[str, tuple[list[tuple[str, str]], bool]] = {
    "f32_as_built": ([], True),
    "f32_one_product": ([("constexpr int kTf32Terms = 3;", "constexpr int kTf32Terms = 1;")], False),
    "f32_no_promotion": ([("constexpr int kPromoteTiles = 8;",
                           "constexpr int kPromoteTiles = 1 << 30;")], False),
    "f32_64rows": ([("constexpr int kF32Consumers = 2;", "constexpr int kF32Consumers = 1;")], True),
    "f32_three_stages": ([("constexpr int kF32Stages = 4;", "constexpr int kF32Stages = 3;")], True),
}
# the bounds a variant that is still the forward is held to (chip_smoke.py's)
F32_TOL, LSE_TOL = 5e-5, 1e-3


def build_variants(names) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together."""
    fa._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        stages, consumers, overlap = STAGES[name]
        out = fa._BUILD_DIR / f"libflash_attn_fwd_s{stages}c{consumers}o{overlap}.so"
        defines = (f"FLASH_FWD_STAGES={stages}", f"FLASH_FWD_CONSUMERS={consumers}",
                   f"FLASH_FWD_OVERLAP={overlap}")
        procs[name] = (out, subprocess.Popen(fa.nvcc_command(fa._CSRC / SOURCE, out, defines),
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {SOURCE} ({name}) failed:\n{err}")
        print(json.dumps({"stage": name, "ptxas": [
            ln.split(":", 1)[-1].strip() for ln in err.splitlines()
            if "wgmma_kernel" in ln and "Compiling" in ln or "registers" in ln or "spill" in ln
            or "warning" in ln.lower()][:12]}), flush=True)
        libs[name] = bind(out)
    return libs


def cut_source(cuts) -> str:
    """The source with ``cuts`` (old, new) applied, each old text occurring once."""
    text = (fa._CSRC / SOURCE).read_text()
    for old, new in cuts:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} occurs {text.count(old)} times in {SOURCE}")
        text = text.replace(old, new)
    return text


def build_cut(group: str, variants: dict[str, list[tuple[str, str]]]) -> dict[str, ctypes.CDLL]:
    """Each variant's cut source built beside a copy of the headers, one nvcc a
    variant, all started together; ptxas's report of each kernel printed."""
    procs = {}
    for name, cuts in variants.items():
        work = fa._BUILD_DIR / group / name
        work.mkdir(parents=True, exist_ok=True)
        (work / SOURCE).write_text(cut_source(cuts))
        for header in fa._HEADERS:
            (work / header).write_bytes((fa._CSRC / header).read_bytes())
        out = work / "libflash_attn_fwd.so"
        procs[name] = (out, subprocess.Popen(fa.nvcc_command(work / SOURCE, out),
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {SOURCE} ({name}) failed:\n{err}")
        report, kernel, stable = {}, None, False
        for ln in err.splitlines():
            if "Compiling entry function" in ln:
                kernel = "tf32" if "flash_fwd_tf32_kernel" in ln else \
                    "wgmma" if "flash_fwd_wgmma_kernel" in ln else None
                stable = "ILb1E" in ln
            elif kernel and ("registers" in ln or "spill" in ln):
                report.setdefault(f"{kernel}_{'stable' if stable else 'bound'}", []).append(
                    ln.split(":", 1)[-1].strip())
        report["serialized_wgmma"] = any("serialized" in ln for ln in err.splitlines())
        print(json.dumps({"variant": name, "ptxas": report}), flush=True)
        libs[name] = bind(out)
    return libs


def build_parts() -> dict[str, ctypes.CDLL]:
    """The source with each of PARTS' cuts applied, built beside the headers."""
    return build_cut("parts", PARTS)


def bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in fa._SOURCES[SOURCE].items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def forward(lib: ctypes.CDLL, q, k, v, stable: bool):
    """The wrappers' launch (``flash_attention_bound`` / ``_stable``) on a variant's library."""
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    ws = fa.forward_workspace(q)
    ptrs = [t.data_ptr() for t in (q, k, v, o, lse)]
    if not stable:
        ptrs.append(torch.empty(B * H, dtype=torch.float32, device=q.device).data_ptr())
    ptrs.append(None if ws is None else ws.data_ptr())
    entry = lib.flash_attn_stable_fwd if stable else lib.flash_attn_bound_fwd
    rc = entry(*ptrs, B, S, H, D, fa.DTYPE_CODES[q.dtype], fa._scale(D),
               torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return o, lse


def time_modes(libs, names, q, k, v, reps: int, held: dict[str, bool]) -> list[dict]:
    """The named builds' bound and stable forwards on (q, k, v), in turns, each
    against the plain version first; ``held[name]``: its error must be within
    the dtype's bound."""
    B, S, H, D = q.shape
    flop = 4 * B * H * S * S * D
    rows = []
    for stable, ref in ((False, fa.flash_attention_bound_reference),
                        (True, fa.flash_attention_stable_reference)):
        o_ref, lse_ref = ref(q, k, v)
        tol = (2.0 ** -6 * o_ref.float().abs().max().item() if q.dtype == torch.bfloat16
               else F32_TOL)
        errs = {}
        for name in names:
            o, lse = forward(libs[name], q, k, v, stable)
            errs[name] = (max_abs_err(o, o_ref), max_abs_err(lse, lse_ref))
            if held[name] and not (errs[name][0] <= tol and errs[name][1] <= LSE_TOL):
                raise SystemExit(f"{name}: O {errs[name][0]} (bound {tol}), lse {errs[name][1]}")
        # in turns, forwards then backwards, so that a drifting clock shows
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(time_ms(lambda: forward(libs[name], q, k, v, stable), "cuda", reps))
        for name in names:
            ms = min(times[name])
            rows.append({"mode": "stable" if stable else "bound", "variant": name,
                         "dtype": str(q.dtype)[6:], "shape": list(q.shape),
                         "ms_in_turns": times[name], "ms": ms, "tflops": flop / ms / 1e9,
                         "max_abs_err": errs[name][0], "lse_max_abs_err": errs[name][1],
                         "plain_max_abs": o_ref.float().abs().max().item()})
            print(json.dumps(rows[-1]), flush=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
                         "cuda", reps)
    state = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
                            "power.draw", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    rows.append({"library": "F.scaled_dot_product_attention", "dtype": str(q.dtype)[6:],
                 "shape": list(q.shape), "ms": library_ms, "tflops": flop / library_ms / 1e9,
                 "gpu_state": state})
    print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", type=int, nargs=3, default=[1, 19515, 6], metavar=("B", "S", "H"),
                   help="the bf16 stages' shape")
    p.add_argument("--stage", action="append", choices=sorted(STAGES))
    p.add_argument("--f32-shape", type=int, nargs=3, default=[1, 5204, 6],
                   metavar=("B", "S", "H"), help="the f32 variants' shape")
    p.add_argument("--f32-variant", action="append", choices=sorted(F32_VARIANTS))
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--parts", action="store_true", help="also time the kernel's cut-down copies")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_stages builds and times CUDA kernels: no CUDA device")
    # naming only one kind runs only that kind
    names = args.stage or ([] if args.f32_variant else list(STAGES))
    f32_names = args.f32_variant or ([] if args.stage else list(F32_VARIANTS))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    if names:
        libs = build_variants(names)
        shape = (*args.shape, fa.HEAD_DIM)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
        rows += time_modes(libs, names, q, k, v, args.reps, dict.fromkeys(names, True))
        if args.parts:
            for name, lib in build_parts().items():
                for stable in (False, True):
                    ms = time_ms(lambda: forward(lib, q, k, v, stable), "cuda", args.reps)
                    rows.append({"mode": "stable" if stable else "bound", "part": name,
                                 "shape": list(shape), "ms": ms})
                    print(json.dumps(rows[-1]), flush=True)
        del q, k, v
    if f32_names:
        libs = build_cut("f32_variants", {n: F32_VARIANTS[n][0] for n in f32_names})
        shape = (*args.f32_shape, fa.HEAD_DIM)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        rows += time_modes(libs, f32_names, q, k, v, args.reps,
                           {n: F32_VARIANTS[n][1] for n in f32_names})
    tiny = tuple(torch.randn(1, 64, 1, fa.HEAD_DIM, device="cuda").bfloat16() for _ in range(3))
    host_us = {}
    for fwd in (fa.flash_attention_bound, fa.flash_attention_stable):
        fwd(*tiny)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fwd(*tiny)
        host_us[fwd.__name__] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    rows.append({"host_us_per_call": host_us, "shape": [1, 64, 1, fa.HEAD_DIM]})
    print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
