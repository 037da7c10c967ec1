"""What the backward kernels' time is made of: ``flash_attn_bwd.cu`` as built
and in changed copies, timed in turns beside the library's backward, the bf16
kernels at the SLAM cross-view shape and the f32 ones at the training
cross-view shape.

  as_built          the source as the library builds it (bf16 and f32 rows)
  copied_fragments  bf16: one set of p/dz fragments plus a copy at the end of
                    every tile step, where the kernel alternates two sets:
                    ptxas merges the copy's registers and serializes the wgmmas
  dkv64             bf16: dk/dv with 64-row tiles like dq: its accumulators spill
  no_overlap        bf16: the exp2 of tile j only after the gradient products
                    of tile j-1 have finished (wait_group 0 where the kernel has 1)
  half_ring         bf16: a ring of half the size (2 stages for dq, 4 for dk/dv)
  terms_only        bf16: p and dz without the products (wrong by construction)
  f32_one_product   f32: one TF32 product (hi·hi) in place of three: what the
                    compensation costs (wrong beyond the f32 bound)
  f32_half_ring     f32: one stage a ring in place of two
  f32_dq_three_stages  f32: three stages a ring for dq (dk/dv has no room)
  f32_no_overlap    f32: the exp2 of tile j only after tile j-1's gradient
                    products have finished
  f32_no_promotion  f32: the gradients summed on the tensor cores alone, no
                    blocks of 8 tiles promoted into f32 sums

    python -m da3slam_tpu_torch.tools.flash_bwd_stages
    python -m da3slam_tpu_torch.tools.flash_bwd_stages --variant f32_as_built --f32-shape 4 1301 6

Each variant prints what ptxas said of its kernels (registers, spills,
serialized wgmma) and its largest error against the plain backward, relative
to max|g|; one that is still the backward is held to its dtype's bound
(bf16 2^-6, f32 1e-4) before it is timed.  CUDA only: the variants are builds
of the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from da3slam_tpu_torch.ops import flash_attention as fa
from da3slam_tpu_torch.tools import max_abs_err
from da3slam_tpu_torch.utils.profiling import time_ms

SOURCE = "flash_attn_bwd.cu"
KERNELS = ("dq_wgmma", "dkv_wgmma", "dq_tf32", "dkv_tf32")
# variant -> (lines of the source to replace, each occurring exactly once;
#             dtype timed; whether the result is still the backward)
VARIANTS: dict[str, tuple[list[tuple[str, str]], torch.dtype, bool]] = {
    "as_built": ([], torch.bfloat16, True),
    "copied_fragments": ([
        ("  for (; t + 1 < n_tiles; t += 2) {\n"
         "    tile_step(t, dzf_a, pf_a, dzf_b, pf_b);\n"
         "    tile_step(t + 1, dzf_b, pf_b, dzf_a, pf_a);\n"
         "  }\n"
         "  if (t < n_tiles) {\n",
         "  for (; t < n_tiles; ++t) {\n"),
    ], torch.bfloat16, True),
    "dkv64": ([("  static constexpr int kN = kDkv ? 32 : 64;\n",
                "  static constexpr int kN = 64;\n")], torch.bfloat16, True),
    "no_overlap": ([("    wgmma_wait<1>();\n", "    wgmma_wait<0>();\n")], torch.bfloat16, True),
    "half_ring": ([("constexpr int kRingBytes = 65536;", "constexpr int kRingBytes = 32768;")],
                  torch.bfloat16, True),
    "terms_only": ([
        ("    start_score_products(s, dp, own0_desc, own1_desc, ring + stage * kStageBytes);\n",
         ""),
        ("    start_gradient_products<kDkv>(acc0, acc1, dz_in, p_in, ring + prev * kStageBytes);\n",
         ""),
    ], torch.bfloat16, False),
    "f32_as_built": ([], torch.float32, True),
    "f32_one_product": ([("constexpr int kTf32Terms = 3;", "constexpr int kTf32Terms = 1;")],
                        torch.float32, False),
    "f32_half_ring": ([("  static constexpr int kStages = 2;  // of each ring",
                        "  static constexpr int kStages = 1;  // of each ring")],
                      torch.float32, True),
    "f32_dq_three_stages": ([("  static constexpr int kStages = 2;  // of each ring",
                              "  static constexpr int kStages = kDkv ? 2 : 3;  // of each ring")],
                            torch.float32, True),
    "f32_no_overlap": ([("    wgmma_wait<1>();  // tile t's scores",
                         "    wgmma_wait<0>();  // tile t's scores")], torch.float32, True),
    "f32_no_promotion": ([("constexpr int kPromoteTiles = 8;",
                           "constexpr int kPromoteTiles = 1 << 30;")], torch.float32, False),
}
# the largest error a variant that is still the backward may show, of max|g|
REL_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}


def cut_source(name: str) -> str:
    """The source with the variant's replacements applied."""
    text = (fa._CSRC / SOURCE).read_text()
    for old, new in VARIANTS[name][0]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} occurs {text.count(old)} times in {SOURCE}")
        text = text.replace(old, new)
    return text


def build_variants(names) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together, each beside a copy of the headers."""
    procs = {}
    for name in names:
        work = fa._BUILD_DIR / "bwd_variants" / name
        work.mkdir(parents=True, exist_ok=True)
        (work / SOURCE).write_text(cut_source(name))
        for header in fa._HEADERS:
            (work / header).write_bytes((fa._CSRC / header).read_bytes())
        out = work / "libflash_attn_bwd.so"
        procs[name] = (out, subprocess.Popen(fa.nvcc_command(work / SOURCE, out),
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {SOURCE} ({name}) failed:\n{err}")
        report, kernel = {}, None
        for ln in err.splitlines():
            if "Compiling entry function" in ln:
                kernel = next((k for k in KERNELS if f"flash_bwd_{k}_kernel" in ln), None)
            elif kernel and ("registers" in ln or "spill" in ln):
                report.setdefault(kernel, []).append(ln.split(":", 1)[-1].strip())
        report["serialized_wgmma"] = sorted(
            k for k in KERNELS
            if any("serialized" in ln and f"flash_bwd_{k}" in ln for ln in err.splitlines()))
        print(json.dumps({"variant": name, "ptxas": report}), flush=True)
        lib = ctypes.CDLL(str(out))
        for entry, argtypes in fa._SOURCES[SOURCE].items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def backward(lib: ctypes.CDLL, which: str, q, k, v, do, lse, delta):
    """The wrappers' launch (``flash_attention_bwd_dq`` / ``_dkv``) on a variant's library."""
    B, S, H, D = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, pairs = fa.backward_workspaces(q, dkv=which == "dkv")
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    if which == "dq":
        out = (torch.empty_like(q),)
        rc = lib.flash_attn_bwd_dq(*ptrs, out[0].data_ptr(), ws.data_ptr(), B, S, H, D,
                                   fa.DTYPE_CODES[q.dtype], fa._scale(D), 1.0 / D ** 0.5, stream)
    else:
        out = (torch.empty_like(k), torch.empty_like(v))
        rc = lib.flash_attn_bwd_dkv(*ptrs, out[0].data_ptr(), out[1].data_ptr(), ws.data_ptr(),
                                    pairs.data_ptr(), B, S, H, D, fa.DTYPE_CODES[q.dtype],
                                    fa._scale(D), fa.LN2, stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def time_variants(libs, names, dtype, shape, reps: int) -> list[dict]:
    """The named variants' dq and dk/dv at one shape in ``dtype``, in turns,
    and the library's backward on the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    o, lse = fa.flash_attention_bound(q, k, v)
    delta = fa.attention_delta(o, g)
    B, S, H, D = shape
    flop = {"dq": 6 * B * H * S * S * D, "dkv": 8 * B * H * S * S * D}
    refs = {"dq": (fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta),),
            "dkv": fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta)}
    rows = []
    for which in ("dq", "dkv"):
        errs = {}
        for name in names:
            outs = backward(libs[name], which, q, k, v, g, lse, delta)
            errs[name] = max(max_abs_err(a, r) / r.float().abs().max().item()
                             for a, r in zip(outs, refs[which]))
            if VARIANTS[name][2] and not errs[name] <= REL_TOL[dtype]:
                raise SystemExit(f"{name}: {which} is {errs[name]} of max|g| from the plain one")
        # in turns, forwards then backwards, so that a drifting clock shows
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(time_ms(
                lambda: backward(libs[name], which, q, k, v, g, lse, delta), "cuda", reps))
        for name in names:
            ms = min(times[name])
            rows.append({"kernel": which, "variant": name, "dtype": str(dtype)[6:],
                         "shape": list(shape), "ms_in_turns": times[name], "ms": ms,
                         "tflops": flop[which] / ms / 1e9, "max_rel_err": errs[name]})
            print(json.dumps(rows[-1]), flush=True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    gt = g.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True),
                         "cuda", reps)
    state = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
                            "power.draw", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    rows.append({"library": "autograd backward of F.scaled_dot_product_attention (dq, dk, dv)",
                 "dtype": str(dtype)[6:], "shape": list(shape), "ms": library_ms,
                 "gpu_state": state})
    print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", type=int, nargs=3, default=[1, 19515, 6], metavar=("B", "S", "H"),
                   help="the bf16 variants' shape")
    p.add_argument("--f32-shape", type=int, nargs=3, default=[1, 5204, 6],
                   metavar=("B", "S", "H"), help="the f32 variants' shape")
    p.add_argument("--variant", action="append", choices=sorted(VARIANTS))
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_stages builds and times CUDA kernels: no CUDA device")
    names = args.variant or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build_variants(names)
    rows = []
    for dtype, shape in ((torch.bfloat16, args.shape), (torch.float32, args.f32_shape)):
        group = [n for n in names if VARIANTS[n][1] == dtype]
        if group:
            rows += time_variants(libs, group, dtype, (*shape, fa.HEAD_DIM), args.reps)
    return rows


if __name__ == "__main__":
    main()
