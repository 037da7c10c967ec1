"""What the bf16 backward kernels' time is made of: ``flash_attn_bwd.cu`` as
built and in changed copies, timed in turns at the SLAM cross-view shape
beside the library's backward.

  as_built          the source as the library builds it
  copied_fragments  one set of p/dz fragments plus a copy at the end of every
                    tile step, where the kernel alternates two sets: ptxas
                    merges the copy's registers and serializes the wgmmas
  dkv64             dk/dv with 64-row tiles like dq: its accumulators spill
  no_overlap        the exp2 of tile j only after the gradient products of
                    tile j-1 have finished (wait_group 0 where the kernel has 1)
  half_ring         a ring of half the size (2 stages for dq, 4 for dk/dv)
  terms_only        p and dz without the products (wrong by construction)

    python -m da3slam_tpu_torch.tools.flash_bwd_stages
    python -m da3slam_tpu_torch.tools.flash_bwd_stages --shape 1 5204 6 --variant as_built

Each variant prints what ptxas said of its two kernels (registers, spills,
serialized wgmma) and, unless it is wrong by construction, is held to the plain
backward under ``2^-6 * max|g|`` before it is timed.  CUDA only: the variants
are builds of the kernels.
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
# variant -> (lines of the source to replace, each occurring exactly once;
#             whether the result is still the backward)
VARIANTS: dict[str, tuple[list[tuple[str, str]], bool]] = {
    "as_built": ([], True),
    "copied_fragments": ([
        ("  for (; t + 1 < n_tiles; t += 2) {\n"
         "    tile_step(t, dzf_a, pf_a, dzf_b, pf_b);\n"
         "    tile_step(t + 1, dzf_b, pf_b, dzf_a, pf_a);\n"
         "  }\n"
         "  if (t < n_tiles) {\n",
         "  for (; t < n_tiles; ++t) {\n"),
    ], True),
    "dkv64": ([("  static constexpr int kN = kDkv ? 32 : 64;\n",
                "  static constexpr int kN = 64;\n")], True),
    "no_overlap": ([("    wgmma_wait<1>();\n", "    wgmma_wait<0>();\n")], True),
    "half_ring": ([("constexpr int kRingBytes = 65536;", "constexpr int kRingBytes = 32768;")],
                  True),
    "terms_only": ([
        ("    start_score_products(s, dp, own0_desc, own1_desc, ring + stage * kStageBytes);\n",
         ""),
        ("    start_gradient_products<kDkv>(acc0, acc1, dz_in, p_in, ring + prev * kStageBytes);\n",
         ""),
    ], False),
}


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
                kernel = next((k for k in ("dq_wgmma", "dkv_wgmma") if k in ln), None)
            elif kernel and ("registers" in ln or "spill" in ln):
                report.setdefault(kernel, []).append(ln.split(":", 1)[-1].strip())
        report["serialized_wgmma"] = sorted(
            k for k in ("dq_wgmma", "dkv_wgmma")
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
    qs = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    if which == "dq":
        out = (torch.empty_like(q),)
        rc = lib.flash_attn_bwd_dq(*ptrs, out[0].data_ptr(), qs.data_ptr(), B, S, H, D,
                                   fa.DTYPE_CODES[q.dtype], fa._scale(D), 1.0 / D ** 0.5, stream)
    else:
        out = (torch.empty_like(k), torch.empty_like(v))
        pairs = torch.empty(B * H, -(-S // fa.BWD_TILE) * fa.BWD_TILE, 2, dtype=torch.float32,
                            device=q.device)
        rc = lib.flash_attn_bwd_dkv(*ptrs, out[0].data_ptr(), out[1].data_ptr(), qs.data_ptr(),
                                    pairs.data_ptr(), B, S, H, D, fa.DTYPE_CODES[q.dtype],
                                    fa._scale(D), fa.LN2, stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", type=int, nargs=3, default=[1, 19515, 6], metavar=("B", "S", "H"))
    p.add_argument("--variant", action="append", choices=sorted(VARIANTS))
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_stages builds and times CUDA kernels: no CUDA device")
    names = args.variant or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build_variants(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (*args.shape, fa.HEAD_DIM)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(4))
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
            if not VARIANTS[name][1]:
                continue
            outs = backward(libs[name], which, q, k, v, g, lse, delta)
            errs[name] = max(max_abs_err(a, r) / r.float().abs().max().item()
                             for a, r in zip(outs, refs[which]))
            if not errs[name] <= 2.0 ** -6:
                raise SystemExit(f"{name}: {which} is {errs[name]} of max|g| from the plain one")
        # in turns, forwards then backwards, so that a drifting clock shows
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(time_ms(
                lambda: backward(libs[name], which, q, k, v, g, lse, delta), "cuda", args.reps))
        for name in names:
            ms = min(times[name])
            rows.append({"kernel": which, "variant": name, "shape": list(shape),
                         "ms_in_turns": times[name], "ms": ms,
                         "tflops": flop[which] / ms / 1e9, "max_rel_err": errs.get(name)})
            print(json.dumps(rows[-1]), flush=True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    gt = g.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True),
                         "cuda", args.reps)
    rows.append({"library": "autograd backward of F.scaled_dot_product_attention (dq, dk, dv)",
                 "shape": list(shape), "ms": library_ms})
    print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
