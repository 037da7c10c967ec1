"""What each step of the bf16 forward's design bought: ``flash_attn_fwd.cu``
built at four stages of it (its ``FLASH_FWD_*`` macros) and timed in turns at
the cross-view shape, beside the library's call.

  wgmma      both products on the tensor cores; a ring of two stages, too short
             to load ahead; one consumer warpgroup (64 query rows a CTA);
             softmax and products one after the other
  +ring      three stages: the next tile loads while this one is multiplied
  +128rows   two consumer warpgroups share every K/V stage
  +overlap   the softmax of tile j beside P.V of tile j-1: the kernel as built

    python -m da3slam_tpu_torch.tools.flash_fwd_stages
    python -m da3slam_tpu_torch.tools.flash_fwd_stages --shape 15 1301 6 --stage +overlap

``--parts`` times three cut-down copies of the kernel as built beside it, to
see what the whole is made of (their outputs are wrong by construction and are
not checked): the products without the softmax, the softmax without the
products, and everything but the K/V loads after the ring's first fill.

Each variant is held to the plain version before it is timed.  The last line
is the host's own cost of one call of the production wrapper (allocation, two
tensor maps, two launches), taken on a one-tile input with no wait for the
device.  CUDA only: the variants are builds of the kernel.
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


def build_parts() -> dict[str, ctypes.CDLL]:
    """The source with each of PARTS' cuts applied, built beside the headers."""
    text = (fa._CSRC / SOURCE).read_text()
    libs = {}
    for name, cuts in PARTS.items():
        work = fa._BUILD_DIR / "parts" / name
        work.mkdir(parents=True, exist_ok=True)
        cut = text
        for old, new in cuts:
            if cut.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} occurs {cut.count(old)} times in {SOURCE}")
            cut = cut.replace(old, new)
        (work / SOURCE).write_text(cut)
        for header in fa._HEADERS:
            (work / header).write_bytes((fa._CSRC / header).read_bytes())
        out = work / "libflash_attn_fwd.so"
        subprocess.run(fa.nvcc_command(work / SOURCE, out), check=True, capture_output=True)
        libs[name] = bind(out)
    return libs


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
    ptrs = [t.data_ptr() for t in (q, k, v, o, lse)]
    if not stable:
        ptrs.append(torch.empty(B * H, dtype=torch.float32, device=q.device).data_ptr())
    entry = lib.flash_attn_stable_fwd if stable else lib.flash_attn_bound_fwd
    rc = entry(*ptrs, B, S, H, D, fa.DTYPE_CODES[q.dtype], fa._scale(D),
               torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return o, lse


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", type=int, nargs=3, default=[1, 19515, 6], metavar=("B", "S", "H"))
    p.add_argument("--stage", action="append", choices=sorted(STAGES))
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--parts", action="store_true", help="also time the kernel's cut-down copies")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_stages builds and times CUDA kernels: no CUDA device")
    names = args.stage or list(STAGES)
    libs = build_variants(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (*args.shape, fa.HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
    B, S, H, D = shape
    flop = 4 * B * H * S * S * D
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows = []
    for stable, ref in ((False, fa.flash_attention_bound_reference),
                        (True, fa.flash_attention_stable_reference)):
        o_ref, lse_ref = ref(q, k, v)
        errs = {}
        for name in names:
            o, lse = forward(libs[name], q, k, v, stable)
            errs[name] = (max_abs_err(o, o_ref), max_abs_err(lse, lse_ref))
        # in turns, forwards then backwards, so that a drifting clock shows
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(time_ms(lambda: forward(libs[name], q, k, v, stable), "cuda",
                                       args.reps))
        for name in names:
            ms = min(times[name])
            rows.append({"mode": "stable" if stable else "bound", "stage": name,
                         "shape": list(shape), "ms_in_turns": times[name], "ms": ms,
                         "tflops": flop / ms / 1e9, "max_abs_err": errs[name][0],
                         "lse_max_abs_err": errs[name][1],
                         "plain_max_abs": o_ref.float().abs().max().item()})
            print(json.dumps(rows[-1]), flush=True)
    if args.parts:
        for name, lib in build_parts().items():
            for stable in (False, True):
                ms = time_ms(lambda: forward(lib, q, k, v, stable), "cuda", args.reps)
                rows.append({"mode": "stable" if stable else "bound", "part": name,
                             "shape": list(shape), "ms": ms})
                print(json.dumps(rows[-1]), flush=True)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
                         "cuda", args.reps)
    rows.append({"library": "F.scaled_dot_product_attention", "shape": list(shape),
                 "ms": library_ms, "tflops": flop / library_ms / 1e9})
    print(json.dumps(rows[-1]), flush=True)
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
