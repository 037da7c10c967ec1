"""What the bf16 3×3 conv kernel's time is made of: ``conv3x3.cu`` built as
it stands and in cut-down copies, each launched on the same packed weights
and timed in turns at the DPT head's shapes, beside ``conv3x3_fused`` (the
wrapper's call: the launch on the weights it packed at its first call), the
packing itself (``pack_weights``) and ``F.conv2d``.

  as_built       the source as the library builds it
  no_products    the loads, barriers and epilogue without the wgmmas: the
                 memory path alone
  first_fill     each ring slot loaded once, then only handed on: the products
                 and the epilogue without the memory traffic
  unrolled_taps  the nine taps of a chunk unrolled in the consumers' loop
  no_column_shift  every tap reads the view of its row's dw = 0 tap: views
                 that start on a swizzle atom only (wrong results)
  no_epilogue    no stores (skipped by a test the compiler cannot fold, so
                 the products stay): what the epilogue costs the consumers
  wait_two_taps  two taps of products in flight behind the one issued, not one
  no_bias        the epilogue without its bias reads (wrong results)
  stores_in_l2   each CTA stores every unit into one region of its own, which
                 stays in L2: the epilogue without its DRAM writes (wrong
                 results)

    python -m da3slam_tpu_torch.tools.conv3x3_stages [--shape head2-small ...]
        [--variant as_built ...]

``as_built``, ``unrolled_taps`` and ``wait_two_taps`` compute the
convolution; the others' errors against the plain version are printed and not
held.  CUDA only: the variants are builds
of the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from da3slam_tpu_torch.ops import conv3x3 as cv
from da3slam_tpu_torch.ops import flash_attention as fa
from da3slam_tpu_torch.tools import max_abs_err
from da3slam_tpu_torch.tools.probe_conv3x3 import SHAPES, conv_inputs, library_conv
from da3slam_tpu_torch.utils.profiling import time_ms

SOURCE = "conv3x3.cu"
_PRODUCT = ("            wgmma_ss(acc[i], view_desc<kInW>(tile + pix * kRowBytes + ks * 32),\n"
            "                     w_desc + ks * hopper::kDescKMajorStep);\n")
_IN_LOAD = ("          hopper::mbar_arrive_expect_tx(in_full + s * 8, kBoxBytes);\n"
            "          hopper::tma_load_4d(in_ring + s * kInBytes, &x_map, in_full + s * 8, "
            "c * kChunk,\n                              t.w0 - 1, t.h0 - 1, t.n);\n")
_W_LOAD = ("          hopper::mbar_arrive_expect_tx(w_full + ws * 8, kWBytes);\n"
           "          hopper::bulk_load_1d(w_ring + ws * kWBytes, wsrc + tap * kN * kChunk, "
           "kWBytes,\n                               w_full + ws * 8);\n")


def _first_fill(load: str, stages: str, bar: str) -> tuple[str, str]:
    """A ring's load only while the ring fills; afterwards a plain arrival."""
    return load, (f"          if (fill < {stages}) {{\n{load}          }} else {{\n"
                  f"            hopper::mbar_arrive({bar});\n          }}\n")


# variant -> lines of the source to replace (old, new), each occurring once
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "as_built": [],
    "no_products": [(_PRODUCT, "")],
    "first_fill": [_first_fill(_IN_LOAD, "kInStages", "in_full + s * 8"),
                   _first_fill(_W_LOAD, "kWStages", "w_full + ws * 8")],
    "unrolled_taps": [("#pragma unroll 1\n      for (int tap = 0; tap < 9; ++tap) {",
                       "#pragma unroll\n      for (int tap = 0; tap < 9; ++tap) {")],
    "no_column_shift": [("        const int shift = (tap / 3) * kInW + tap % 3;\n",
                         "        const int shift = (tap / 3) * kInW;\n")],
    "no_epilogue": [("        if (h >= H || w >= W) continue;\n",
                     "          if (relu != 12345) continue;  // never stores, keeps the products\n")],
    "no_bias": [("          float y0 = acc[i][4 * j + 2 * r] + bias_s[co];\n"
                 "          float y1 = acc[i][4 * j + 2 * r + 1] + bias_s[co + 1];\n",
                 "          float y0 = acc[i][4 * j + 2 * r];\n"
                 "          float y1 = acc[i][4 * j + 2 * r + 1];\n")],
    "stores_in_l2": [("        __nv_bfloat16* orow = out + ((static_cast<size_t>(t.n) * H + h) * W + w) "
                      "* COUT;\n",
                      "        __nv_bfloat16* orow = out + (static_cast<size_t>(blockIdx.x) * kPH * kPW"
                      " + (h - t.h0) * kPW + (w - t.w0)) * COUT;\n")],
    "wait_two_taps": [
        ("        hopper::wgmma_wait<1>();\n        if (prev_ws >= 0 && lane == 0) "
         "hopper::mbar_arrive(w_empty + prev_ws * 8);\n        prev_ws = ws;\n",
         "        hopper::wgmma_wait<2>();\n        if (prev2_ws >= 0 && lane == 0) "
         "hopper::mbar_arrive(w_empty + prev2_ws * 8);\n        prev2_ws = prev_ws;\n"
         "        prev_ws = ws;\n"),
        ("      int prev_ws = -1;\n", "      int prev_ws = -1, prev2_ws = -1;\n"),
        ("        hopper::mbar_arrive(w_empty + prev_ws * 8);\n        hopper::mbar_arrive(in_empty",
         "        hopper::mbar_arrive(w_empty + prev_ws * 8);\n"
         "        if (prev2_ws >= 0) hopper::mbar_arrive(w_empty + prev2_ws * 8);\n"
         "        hopper::mbar_arrive(in_empty")],
}


def cut_source(cuts) -> str:
    text = (fa._CSRC / SOURCE).read_text()
    for old, new in cuts:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} occurs {text.count(old)} times in {SOURCE}")
        text = text.replace(old, new)
    return text


def build(names) -> dict[str, ctypes.CDLL]:
    """Each variant built beside a copy of the headers, one nvcc a variant, all
    started together; ptxas's report of the wgmma kernels printed."""
    procs = {}
    for name in names:
        work = fa._BUILD_DIR / "conv3x3_stages" / name
        work.mkdir(parents=True, exist_ok=True)
        (work / SOURCE).write_text(cut_source(VARIANTS[name]))
        for header in fa._HEADERS:
            (work / header).write_bytes((fa._CSRC / header).read_bytes())
        out = work / "libconv3x3.so"
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
                kernel = ("wgmma_n128" if "wgmma_kernelILi128" in ln else
                          "wgmma_n32" if "wgmma_kernelILi32" in ln else None)
            elif kernel and ("registers" in ln or "spill" in ln):
                report.setdefault(kernel, []).append(ln.split(":", 1)[-1].strip())
        report["warnings"] = [ln.strip() for ln in err.splitlines() if "warning" in ln.lower()]
        print(json.dumps({"variant": name, "ptxas": report}), flush=True)
        lib = ctypes.CDLL(str(out))
        fn = lib.conv3x3_wgmma_fwd
        fn.argtypes = fa._SOURCES[SOURCE]["conv3x3_wgmma_fwd"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, x, w, b, out, n_tile: int) -> None:
    N, H, W, C = x.shape
    rc = lib.conv3x3_wgmma_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), N, H,
                               W, C, out.shape[-1], n_tile, 0,
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", action="append", choices=[s[0] for s in SHAPES])
    p.add_argument("--variant", action="append", choices=sorted(VARIANTS))
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv3x3_stages builds and times CUDA kernels: no CUDA device")
    names = args.variant or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build(names)
    rows = []
    for label, N, H, W, C, COUT in SHAPES:
        if args.shape and label not in args.shape:
            continue
        x, k = conv_inputs(N, H, W, C, COUT, "cuda", seed=0)
        b = torch.zeros(COUT, device="cuda")
        n_tile = cv.strip_width(COUT)
        w = cv.pack_weights(k, n_tile)
        ref = cv.conv3x3_reference(k, b, x)
        out = torch.empty_like(ref)
        errs = {}
        for name in names:
            out.zero_()
            launch(libs[name], x, w, b, out, n_tile)
            errs[name] = max_abs_err(out, ref)
        times = {name: [] for name in names}
        for name in names + names[::-1]:  # in turns: a drifting clock shows
            times[name].append(time_ms(lambda: launch(libs[name], x, w, b, out, n_tile), "cuda",
                                       args.reps))
        flop = 2.0 * 9 * C * COUT * H * W * N
        for name in names:
            ms = min(times[name])
            rows.append({"shape": label, "variant": name, "ms_in_turns": times[name], "ms": ms,
                         "tflops": flop / ms / 1e9, "max_abs_err": errs[name],
                         "plain_max_abs": ref.float().abs().max().item()})
            print(json.dumps(rows[-1]), flush=True)
        rows.append({"shape": label,
                     "wrapper_ms": time_ms(lambda: cv.conv3x3_fused(k, b, x), "cuda", args.reps),
                     "pack_weights_ms": time_ms(lambda: cv.pack_weights(k, n_tile), "cuda",
                                                args.reps),
                     "library_ms": time_ms(library_conv(k, b, x), "cuda", args.reps)})
        print(json.dumps(rows[-1]), flush=True)
        del x, ref, out
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
