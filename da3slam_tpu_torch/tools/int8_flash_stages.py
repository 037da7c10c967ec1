"""What the int8 flash kernel's time is made of: ``int8_flash_fwd.cu`` built as
it stands and in cut-down or changed copies (``-D`` defines on a copy of the
source; the library's own build sets none), each launched on the same
quantized inputs and timed in turns at the tool's shape, beside the wrapper's
whole call (``int8_flash``), its quantization and V layout, and the bf16
bound forward on the same q, k, v.

  as_built       the source as the library builds it: three consumer
                 warpgroups (192 query rows, 512 threads) on 64-key tiles
  products_only  both passes' products and the ring, no float work: p8 is the
                 score's low byte, no row max (wrong results)
  no_pass1       pass 2 alone: no max pass, m from the carry (wrong results)
  no_products    the float work and the ring without the products: scores
                 are whatever the registers hold (wrong results)
  exact_i2f      float(s) as as_float(s + 0x4B400000) - 12582912 (an integer
                 and a float add) in place of the native conversion
  native_f2i     trunc(p) by the native conversion (F2I) in place of the
                 exact form round_toward_zero(x + 2^23)
  ring_64k       a ring of 64 KB in place of 128
  two_wg         two consumer warpgroups (384 threads, 168 registers)
  four_wg        four consumer warpgroups and a producer warp (544 threads,
                 at most 120 registers)

    python -m da3slam_tpu_torch.tools.int8_flash_stages [--variant as_built ...]
        [--S 20816] [--H 6] [--block_k 3584]

The variants in ``EXACT`` compute the function (their errors against the
plain version are held to 2^-6·max|O|); the others' errors are printed and
not held.  For each build ptxas's registers, spills and serialization
warnings, and the SASS's count of the instructions a score costs, are
printed.  CUDA only: the variants are builds of the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

from da3slam_tpu_torch.ops import flash_attention as fa
from da3slam_tpu_torch.ops import int8_flash as i8
from da3slam_tpu_torch.tools import max_abs_err
from da3slam_tpu_torch.tools.int8_flash_probe import BLOCK_K, H_DEFAULT, S_DEFAULT, int8_inputs
from da3slam_tpu_torch.utils.profiling import time_ms

SOURCE = "int8_flash_fwd.cu"
# variant -> -D defines
VARIANTS: dict[str, tuple[str, ...]] = {
    "as_built": (),
    "products_only": ("INT8_FLASH_PRODUCTS_ONLY",),
    "no_pass1": ("INT8_FLASH_NO_PASS1",),
    "no_products": ("INT8_FLASH_NO_PRODUCTS",),
    "exact_i2f": ("INT8_FLASH_EXACT_I2F",),
    "native_f2i": ("INT8_FLASH_NATIVE_F2I",),
    "ring_64k": ("INT8_FLASH_RING_BYTES=65536",),
    "two_wg": ("INT8_FLASH_CONSUMERS=2",),
    "four_wg": ("INT8_FLASH_CONSUMERS=4", "INT8_FLASH_PRODUCER_WARP"),
}
# the variants that compute the function
EXACT = ("as_built", "exact_i2f", "native_f2i", "ring_64k", "two_wg", "four_wg")
# SASS opcodes a score's work is made of
OPCODES = ("IGMMA", "MUFU.EX2", "I2F", "I2FP", "F2I", "F2IP", "FADD", "FMUL", "FFMA", "IADD3",
           "VIMNMX", "IMNMX", "PRMT", "IDP", "SHFL")


def sass_counts(library: Path) -> dict[str, int]:
    """Static count of each of ``OPCODES`` in the kernel's SASS."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", sass)
    return {op: sum(1 for o in ops if o == op or o.startswith(op + ".")) for op in OPCODES}


def build(names) -> dict[str, ctypes.CDLL]:
    """Each variant built from a copy of the source beside the headers, one nvcc
    a variant, all started together; ptxas's report and the SASS counts printed."""
    procs = {}
    for name in names:
        work = fa._BUILD_DIR / "int8_flash_stages" / name
        work.mkdir(parents=True, exist_ok=True)
        (work / SOURCE).write_bytes((fa._CSRC / SOURCE).read_bytes())
        for header in fa._HEADERS:
            (work / header).write_bytes((fa._CSRC / header).read_bytes())
        out = work / "libint8_flash_fwd.so"
        procs[name] = (out, subprocess.Popen(fa.nvcc_command(work / SOURCE, out, VARIANTS[name]),
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {SOURCE} ({name}) failed:\n{err}")
        report = [ln.split(":", 1)[-1].strip() for ln in err.splitlines()
                  if "registers" in ln or "spill" in ln or re.search(r"C75\d\d", ln)]
        print(json.dumps({"variant": name, "defines": VARIANTS[name], "ptxas": report,
                          "sass": sass_counts(out)}), flush=True)
        lib = ctypes.CDLL(str(out))
        fn = lib.int8_flash_fwd
        fn.argtypes = fa._SOURCES[SOURCE]["int8_flash_fwd"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, q8, k8, vt, sq, sk, out, S: int, bk: int) -> None:
    BH, Sk, _ = k8.shape
    rc = lib.int8_flash_fwd(q8.data_ptr(), k8.data_ptr(), vt.data_ptr(), sq.data_ptr(),
                            sk.data_ptr(), out.data_ptr(), BH, S, Sk, bk,
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variant", action="append", choices=sorted(VARIANTS))
    p.add_argument("--S", type=int, default=S_DEFAULT)
    p.add_argument("--H", type=int, default=H_DEFAULT)
    p.add_argument("--block_k", type=int, default=BLOCK_K)
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_flash_stages builds and times CUDA kernels: no CUDA device")
    names = args.variant or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build(names)
    S, H = args.S, args.H
    q, k, v = int8_inputs(S, H, "cuda")
    q8, k8, v8, sq, sk, _, bk = i8.quantize_qkv(q, k, v, args.block_k)
    vt = i8.value_layout(v8)
    ref = i8.int8_attention_reference(q8, k8, v8, sq, sk, S, bk)
    tol = 2.0 ** -6 * ref.float().abs().max().item()
    out = torch.empty_like(ref)
    rows, errs = [], {}
    for name in names:
        out.zero_()
        launch(libs[name], q8, k8, vt, sq, sk, out, S, bk)
        errs[name] = max_abs_err(out, ref)
        if name in EXACT and not errs[name] <= tol:
            raise AssertionError(f"{name} disagrees with the plain version: {errs[name]} > {tol}")
    times = {name: [] for name in names}
    for name in names + names[::-1]:  # in turns: a drifting clock shows
        times[name].append(time_ms(lambda: launch(libs[name], q8, k8, vt, sq, sk, out, S, bk),
                                   "cuda", args.reps))
    ops = 4.0 * H * S * S * 64
    for name in names:
        ms = min(times[name])
        rows.append({"variant": name, "S": S, "H": H, "block_k": bk, "ms_in_turns": times[name],
                     "ms": ms, "tops": ops / ms / 1e9, "max_abs_err": errs[name], "tol": tol})
        print(json.dumps(rows[-1]), flush=True)
    rows.append({
        "S": S, "H": H, "block_k": bk,
        "wrapper_ms": time_ms(lambda: i8.int8_flash(q, k, v, block_k=args.block_k), "cuda",
                              args.reps),
        "quantize_ms": time_ms(lambda: i8.quantize_qkv(q, k, v, args.block_k), "cuda", args.reps),
        "layout_ms": time_ms(lambda: i8.value_layout(v8), "cuda", args.reps),
        "bf16_bound_forward_ms": time_ms(lambda: fa.flash_attention(q, k, v, stable=False),
                                         "cuda", args.reps),
        "exp2_floor_ms": H * S * S / (989e12 / 256) * 1e3, "ops_bound_ms": ops / 1979e12 * 1e3})
    print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
