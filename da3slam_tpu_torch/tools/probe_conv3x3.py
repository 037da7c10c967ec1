"""The 3×3 conv kernel (``ops/conv3x3.py``) at the DPT head's shapes, beside
``F.conv2d`` (counterpart of the JAX package's ``tools/probe_conv3x3.py``).

    python -m da3slam_tpu_torch.tools.probe_conv3x3 [head2-small head2-large head1-large]

Per shape: the kernel's time and rate (2·9·C·COUT·H·W·N FLOP), the time of
one ``F.conv2d`` call on the same operands (channels-last, same dtype: the
library's yardstick, which the port never calls on this path), and the max
abs error against ``conv3x3_reference``.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from da3slam_tpu_torch.ops.conv3x3 import conv3x3_fused, conv3x3_reference
from da3slam_tpu_torch.tools import max_abs_err, resolve_device
from da3slam_tpu_torch.utils.profiling import time_ms

SHAPES = [  # (label, N, H, W, C, COUT)
    ("head2-small", 16, 504, 504, 64, 32),
    ("head2-large", 16, 504, 504, 128, 32),
    ("head1-large", 16, 288, 288, 256, 128),
]


def library_conv(kernel: torch.Tensor, bias: torch.Tensor, x: torch.Tensor):
    """``F.conv2d`` on a channels-last view of NHWC ``x``, in x's dtype:
    returns the call to time."""
    w = kernel.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b = bias.to(x.dtype)
    xc = x.permute(0, 3, 1, 2)  # NCHW strides over NHWC memory = channels-last
    return lambda: F.conv2d(xc, w, b, padding=1)


def conv_inputs(N, H, W, C, COUT, device, dtype=torch.bfloat16, seed: int = 0):
    """x ~ N(0, 1) in ``dtype`` (NHWC) and an f32 HWIO kernel ~ 0.1·N(0, 1),
    drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(N, H, W, C, generator=gen, device=device).to(dtype)
    k = torch.randn(3, 3, C, COUT, generator=gen, device=device) * 0.1
    return x, k


def run(label, N, H, W, C, COUT, device, dtype=torch.bfloat16, reps=5) -> dict:
    x, k = conv_inputs(N, H, W, C, COUT, device, dtype)
    b = torch.zeros(COUT, device=device)
    out = conv3x3_fused(k, b, x)
    ref = conv3x3_reference(k, b, x)
    err = max_abs_err(out, ref)
    ms = time_ms(lambda: conv3x3_fused(k, b, x), device, reps)
    lib = library_conv(k, b, x)
    lib_err = max_abs_err(lib().permute(0, 2, 3, 1), out)
    library_ms = time_ms(lib, device, reps)
    flops = 2.0 * 9 * C * COUT * H * W * N
    row = {"label": label, "shape": [N, H, W, C, COUT], "dtype": str(dtype).replace("torch.", ""),
           "ms": ms, "tflops": flops / ms / 1e9, "library_ms": library_ms,
           "max_abs_err": err, "plain_max_abs": ref.float().abs().max().item(),
           "library_max_abs_diff": lib_err}
    print(f"{label:12s} kernel {ms:8.3f} ms ({row['tflops']:6.2f} TFLOP/s)  "
          f"F.conv2d {library_ms:8.3f} ms  max|err| vs plain {err:.3e}", flush=True)
    return row


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("labels", nargs="*", help=f"shapes to run: {[s[0] for s in SHAPES]} (default all)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    unknown = set(args.labels) - {s[0] for s in SHAPES}
    if unknown:
        raise SystemExit(f"unknown shape labels {sorted(unknown)}")
    return [run(*spec, device=device) for spec in SHAPES
            if not args.labels or spec[0] in args.labels]


if __name__ == "__main__":
    main()
