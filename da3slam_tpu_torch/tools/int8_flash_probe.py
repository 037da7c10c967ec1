"""Int8 attention beside the bound forward (counterpart of the JAX package's
``tools/int8_flash_probe.py``): the ``int8_flash`` kernel, whose two products
are integer products, and the production max-free forward, on the same
random-normal inputs.

    python -m da3slam_tpu_torch.tools.int8_flash_probe [--check]

Two reports: the accuracy of both against f32 softmax attention at S = 2048,
then the time and rate of both at the cross-view shape of a 16-frame SMALL
chunk (S = 16·1301, 6 heads of 64).  Random-normal q and k are the worst case
for an int8 p: the softmax is as diffuse as it gets, so every p is small and
the 1/254 quantization step is felt everywhere.  ``--check`` is the small
validation case instead (S = 1500, 2 heads, ``block_k`` 512, f32 inputs: a
ragged last block), which fails if the error passes 8% of the output's range.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from da3slam_tpu_torch.ops.flash_attention import flash_attention
from da3slam_tpu_torch.ops.int8_flash import int8_flash, int8_flash_reference
from da3slam_tpu_torch.tools import max_abs_err, resolve_device
from da3slam_tpu_torch.utils.profiling import time_ms

S_DEFAULT, H_DEFAULT, D = 16 * (36 * 36 + 5), 6, 64
S_ACCURACY = 2048
BLOCK_K = 3584
CHECK_S, CHECK_H, CHECK_BLOCK_K = 1500, 2, 512
CHECK_REL_TOL = 0.08


def int8_inputs(S: int, H: int, device, dtype=torch.bfloat16, seed: int = 0):
    """The tool's inputs: q, k, v ~ N(0, 1), ``[1, S, H, 64]``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, S, H, D), dtype=np.float32)).to(device, dtype)
            for _ in range(3)]


def softmax_attention(q, k, v) -> torch.Tensor:
    """f32 softmax(q·kᵀ/√D)·v on ``[B, S, H, D]``, one head at a time."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    out = torch.empty_like(qf)
    for b in range(qf.shape[0]):
        for h in range(qf.shape[1]):
            out[b, h] = torch.softmax(qf[b, h] @ kf[b, h].T / D ** 0.5, dim=-1) @ vf[b, h]
    return out.transpose(1, 2)


def accuracy(name: str, out, ref) -> dict:
    err = max_abs_err(out, ref)
    rel = err / ref.abs().max().item()
    print(f"acc {name:6s} max-abs {err:.4e}  rel {rel:.4e}", flush=True)
    return {"tag": f"acc {name}", "softmax_max_abs_err": err, "softmax_rel_err": rel}


def check(device) -> list[dict]:
    q, k, v = int8_inputs(CHECK_S, CHECK_H, device, torch.float32)
    row = accuracy("int8", int8_flash(q, k, v, block_k=CHECK_BLOCK_K), softmax_attention(q, k, v))
    if not row["softmax_rel_err"] < CHECK_REL_TOL:
        raise AssertionError(f"int8 attention error {row['softmax_rel_err']:.4f} above "
                             f"{CHECK_REL_TOL:.0%} of the output's range")
    print("check OK", flush=True)
    return [{**row, "S": CHECK_S, "H": CHECK_H, "block_k": CHECK_BLOCK_K}]


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--check", action="store_true", help="the small validation case only")
    p.add_argument("--S", type=int, default=S_DEFAULT)
    p.add_argument("--H", type=int, default=H_DEFAULT)
    p.add_argument("--block_k", type=int, default=BLOCK_K)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.check:
        return check(device)

    fns = {"int8": lambda a, b, c: int8_flash(a, b, c, block_k=args.block_k),
           "bound": lambda a, b, c: flash_attention(a, b, c, stable=False)}
    q, k, v = int8_inputs(args.S, args.H, device)
    qs, ks, vs = (t[:, :S_ACCURACY].contiguous() for t in (q, k, v))
    ref = softmax_attention(qs, ks, vs)
    rows = [accuracy(name, fn(qs, ks, vs), ref) for name, fn in fns.items()]

    ops = 4.0 * args.H * args.S * args.S * D
    with torch.no_grad():
        for name, fn in fns.items():
            ms = time_ms(lambda: fn(q, k, v), device)
            print(f"time {name:6s} {ms:9.3f} ms  {ops / ms / 1e9:7.2f} TOP/s", flush=True)
            rows.append({"tag": f"time {name}", "S": args.S, "H": args.H, "ms": ms,
                         "tops": ops / ms / 1e9})
    # the int8 kernel against its plain version at the timed shape
    o, o_ref = int8_flash(q, k, v, block_k=args.block_k), \
        int8_flash_reference(q, k, v, block_k=args.block_k)
    rows[-2].update(max_abs_err=max_abs_err(o, o_ref),
                    plain_max_abs=o_ref.float().abs().max().item())
    print(f"int8 max|err| vs plain {rows[-2]['max_abs_err']:.3e}", flush=True)
    return rows


if __name__ == "__main__":
    main()
