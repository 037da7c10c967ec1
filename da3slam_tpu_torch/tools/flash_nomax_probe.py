"""The ceiling of a max-free flash forward (counterpart of the JAX package's
``tools/flash_nomax_probe.py``): the constant-shift kernel ``flash_nomax``
at the cross-view shape of a 16-frame SMALL chunk.

    python -m da3slam_tpu_torch.tools.flash_nomax_probe [bq,bk ...]

A ``bq,bk`` pair pads the queries and keys as the TPU tool's blocks did
(``Sq = ⌈S/bq⌉·bq``, ``Sk = ⌈S/bk⌉·bk``, every padded key counted): that is
all the blocks change here.  With a constant shift the values are not an
attention output; the time is representative and the error is against the
plain version of the same function.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from da3slam_tpu_torch.ops.flash_probes import flash_nomax, flash_nomax_reference
from da3slam_tpu_torch.tools import max_abs_err, resolve_device
from da3slam_tpu_torch.utils.profiling import time_ms

S_DEFAULT, BH, D = 16 * (36 * 36 + 5), 6, 64
BLOCKS_DEFAULT = [(1024, 2048), (1024, 3584), (1024, 5376)]


def probe_inputs(Sq: int, Sk: int, device, dtype=torch.bfloat16, seed: int = 0,
                 seq_k: int | None = None):
    """The tools' inputs: q ~ 0.18·N(0, 1) (logits of spread ~1.4 under the
    constant shift 15), k, v ~ N(0, 1); with ``seq_k``, the k and v rows past
    it (the padding) zeros."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((BH, Sq, D), dtype=np.float32) * np.float32(0.18))
    k, v = (rng.standard_normal((BH, Sk, D), dtype=np.float32) for _ in range(2))
    if seq_k is not None:
        k[:, seq_k:] = 0
        v[:, seq_k:] = 0
    return [torch.from_numpy(a).to(device, dtype) for a in (q, k, v)]


def pad_to(S: int, block: int) -> int:
    return -(-S // block) * block


def report(tag: str, S: int, ms: float, o, o_ref, **fields) -> dict:
    """Print one case's line (the rate counts 4·BH·S²·D operations) and
    return it with the plain output's magnitude, which scales the error."""
    tf = 4.0 * BH * S * S * D / ms / 1e9
    err = max_abs_err(o, o_ref)
    print(f"{tag}: {ms:.3f} ms  {tf:.2f} TFLOP/s  max|err| vs plain {err:.3e}", flush=True)
    return {"tag": tag, "S": S, "ms": ms, "tflops": tf, "max_abs_err": err,
            "plain_max_abs": o_ref.float().abs().max().item(), **fields}


def run(S: int, bq: int, bk: int, device, reps: int = 5) -> dict:
    q, k, v = probe_inputs(pad_to(S, bq), pad_to(S, bk), device)
    o, o_ref = flash_nomax(q, k, v), flash_nomax_reference(q, k, v)
    ms = time_ms(lambda: flash_nomax(q, k, v), device, reps)
    return report(f"nomax bq={bq} bk={bk}", S, ms, o, o_ref, Sq=q.shape[1], Sk=k.shape[1])


def parse_blocks(text: str) -> tuple[int, int]:
    bq, bk = (int(x) for x in text.split(","))
    return bq, bk


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("blocks", nargs="*", type=parse_blocks, help="bq,bk pairs (padding only)")
    p.add_argument("--S", type=int, default=S_DEFAULT)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    return [run(args.S, bq, bk, device) for bq, bk in (args.blocks or BLOCKS_DEFAULT)]


if __name__ == "__main__":
    main()
