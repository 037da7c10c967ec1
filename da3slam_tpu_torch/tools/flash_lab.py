"""Online-softmax forward experiments (counterpart of the JAX package's
``tools/flash_lab.py``):

  old  every key tested against seq_k, the denominator summed from the f32 p
  new  only the tile past seq_k tested, the denominator from the rounded p
  qs   new with the scale folded into q (rounded to bf16) instead of the logits

    python -m da3slam_tpu_torch.tools.flash_lab [S]

q, k, v are ``[6, Sp, 64]`` bf16 with ``Sp`` = S rounded up to ``--pad``
(2048); keys past S are masked.  ``--nh`` is the TPU tool's heads per call:
it must divide BH and changes nothing here (the kernel walks one head a
thread block).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from da3slam_tpu_torch.ops.flash_probes import LAB_VARIANTS, flash_lab, flash_lab_reference
from da3slam_tpu_torch.tools import resolve_device
from da3slam_tpu_torch.tools.flash_nomax_probe import BH, D, pad_to, report
from da3slam_tpu_torch.utils.profiling import time_ms


def lab_inputs(Sp: int, device, seed: int = 0):
    """q, k, v ~ N(0, 1), ``[BH, Sp, D]`` bf16: attention-scale logits, which
    the running max is there for."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((BH, Sp, D), dtype=np.float32))
            .to(device, torch.bfloat16) for _ in range(3)]


def run(variant: str, S: int, pad: int, nh: int, device, reps: int = 5) -> dict:
    Sp = pad_to(S, pad)
    q, k, v = lab_inputs(Sp, device)
    o = flash_lab(q, k, v, variant, seq_k=S, nh=nh)
    o_ref = flash_lab_reference(q, k, v, variant, seq_k=S)
    ms = time_ms(lambda: flash_lab(q, k, v, variant, seq_k=S, nh=nh), device, reps)
    return report(f"{variant:5s} nh={nh}", S, ms, o, o_ref, variant=variant, nh=nh, Sp=Sp)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("S", nargs="?", type=int, default=20480)
    p.add_argument("--variants", nargs="+", choices=LAB_VARIANTS, default=list(LAB_VARIANTS))
    p.add_argument("--pad", type=int, default=2048)
    p.add_argument("--nh", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(f"BH={BH} S={args.S} D={D}; {4.0 * BH * args.S ** 2 * D / 1e9:.0f} GFLOP a call")
    return [run(variant, args.S, args.pad, args.nh, device) for variant in args.variants]


if __name__ == "__main__":
    main()
