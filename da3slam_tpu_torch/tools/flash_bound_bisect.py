"""The steps from the constant-shift ceiling to the production bound forward
(counterpart of the JAX package's ``tools/flash_bound_bisect.py``):

  A  constant shift, no mask                  (= the nomax probe + an lse output)
  B  + the shift as a per-row input m
  C  + the padded keys masked, tested only in the tile that holds them
  D  C with the test on every key of every tile
  E  B with the padding's share subtracted from the denominator instead

    python -m da3slam_tpu_torch.tools.flash_bound_bisect A C E

Keys are padded to a multiple of ``--bk`` (3584, the TPU tool's block), the
padded k and v rows zeros, so that C, D and E compute the same function.
"""

from __future__ import annotations

import argparse

import torch

from da3slam_tpu_torch.ops.flash_probes import (
    BISECT_VARIANTS,
    PROBE_M,
    flash_bisect,
    flash_bisect_reference,
)
from da3slam_tpu_torch.tools import max_abs_err, resolve_device
from da3slam_tpu_torch.tools.flash_nomax_probe import S_DEFAULT, pad_to, probe_inputs, report
from da3slam_tpu_torch.utils.profiling import time_ms


def run(tag: str, S: int, bq: int, bk: int, device, reps: int = 5) -> dict:
    use_m, mask = BISECT_VARIANTS[tag]
    q, k, v = probe_inputs(pad_to(S, bq), pad_to(S, bk), device, seq_k=S)
    m = torch.full(q.shape[:2], PROBE_M, device=device) if use_m else None
    o, lse = flash_bisect(q, k, v, tag, m, seq_k=S)
    o_ref, lse_ref = flash_bisect_reference(q, k, v, tag, m, seq_k=S)
    ms = time_ms(lambda: flash_bisect(q, k, v, tag, m, seq_k=S), device, reps)
    return report(f"{tag} m_ref={use_m} mask={mask}", S, ms, o, o_ref,
                  lse_max_abs_err=max_abs_err(lse, lse_ref), Sq=q.shape[1], Sk=k.shape[1])


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("variants", nargs="+", choices=sorted(BISECT_VARIANTS))
    p.add_argument("--S", type=int, default=S_DEFAULT)
    p.add_argument("--bq", type=int, default=1024)
    p.add_argument("--bk", type=int, default=3584)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    return [run(tag, args.S, args.bq, args.bk, device) for tag in args.variants]


if __name__ == "__main__":
    main()
