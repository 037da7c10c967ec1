"""One-command parity check against reference golden outputs (counterpart of
``da3slam_tpu/cli/parity.py``).

    python -m da3slam_tpu_torch.cli.parity [--parity_dir DIR]
    python -m da3slam_tpu_torch.cli.parity --checkpoint CKPT --golden G1.npz [G2.npz ...]

The parity directory's layout and the golden (mini_npz) format are in
``da3slam_tpu_torch/utils/parity.py``.  Exit code 0: parity within the
thresholds on every golden file; 1: any failure; 2: no parity data found.
``--device`` (default ``cuda``) is where the model runs; without CUDA a
``cuda`` run is refused, with no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parity_dir", default=None,
                    help="directory with checkpoint/ + golden/*.npz "
                         "(default: $DA3_PARITY_DIR or parity_data/ at the repository's root)")
    ap.add_argument("--checkpoint", default=None, help="checkpoint dir override")
    ap.add_argument("--golden", nargs="*", default=None, help="golden npz files")
    ap.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")

    from da3slam_tpu_torch.utils.parity import find_parity_dir, run_parity

    checkpoint, goldens = args.checkpoint, args.golden
    if checkpoint is None or not goldens:
        pdir = Path(args.parity_dir) if args.parity_dir else find_parity_dir()
        if pdir is None:
            print("no parity data found (set --parity_dir or DA3_PARITY_DIR, "
                  "or create parity_data/{checkpoint,golden} at the repository's root)")
            return 2
        checkpoint = checkpoint or str(pdir / "checkpoint")
        goldens = goldens or sorted(str(p) for p in (pdir / "golden").glob("*.npz"))
        if not goldens:
            print(f"no golden npz files under {pdir / 'golden'}")
            return 2

    results, ok = run_parity(checkpoint, goldens, device=device)
    print(f"parity: {sum(int(r['passed']) for r in results)}/{len(results)} "
          f"golden files passed")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
