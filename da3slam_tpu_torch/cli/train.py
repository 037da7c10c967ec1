"""Training CLI (counterpart of ``da3slam_tpu/cli/train.py``), one device.

    # data-parallel mode on one card, synthetic smoke data
    python -m da3slam_tpu_torch.cli.train --preset small --mode dp --steps 5 \
        --batch 2 --views 4 --hw 504 504 --ckpt_dir runs/exp1 --ckpt_every 25

    # resume from the latest checkpoint in --ckpt_dir
    python -m da3slam_tpu_torch.cli.train ... --ckpt_dir runs/exp1 --resume

Same flags and JSON lines as the JAX package's CLI, plus ``--device``
(default ``cuda``; the run happens there or not at all, with no fallback to
the CPU).  ``--mode dp`` runs its windows on that one device.  ``--mode
sp|pp`` and meshes of more than one device (``--devices``, ``--tp``,
``--stages``) are not ported yet (ROADMAP.md, modules queue item 14) and
raise ``NotImplementedError``.

The header's ``params`` counts the port's parameters: ``embed_dim`` more than
the JAX package's, for the zero cls row the DINOv2 layout keeps in
``pos_embed``.

Data: ``--data DIR`` consumes ``.npz`` shards, each with ``images``
[B, N, H, W, 3] float32 (normalised), ``depth`` [B, N, H, W] and
``extrinsics`` [B, N, 3, 4], cycled per step.  Without ``--data`` a
synthetic batch (``parallel/train.synthetic_batch``) stands in.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

_UNPORTED = "is not ported yet (ROADMAP.md, modules queue item 14: sp/pp/multi-device training)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DA3 training (PyTorch/CUDA port, one device)")
    p.add_argument("--preset", default="tiny",
                   help="model preset (tiny/small/base/large)")
    p.add_argument("--mode", default="dp", choices=["dp", "sp", "pp"],
                   help="parallelism: only dp (windows of a batch, one device) is ported")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=2, help="windows per step")
    p.add_argument("--views", type=int, default=4, help="frames per window")
    p.add_argument("--hw", type=int, nargs=2, default=(56, 56), metavar=("H", "W"))
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", type=int, default=None, help="mesh size (only 1 is ported)")
    p.add_argument("--tp", type=int, default=None, help="tensor-parallel size (only 1 is ported)")
    p.add_argument("--stages", type=int, default=None, help="pp mode: not ported")
    p.add_argument("--data", default=None,
                   help="directory of .npz shards (images/depth/extrinsics); "
                   "omit for synthetic smoke data")
    p.add_argument("--ckpt_dir", default=None, help="checkpoint directory (enables saving)")
    p.add_argument("--ckpt_every", type=int, default=100)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint from --ckpt_dir")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def _refuse_unported(args) -> None:
    if args.mode != "dp":
        raise NotImplementedError(f"--mode {args.mode} {_UNPORTED}")
    for flag in ("devices", "tp"):
        if getattr(args, flag) not in (None, 1):
            raise NotImplementedError(f"--{flag} {getattr(args, flag)} {_UNPORTED}")
    if args.stages is not None:
        raise NotImplementedError(f"--stages {_UNPORTED}")


def _data_iter(args, cfg):
    from da3slam_tpu_torch.parallel.train import synthetic_batch

    if args.data is None:
        def gen():
            step = 0
            while True:
                yield synthetic_batch(cfg, args.batch, args.views, tuple(args.hw),
                                      seed=args.seed + step)
                step += 1
        return gen()

    shards = sorted(Path(args.data).glob("*.npz"))
    if not shards:
        raise SystemExit(f"--data {args.data}: no .npz shards found")

    def gen():
        while True:
            for f in shards:
                with np.load(f) as z:
                    yield {k: np.asarray(z[k], np.float32)
                           for k in ("images", "depth", "extrinsics")}
    return gen()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    _refuse_unported(args)

    from da3slam_tpu_torch.models.config import get_preset
    from da3slam_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from da3slam_tpu_torch.parallel.train import make_train_step

    cfg = get_preset(args.preset)
    init_fn, step_fn, place = make_train_step(cfg, device, learning_rate=args.lr)
    state = init_fn(seed=args.seed)
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume:
        if ckpt_dir is None:
            raise SystemExit("--resume needs --ckpt_dir")
        latest = ckpt_dir / "latest"
        if not latest.exists():
            raise SystemExit(f"--resume: no checkpoint at {latest}")
        state = restore_train_state(latest, state)
        print(f"resumed step {state.step} from {latest}", flush=True)

    n_params = sum(p.numel() for p in state.net.parameters())
    print(json.dumps({
        "preset": args.preset, "mode": args.mode, "mesh": {"dp": 1, "tp": 1},
        "params": int(n_params), "start_step": state.step,
    }), flush=True)

    data = _data_iter(args, cfg)
    t0 = time.perf_counter()
    losses = []
    start = state.step
    for _ in range(start, args.steps):
        state, loss = step_fn(state, place(next(data)))
        step = state.step
        losses.append(float(loss))
        if args.log_every and step % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(json.dumps({
                "step": step, "loss": round(losses[-1], 6),
                "steps_per_s": round((step - start) / max(dt, 1e-9), 3),
            }), flush=True)
        if ckpt_dir is not None and args.ckpt_every and step % args.ckpt_every == 0:
            save_train_state(ckpt_dir / "latest", state)
            print(f"checkpoint @ step {step} -> {ckpt_dir / 'latest'}", flush=True)

    if ckpt_dir is not None and state.step != start:
        save_train_state(ckpt_dir / "latest", state)
    if losses:
        print(json.dumps({
            "final_step": state.step,
            "final_loss": round(losses[-1], 6),
            "first_loss": round(losses[0], 6),
        }), flush=True)


if __name__ == "__main__":
    main()
