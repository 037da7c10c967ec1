"""Training CLI (counterpart of ``da3slam_tpu/cli/train.py``): fit or
fine-tune a DA3 model with the dp, sp and pp train steps.

    # data-parallel (windows split over dp), synthetic smoke data
    python -m da3slam_tpu_torch.cli.train --preset small --mode dp --steps 5 \
        --batch 2 --views 4 --hw 504 504 --ckpt_dir runs/exp1 --ckpt_every 25

    # dp x tp: 2 windows over dp, each block's linears split over tp
    python -m da3slam_tpu_torch.cli.train --preset tiny --mode dp --devices 4 --tp 2

    # sequence-parallel (one window's views split, ring attention)
    python -m da3slam_tpu_torch.cli.train --preset tiny --mode sp --devices 2 --views 4

    # pipeline-parallel (encoder stages, GPipe microbatches)
    python -m da3slam_tpu_torch.cli.train --preset tiny --mode pp --stages 2 \
        --batch 3 --views 2

    # resume from the latest checkpoint in --ckpt_dir
    python -m da3slam_tpu_torch.cli.train ... --ckpt_dir runs/exp1 --resume

Same flags, errors and JSON lines as the JAX package's CLI, plus ``--device``
(default ``cuda``; the run happens there or not at all, with no fallback to
the CPU).  ``--devices`` is the number of ranks: by default the visible
cards on ``cuda``, 1 on ``--device cpu``; ``--stages`` sets it in pp mode.
One rank runs in this process (dp: the one-device step, as before the mesh
existed).  More are spawned (``parallel/mesh.py:run_ranks``, no deadline on
the run) into one process group: NCCL when every rank has a card of its
own, else gloo (on the CPU, or ranks time-sharing fewer cards; rank r takes
card ``r % cards``).  Rank 0 prints the JSON lines and writes the
checkpoints.  The header's ``mesh`` holds the mesh's axis sizes.

The header's ``params`` counts the port's parameters of the trained model
(pp: without the camera head, which its loss does not read, as the JAX pp
state): ``embed_dim`` more than the JAX package's, for the zero cls row the
DINOv2 layout keeps in ``pos_embed``.

Data: ``--data DIR`` consumes ``.npz`` shards, each with ``images``
[B, N, H, W, 3] float32 (normalised), ``depth`` [B, N, H, W] and
``extrinsics`` [B, N, 3, 4], cycled per step.  Without ``--data`` a
synthetic batch (``parallel/train.synthetic_batch``) stands in.  sp trains
the first window of each batch; pp takes the B windows as microbatches and
drops the extrinsics.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

# a collective that waits this long means a peer is gone (a checkpoint write
# on rank 0 included); the run as a whole has no deadline
COLLECTIVE_TIMEOUT_S = 1800


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DA3 training (dp / sp / pp), PyTorch/CUDA port")
    p.add_argument("--preset", default="tiny",
                   help="model preset (tiny/small/base/large/giant)")
    p.add_argument("--mode", default="dp", choices=["dp", "sp", "pp"],
                   help="parallelism: dp = windows split, sp = views split + ring "
                   "attention, pp = encoder stages + GPipe")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=2,
                   help="dp: windows per step; pp: GPipe microbatches per step; sp trains "
                   "one window per step (views split)")
    p.add_argument("--views", type=int, default=4, help="frames per window")
    p.add_argument("--hw", type=int, nargs=2, default=(56, 56), metavar=("H", "W"))
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", type=int, default=None,
                   help="mesh size, in ranks (default: the visible cards, 1 on the CPU; "
                   "--stages for pp)")
    p.add_argument("--tp", type=int, default=None,
                   help="dp mode: tensor-parallel axis size (make_mesh)")
    p.add_argument("--stages", type=int, default=None,
                   help="pp mode: pipeline stages (must divide model depth)")
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


def _mesh_shape(args, cfg) -> dict[str, int]:
    """The mesh's axis sizes, with the JAX CLI's errors."""
    from da3slam_tpu_torch.parallel.mesh import mesh_shape
    from da3slam_tpu_torch.parallel.pp_forward import stage_range
    from da3slam_tpu_torch.parallel.sharding import check_tp

    if args.device.startswith("cuda"):
        visible = torch.cuda.device_count()
    else:
        visible = 1
    if args.mode == "dp":
        dp, tp = mesh_shape(args.devices or visible, args.tp)
        check_tp(cfg, tp)
        if args.batch % dp:
            raise SystemExit(f"--batch {args.batch} must divide by the dp mesh axis {dp} "
                             "(set --devices/--tp to shape the mesh)")
        return {"dp": dp, "tp": tp}
    if args.mode == "sp":
        n = args.devices or visible
        if args.views % n:
            raise SystemExit(f"--views {args.views} must divide by the sp mesh size {n}")
        return {"sp": n}
    n = args.stages or args.devices or visible
    stage_range(cfg.depth, n, 0)  # n_stages=... must divide depth=...
    return {"pp": n}


def _shape_batch(mode: str, batch: dict) -> dict:
    """Adapt a [B, N, ...] shard to the mode's step contract."""
    if mode == "dp":
        return batch
    if mode == "sp":  # one window per step: views are the parallel axis
        return {k: v[0] for k, v in batch.items()}
    # pp consumes microbatches of windows; extrinsics unused by its loss
    return {"images": batch["images"], "depth": batch["depth"]}


def _data_iter(args, cfg):
    from da3slam_tpu_torch.parallel.train import synthetic_batch

    if args.data is None:
        def gen():
            step = 0
            while True:
                yield _shape_batch(args.mode, synthetic_batch(
                    cfg, args.batch, args.views, tuple(args.hw), seed=args.seed + step))
                step += 1
        return gen()

    shards = sorted(Path(args.data).glob("*.npz"))
    if not shards:
        raise SystemExit(f"--data {args.data}: no .npz shards found")

    def gen():
        while True:
            for f in shards:
                with np.load(f) as z:
                    yield _shape_batch(args.mode, {k: np.asarray(z[k], np.float32)
                                                   for k in ("images", "depth", "extrinsics")})
    return gen()


def _step_factory(args, cfg, shape: dict, device: torch.device):
    """``(init_fn, step_fn, place)`` of the mode, over a mesh of the process
    group's ranks; without a group (dp on one device), the one-device step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from da3slam_tpu_torch.parallel.mesh import make_mesh
    from da3slam_tpu_torch.parallel.train import (
        make_pp_train_step,
        make_sp_train_step,
        make_train_step,
    )

    if args.mode == "dp":
        mesh = None if not dist.is_initialized() else \
            make_mesh(shape["dp"] * shape["tp"], shape["tp"], device=device.type)
        return make_train_step(cfg, device, learning_rate=args.lr, mesh=mesh)
    (axis, n), = shape.items()
    mesh = DeviceMesh(device.type, torch.arange(n), mesh_dim_names=(axis,))
    if args.mode == "sp":
        return make_sp_train_step(cfg, mesh, axis="sp", learning_rate=args.lr)
    return make_pp_train_step(cfg, mesh, n, learning_rate=args.lr)


def _say(line) -> None:
    """Rank 0 prints (every rank runs the loop)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        print(line if isinstance(line, str) else json.dumps(line), flush=True)


def _train(args, shape: dict):
    """The training loop, on every rank of the mesh (spawned by ``run_ranks``)
    or in this process.  Returns ``(state, losses)``."""
    import torch.distributed as dist

    from da3slam_tpu_torch.models.config import get_preset
    from da3slam_tpu_torch.models.da3 import DA3Net
    from da3slam_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state

    cfg = get_preset(args.preset)
    device = torch.device(args.device)
    if dist.is_initialized() and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())  # the rank's card
    init_fn, step_fn, place = _step_factory(args, cfg, shape, device)
    state = init_fn(seed=args.seed)
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume:
        if ckpt_dir is None:
            raise SystemExit("--resume needs --ckpt_dir")
        latest = ckpt_dir / "latest"
        if not latest.exists():
            raise SystemExit(f"--resume: no checkpoint at {latest}")
        state = restore_train_state(latest, state)
        _say(f"resumed step {state.step} from {latest}")

    with torch.device("meta"):
        whole = DA3Net(cfg)
    n_params = sum(p.numel() for name, p in whole.named_parameters()
                   if args.mode != "pp" or not name.startswith("camera_head."))
    _say({"preset": args.preset, "mode": args.mode, "mesh": shape,
          "params": int(n_params), "start_step": state.step})

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
            _say({"step": step, "loss": round(losses[-1], 6),
                  "steps_per_s": round((step - start) / max(dt, 1e-9), 3)})
        if ckpt_dir is not None and args.ckpt_every and step % args.ckpt_every == 0:
            save_train_state(ckpt_dir / "latest", state)
            _say(f"checkpoint @ step {step} -> {ckpt_dir / 'latest'}")

    if ckpt_dir is not None and state.step != start:
        save_train_state(ckpt_dir / "latest", state)
    if losses:
        _say({"final_step": state.step, "final_loss": round(losses[-1], 6),
              "first_loss": round(losses[0], 6)})
    return state, losses


def _rank(args, shape: dict) -> None:
    """One spawned rank of the CLI (``run_ranks`` returns rank 0's None)."""
    _train(args, shape)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")

    from da3slam_tpu_torch.models.config import get_preset
    from da3slam_tpu_torch.parallel.mesh import one_rank_group, run_ranks

    shape = _mesh_shape(args, get_preset(args.preset))
    world = int(np.prod(list(shape.values())))
    if world == 1 and args.mode == "dp":
        _train(args, shape)
        return
    # NCCL when every rank has a card of its own; gloo on the CPU and for
    # ranks time-sharing fewer cards
    backend = "nccl" if device.type == "cuda" and world <= torch.cuda.device_count() else "gloo"
    if world == 1:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        with one_rank_group(backend, device.type, COLLECTIVE_TIMEOUT_S):
            _train(args, shape)
        return
    run_ranks(_rank, world, backend, device.type, COLLECTIVE_TIMEOUT_S, args, shape,
              whole_run_deadline=False)


if __name__ == "__main__":
    main()
