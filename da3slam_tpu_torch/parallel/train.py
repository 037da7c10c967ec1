"""Training steps for the DA3 model (counterpart of
``da3slam_tpu/parallel/train.py``: ``TrainState``, the losses,
``make_train_step``, ``make_sp_train_step``, ``make_pp_train_step`` and
``synthetic_batch``).

The loss is the JAX package's: confidence-weighted scale-invariant log-depth
loss plus a pose loss, per window, averaged over the windows of a batch;
AdamW with optax's defaults.  The multi-device steps run SPMD on the ranks of
a process group (``parallel/mesh.py:run_ranks``), with the collectives the
JAX package's GSPMD inserts written out (``parallel/comm.py``):

- ``make_train_step(..., mesh=...)`` over a ``(dp, tp)`` mesh: windows split
  over dp, the encoder blocks' linears split over tp by the Megatron rules
  (``parallel/sharding.py``); gradients averaged over dp.
- ``make_sp_train_step``: one window's views split over a mesh axis, the
  cross-view attention a differentiable ring (``parallel/ring_attention.py``).
- ``make_pp_train_step``: the encoder's blocks in stages over the ranks of a
  ``pp`` axis, GPipe forward and backward (``parallel/pp_forward.py``).

A parameter every rank of a group holds whole (a replicated one) gets the
same gradient on every rank: those computed alike on each rank (the tp
shard's norms, the sp step's camera head, the pp step's DPT head) are taken
from the group's first rank (a broadcast; the numbers are the same, and no
nondeterministic kernel can move the replicas apart), and those summed over
the group's ranks by an all-reduce, whose result is the same bits on each.
So replicated parameters stay bit-equal across ranks after every update.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from da3slam_tpu_torch.models import camera, dpt
from da3slam_tpu_torch.models.config import ModelConfig
from da3slam_tpu_torch.models.da3 import DA3Net, forward_fn, init_params
from da3slam_tpu_torch.parallel import comm
from da3slam_tpu_torch.parallel.mesh import DeviceMesh, axis_size
from da3slam_tpu_torch.parallel.sharding import (
    batch_sharding,
    gather_tp,
    replicated,
    shard_tensor,
    shard_tp,
)

# optax.adamw's defaults; torch.optim.AdamW's own weight decay is 1e-2
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4
# the deepest DPT fusion stage has one input, so its first residual unit is
# never run (models/dpt.py): the only parameters without a gradient
UNUSED_PARAMS = ("depth_head.scratch.refinenet4.resConfUnit1.",)


@dataclasses.dataclass
class Layout:
    """Where this rank's parameters sit in the whole network, which is what a
    checkpoint holds (``parallel/checkpoint.py``): tp shards of the tensors
    ``parallel/sharding.py`` splits (``tp_group``), and a pp stage's blocks,
    named locally from 0 (``pp_group``, ``block_offset``: the stage's first
    global block).  The default is the whole network on one rank."""

    tp_group: object = None
    pp_group: object = None
    block_offset: int = 0

    def whole_name(self, name: str) -> str:
        m = re.match(r"blocks\.(\d+)\.(.*)", name)
        if m is None or not self.block_offset:
            return name
        return f"blocks.{int(m.group(1)) + self.block_offset}.{m.group(2)}"

    def gather(self, named: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Whole tensors, keyed by whole names, from every rank's ``named``
        (keyed by whole names too).  A collective: every rank calls it."""
        out = gather_tp(named, self.tp_group)
        if self.pp_group is not None and dist.get_world_size(self.pp_group) > 1:
            parts = [None] * dist.get_world_size(self.pp_group)
            dist.all_gather_object(parts, {k: v.cpu() for k, v in out.items()
                                           if k.startswith("blocks.")}, group=self.pp_group)
            for part in parts:
                out.update(part)
        return out

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``name`` (a whole name)."""
        if self.tp_group is None:
            return whole
        return shard_tensor(name, whole, dist.get_rank(self.tp_group),
                            dist.get_world_size(self.tp_group))


@dataclasses.dataclass
class TrainState:
    """The network (this rank's parameters), its optimizer, the step count
    and where the parameters sit in the whole network.

    ``step_fn`` updates it in place, where the JAX step donates its state.
    """

    net: nn.Module
    optimizer: torch.optim.AdamW
    step: int = 0
    layout: Layout = dataclasses.field(default_factory=Layout)


def depth_loss(pred_depth, pred_conf, gt_depth, eps=1e-6, group=None):
    """Confidence-weighted scale-invariant log loss.  Pixels with
    ``gt_depth <= eps`` are invalid and drop out of every term.

    With ``group`` the views are split over its ranks: the valid count,
    Σ diff, Σ diff² and the confidence term's sum are summed over the group
    (``comm.reduce_from_group``) before the loss is formed, since the silog
    term's (Σ diff / n)² is no mean of the ranks' losses."""
    valid = (gt_depth > eps).float()
    diff = (torch.log(pred_depth + eps) - torch.log(gt_depth + eps)) * valid
    # the -log(conf) reward is masked too: on invalid pixels diff is 0, so an
    # unmasked term would push conf up without bound
    sums = torch.stack([valid.sum(), diff.sum(), (diff**2).sum(),
                        ((pred_conf * diff**2 - torch.log(pred_conf)) * valid).sum()])
    count, s1, s2, conf_sum = comm.reduce_from_group(sums, group).unbind()
    n = count.clamp_min(1.0)
    silog = s2 / n - 0.5 * (s1 / n) ** 2
    return silog + 0.1 * (conf_sum / n)


def pose_loss(pred_ext, gt_ext):
    return torch.mean((pred_ext - gt_ext) ** 2)


def window_loss(net: DA3Net, cfg: ModelConfig, images, gt_depth, gt_ext, dtype=torch.float32):
    """One window's loss: images ``[N, H, W, 3]``, depth ``[N, H, W]``,
    extrinsics ``[N, 3, 4]``."""
    out = forward_fn(net, images, cfg, dtype=dtype)
    return depth_loss(out["depth"], out["conf"], gt_depth) + pose_loss(out["extrinsics"], gt_ext)


def fill_unused_grads(net: nn.Module, unused: tuple[str, ...] = UNUSED_PARAMS) -> None:
    """Give the parameters the forward never reads (names starting with one
    of ``unused``) a zero gradient, as ``jax.grad`` does, so AdamW decays
    them as optax does; raise if any other parameter got no gradient (AdamW
    would skip it without a word)."""
    for name, p in net.named_parameters():
        if p.grad is not None:
            continue
        if not name.startswith(unused):
            raise RuntimeError(f"parameter {name} got no gradient from the loss")
        p.grad = torch.zeros_like(p)


def _adamw(net: nn.Module, learning_rate: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(net.parameters(), lr=learning_rate, betas=ADAMW_BETAS,
                             eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its card (``run_ranks`` sets it) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _sync_grads(net: nn.Module, whole_on_each: list[str], summed: list[str], group,
                scale: float = 1.0) -> None:
    """Make the gradients of a group's ranks agree: those named in
    ``whole_on_each`` (computed alike on every rank) from the group's first
    rank, those named in ``summed`` summed over the group (then x ``scale``)."""
    grads = {name: p.grad for name, p in net.named_parameters()}
    comm.broadcast_tensors([grads[n] for n in whole_on_each], 0, group)
    comm.all_reduce_tensors([grads[n] for n in summed], group)
    if scale != 1.0:
        for n in summed:
            grads[n].mul_(scale)


def make_train_step(
    cfg: ModelConfig,
    device: str | torch.device,
    learning_rate: float = 1e-4,
    dtype=torch.float32,
    mesh: DeviceMesh | None = None,
):
    """Returns ``(init_fn, step_fn, place_batch)``.

    ``step_fn(state, batch) -> (state, loss)`` with batch = dict(images
    ``[B, N, H, W, 3]`` f32 normalised, depth ``[B, N, H, W]``, extrinsics
    ``[B, N, 3, 4]``) on the device (``place_batch`` puts a numpy batch
    there).  The loss is the mean over the B windows.  Where the JAX step
    vmaps the windows, this one loops over them and accumulates
    ``(loss_w / B).backward()`` window by window, so the activations of one
    window at a time are alive.  The update is AdamW with optax's defaults
    (β 0.9/0.999, eps 1e-8, weight decay 1e-4 on every parameter), in place.

    With a ``("dp", "tp")`` ``mesh`` (call it on every rank): ``place_batch``
    takes the whole batch and keeps this rank's B/dp windows; ``init_fn`` makes
    the whole network from the seed and cuts it into this rank's tp shard
    (``sharding.shard_tp``), so the optimizer's moments are sharded as the
    parameters are; the step averages the gradients over dp (an all-reduce)
    and returns the global mean loss.  Without a mesh it is the one-device
    step on ``device``.

    The network's ``pos_embed`` carries the DINOv2 layout's zero cls row:
    its gradient is 0, so it stays 0 under decay, and the parameter count
    exceeds the JAX package's by ``cfg.embed_dim``.
    """
    device = torch.device(device)
    dp_group = tp_group = None
    dp = 1
    if mesh is not None:
        dp_group, tp_group = mesh.get_group("dp"), mesh.get_group("tp")
        dp = axis_size(mesh, "dp")

    def init_fn(seed: int = 0) -> TrainState:
        net = init_params(cfg, seed).to(device)
        layout = Layout()
        if tp_group is not None:
            shard_tp(net, cfg, tp_group)
            layout = Layout(tp_group=tp_group)
        return TrainState(net, _adamw(net, learning_rate), 0, layout)

    def step_fn(state: TrainState, batch) -> tuple[TrainState, torch.Tensor]:
        n_windows = batch["images"].shape[0]
        state.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=device)
        for w in range(n_windows):
            loss = window_loss(state.net, cfg, batch["images"][w], batch["depth"][w],
                               batch["extrinsics"][w], dtype)
            (loss / n_windows).backward()
            total += loss.detach()
        fill_unused_grads(state.net)
        loss = total / n_windows
        if mesh is not None:
            names = [n for n, _ in state.net.named_parameters()]
            _sync_grads(state.net, [n for n in names if replicated(n)], [], tp_group)
            _sync_grads(state.net, [], names, dp_group, 1.0 / dp)
            loss = comm.all_reduce(loss, dp_group) / dp
        state.optimizer.step()
        state.step += 1
        return state, loss

    def place_batch(batch) -> dict[str, torch.Tensor]:
        if mesh is not None:
            mine = batch_sharding(mesh, np.asarray(batch["images"]).shape[0])
            batch = {k: np.asarray(v)[mine] for k, v in batch.items()}
        return {k: torch.as_tensor(np.asarray(v, np.float32)).to(device) for k, v in batch.items()}

    return init_fn, step_fn, place_batch


def make_sp_train_step(
    cfg: ModelConfig,
    mesh: DeviceMesh,
    axis: str = "dp",
    learning_rate: float = 1e-4,
    dtype=torch.float32,
    ref_idx: int = 0,
):
    """View-sharded (sequence-parallel) train step: one window's views split
    over ``mesh``'s ``axis`` (call it on every rank).

    Each rank encodes its views (``sp_forward.local_forward``): patch
    embedding, intra-view attention, MLPs and the DPT head on its own views,
    the cross-view attention as the differentiable ring.  The camera tokens
    are all-gathered (``comm.gather_from_group``) and the camera head and the
    pose loss run whole on every rank; the depth loss's sums are summed over
    the axis first (``depth_loss(group=...)``).  Parameters are replicated
    (sp targets activation memory, the quadratic cross-view attention, not
    weight memory).

    Gradients, the convention of ``parallel/comm.py``: the losses and the
    camera head are computed alike on every rank, so the camera head's
    gradient is whole on each (taken from the axis's first rank), while the
    encoder's and the DPT head's hold only the rank's own views' terms and
    are summed over the axis, as ``shard_map``'s psum does for the JAX step.

    Returns ``(init_fn, step_fn, place_batch)``.  ``place_batch`` takes one
    window, dict(images ``[N, H, W, 3]``, depth ``[N, H, W]``, extrinsics
    ``[N, 3, 4]``), N divisible by the axis size, and keeps this rank's views
    of images and depth (the extrinsics whole).
    """
    from da3slam_tpu_torch.parallel.ring_attention import make_ring_cross_view_attention
    from da3slam_tpu_torch.parallel.sp_forward import local_forward

    n = axis_size(mesh, axis)
    r = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    ring = make_ring_cross_view_attention(mesh, axis)
    device = mesh_device(mesh)

    def init_fn(seed: int = 0) -> TrainState:
        net = init_params(cfg, seed).to(device)
        return TrainState(net, _adamw(net, learning_rate), 0)

    def loss_fn(net: DA3Net, batch) -> torch.Tensor:
        H, W = batch["images"].shape[1:3]
        depth, conf, _rays, cam_tokens = local_forward(net, batch["images"], cfg, dtype, ring)
        extrinsics, _ = camera.apply_camera_head(
            net.camera_head, comm.gather_from_group(cam_tokens, group), (H, W), ref_idx)
        return (depth_loss(depth, conf, batch["depth"], group=group)
                + pose_loss(extrinsics, batch["extrinsics"]))

    def step_fn(state: TrainState, batch) -> tuple[TrainState, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.net, batch)
        loss.backward()
        fill_unused_grads(state.net)
        names = [name for name, _ in state.net.named_parameters()]
        head = [name for name in names if name.startswith("camera_head.")]
        _sync_grads(state.net, head, [name for name in names if name not in head], group)
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    def place_batch(batch) -> dict[str, torch.Tensor]:
        N = np.asarray(batch["images"]).shape[0]
        if N % n:
            raise ValueError(f"{N} views do not divide over the {axis!r} axis of {n}")
        mine = slice(r * (N // n), (r + 1) * (N // n))
        return {k: torch.as_tensor(np.asarray(v if k == "extrinsics" else v[mine],
                                              np.float32)).to(device)
                for k, v in batch.items()}

    return init_fn, step_fn, place_batch


def make_pp_train_step(
    cfg: ModelConfig,
    mesh: DeviceMesh,
    n_stages: int | None = None,
    learning_rate: float = 1e-4,
    dtype=torch.float32,
):
    """Pipeline-parallel train step (GPipe): the encoder's blocks in stages
    over ``mesh``'s ``pp`` axis (call it on every rank).

    ``init_fn`` makes the whole network from the seed and keeps this rank's
    stage (``pp_forward.StageNet``: its blocks, the replicated rest of the
    encoder and the DPT head; the camera head, which the loss does not read,
    is dropped as in the JAX step), so stage blocks and their AdamW moments
    live on their stage only.  The step is ``pp_forward.make_pp_step``: the
    GPipe forward with the graph kept, the depth loss over every microbatch
    on the (replicated) DPT head, then the GPipe backward in reverse tick
    order.  The encoder's rest (embedding on stage 0, final norm on the last
    stage) has its gradients summed over the axis; the DPT head's are whole
    on every rank (taken from the first).

    Batch = dict(images ``[M, N, H, W, 3]`` normalised, depth ``[M, N, H,
    W]``): M microbatches of N views, the same on every rank.  Returns
    ``(init_fn, step_fn, place_batch)``.
    """
    from da3slam_tpu_torch.parallel.pp_forward import StageNet, make_pp_step, stage_range

    size = axis_size(mesh, "pp")
    n_stages = size if n_stages is None else n_stages
    owned = stage_range(cfg.depth, n_stages, mesh.get_local_rank("pp"))
    group = mesh.get_group("pp")
    device = mesh_device(mesh)
    pp_step = make_pp_step(cfg, mesh, n_stages, dtype)
    # never read by the loss: the final norm, blocks past the deepest tap and,
    # off stage 0, the embedding (its gradient is summed in from stage 0)
    unused = UNUSED_PARAMS + ("norm.",) + tuple(
        f"blocks.{j}." for j, g in enumerate(owned) if g > max(cfg.dpt_layers))
    if owned.start > 0:
        unused += ("patch_embed.", "cls_token", "register_tokens", "pos_embed")

    def init_fn(seed: int = 0) -> TrainState:
        stage_net = StageNet(init_params(cfg, seed), n_stages, mesh.get_local_rank("pp"))
        stage_net = stage_net.to(device)
        return TrainState(stage_net, _adamw(stage_net, learning_rate), 0,
                          Layout(pp_group=group, block_offset=owned.start))

    def loss_fn(stage_net: StageNet, taps: torch.Tensor, batch) -> torch.Tensor:
        M, N, H, W, _ = batch["images"].shape
        grid = (H // cfg.patch_size, W // cfg.patch_size)
        heads = [dpt.apply_dpt(stage_net.depth_head, list(taps[m]), grid, (H, W), cfg)[:2]
                 for m in range(M)]
        depth = torch.cat([d for d, _ in heads])
        conf = torch.cat([c for _, c in heads])
        return depth_loss(depth, conf, batch["depth"].reshape(M * N, H, W))

    def step_fn(state: TrainState, batch) -> tuple[TrainState, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        net = state.net
        loss = pp_step(net, batch["images"], lambda taps: loss_fn(net, taps, batch))
        fill_unused_grads(net, unused)
        names = [name for name, _ in net.named_parameters()]
        head = [name for name in names if name.startswith("depth_head.")]
        rest = [name for name in names if not name.startswith(("depth_head.", "blocks."))]
        _sync_grads(net, head, rest, group)
        state.optimizer.step()
        state.step += 1
        return state, loss

    def place_batch(batch) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(batch[k], np.float32)).to(device)
                for k in ("images", "depth")}

    return init_fn, step_fn, place_batch


def synthetic_batch(cfg: ModelConfig, batch: int, n_views: int, hw: tuple[int, int], seed=0):
    """Tiny synthetic supervised batch for smoke tests / dryruns (numpy)."""
    rng = np.random.default_rng(seed)
    H, W = hw
    return {
        "images": rng.normal(size=(batch, n_views, H, W, 3)).astype("float32"),
        "depth": rng.uniform(0.5, 3.0, size=(batch, n_views, H, W)).astype("float32"),
        "extrinsics": np.tile(
            np.eye(4, dtype="float32")[:3], (batch, n_views, 1, 1)
        ),
    }
