"""Single-device training step for the DA3 model (counterpart of
``da3slam_tpu/parallel/train.py``: ``TrainState``, the losses,
``make_train_step`` and ``synthetic_batch``).

The loss is the JAX package's: confidence-weighted scale-invariant log-depth
loss plus a pose loss, per window, averaged over the windows of a batch;
AdamW with optax's defaults.  The sp/pp steps, the mesh and every other
multi-device part are not ported yet (ROADMAP.md, modules queue item 14).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from da3slam_tpu_torch.models.config import ModelConfig
from da3slam_tpu_torch.models.da3 import DA3Net, forward_fn, init_params

# optax.adamw's defaults; torch.optim.AdamW's own weight decay is 1e-2
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4
# the deepest DPT fusion stage has one input, so its first residual unit is
# never run (models/dpt.py): the only parameters without a gradient
UNUSED_PARAMS = ("depth_head.scratch.refinenet4.resConfUnit1.",)


@dataclasses.dataclass
class TrainState:
    """The network (parameters), its optimizer and the step count.

    ``step_fn`` updates it in place, where the JAX step donates its state.
    """

    net: DA3Net
    optimizer: torch.optim.AdamW
    step: int = 0


def depth_loss(pred_depth, pred_conf, gt_depth, eps=1e-6):
    """Confidence-weighted scale-invariant log loss.  Pixels with
    ``gt_depth <= eps`` are invalid and drop out of every term."""
    valid = (gt_depth > eps).float()
    diff = (torch.log(pred_depth + eps) - torch.log(gt_depth + eps)) * valid
    n = valid.sum().clamp_min(1.0)
    silog = (diff**2).sum() / n - 0.5 * (diff.sum() / n) ** 2
    # the -log(conf) reward is masked too: on invalid pixels diff is 0, so an
    # unmasked term would push conf up without bound
    conf_term = ((pred_conf * diff**2 - torch.log(pred_conf)) * valid).sum() / n
    return silog + 0.1 * conf_term


def pose_loss(pred_ext, gt_ext):
    return torch.mean((pred_ext - gt_ext) ** 2)


def window_loss(net: DA3Net, cfg: ModelConfig, images, gt_depth, gt_ext, dtype=torch.float32):
    """One window's loss: images ``[N, H, W, 3]``, depth ``[N, H, W]``,
    extrinsics ``[N, 3, 4]``."""
    out = forward_fn(net, images, cfg, dtype=dtype)
    return depth_loss(out["depth"], out["conf"], gt_depth) + pose_loss(out["extrinsics"], gt_ext)


def fill_unused_grads(net: DA3Net) -> None:
    """Give the parameters the forward never reads a zero gradient, as
    ``jax.grad`` does, so AdamW decays them as optax does; raise if any other
    parameter got no gradient (AdamW would skip it without a word)."""
    for name, p in net.named_parameters():
        if p.grad is not None:
            continue
        if not name.startswith(UNUSED_PARAMS):
            raise RuntimeError(f"parameter {name} got no gradient from the loss")
        p.grad = torch.zeros_like(p)


def make_train_step(
    cfg: ModelConfig,
    device: str | torch.device,
    learning_rate: float = 1e-4,
    dtype=torch.float32,
):
    """Returns ``(init_fn, step_fn, place_batch)`` on one device.

    ``step_fn(state, batch) -> (state, loss)`` with batch = dict(images
    ``[B, N, H, W, 3]`` f32 normalised, depth ``[B, N, H, W]``, extrinsics
    ``[B, N, 3, 4]``) on the device (``place_batch`` puts a numpy batch
    there).  The loss is the mean over the B windows.  Where the JAX step
    vmaps the windows, this one loops over them and accumulates
    ``(loss_w / B).backward()`` window by window, so the activations of one
    window at a time are alive.  The update is AdamW with optax's defaults
    (β 0.9/0.999, eps 1e-8, weight decay 1e-4 on every parameter), in place.

    The network's ``pos_embed`` carries the DINOv2 layout's zero cls row:
    its gradient is 0, so it stays 0 under decay, and the parameter count
    exceeds the JAX package's by ``cfg.embed_dim``.
    """
    device = torch.device(device)

    def init_fn(seed: int = 0) -> TrainState:
        net = init_params(cfg, seed).to(device)
        opt = torch.optim.AdamW(net.parameters(), lr=learning_rate, betas=ADAMW_BETAS,
                                eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
        return TrainState(net, opt, 0)

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
        state.optimizer.step()
        state.step += 1
        return state, total / n_windows

    def place_batch(batch) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v, np.float32)).to(device) for k, v in batch.items()}

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
