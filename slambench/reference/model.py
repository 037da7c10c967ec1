"""Plain DepthAnything3 forward over a state dict: the benchmark's
reference for the model's outputs.

Frozen copy of ``da3slam_tpu_torch/models/{vit,dpt,camera,da3,nested}.py``
and ``ops/resize.py`` at commit b277bb1, rewritten as functions over a
``{name: tensor}`` state dict.  It computes in the precision the
configuration states: every operation in float32 (the caller turns TF32 off)
on float32 parameters, its activations rounded to ``act`` (bfloat16 on the
card) where the port's are stored in that type, the camera head and the
outputs in float32.  Attention is plain softmax in float32, computed in blocks
of query rows, in place of the flash kernel.  With ``act`` float32 it is the
plain float32 forward.  Imports torch only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6
ATTN_BLOCK = 1024  # query rows a block: keeps [H, rows, S] scores within ~2 GB at S = 19515


def upper_bound_shape(h: int, w: int, process_res: int, patch: int) -> tuple[int, int]:
    scale = process_res / max(h, w)
    return (max(int(h * scale) // patch, 1) * patch, max(int(w * scale) // patch, 1) * patch)


def preprocess(raw: torch.Tensor, process_res: int, patch: int) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` → resized (antialiased bilinear), ImageNet-normalised
    f32 NHWC."""
    th, tw = upper_bound_shape(raw.shape[1], raw.shape[2], process_res, patch)
    x = raw.to(torch.float32) / 255.0
    if (x.shape[1], x.shape[2]) != (th, tw):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(th, tw), mode="bilinear",
                          align_corners=False, antialias=True).permute(0, 2, 3, 1)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


class Rounding:
    """Rounds a float32 tensor to the activation dtype and back, where the
    port stores an activation in that dtype (the identity in float32).  An
    8-bit float saturates at its largest finite value."""

    def __init__(self, act: torch.dtype):
        self.act = act
        self.limit = torch.finfo(act).max if act.itemsize == 1 else None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.act == torch.float32:
            return x
        if self.limit is not None:
            x = x.clamp(-self.limit, self.limit)
        return x.to(self.act).to(torch.float32)


def _lin(sd, name, x, r):
    """The port's ``F.linear`` on activation-dtype operands, accumulated in
    float32, rounded once."""
    return r(F.linear(x, r(sd[name + ".weight"]), r(sd[name + ".bias"])))


def _ln(sd, name, x, r):
    """LayerNorm in float32, its output stored in the activation dtype."""
    return r(F.layer_norm(x, (x.shape[-1],), sd[name + ".weight"], sd[name + ".bias"], LN_EPS))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention on ``[B, S, H, D]``, a block of query rows at a time."""
    B, S, H, D = q.shape
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, S, D]
    out = torch.empty_like(qh)
    scale = 1.0 / math.sqrt(D)
    for a in range(0, S, ATTN_BLOCK):
        s = (qh[:, :, a:a + ATTN_BLOCK] @ kh.transpose(-1, -2)) * scale
        out[:, :, a:a + ATTN_BLOCK] = torch.softmax(s, dim=-1) @ vh
    return out.permute(0, 2, 1, 3)


def _residual(sd, name, h, branch, r):
    """``h + branch · gamma``, each product and sum stored in the activation dtype."""
    return r(h + r(branch * r(sd[name])))


def _block(sd, i: int, x: torch.Tensor, cfg: dict, cross: bool, r) -> torch.Tensor:
    N, S, D = x.shape
    p = f"blocks.{i}"
    h = x.reshape(1, N * S, D) if cross else x
    B, L, _ = h.shape
    H = cfg["num_heads"]
    qkv = _lin(sd, p + ".attn.qkv", _ln(sd, p + ".norm1", h, r), r)
    q, k, v = (t.reshape(B, L, H, D // H) for t in qkv.split(D, dim=-1))
    a = _lin(sd, p + ".attn.proj", r(attention(q, k, v)).reshape(B, L, D), r)
    h = _residual(sd, p + ".ls1.gamma", h, a, r)
    y = _ln(sd, p + ".norm2", h, r)
    if cfg["mlp_type"] == "swiglu":
        gate, value = _lin(sd, p + ".mlp.w12", y, r).chunk(2, dim=-1)
        m = _lin(sd, p + ".mlp.w3", r(r(F.silu(gate)) * value), r)
    else:
        m = _lin(sd, p + ".mlp.fc2", r(F.gelu(_lin(sd, p + ".mlp.fc1", y, r), approximate="tanh")), r)
    return _residual(sd, p + ".ls2.gamma", h, m, r).reshape(N, S, D)


def encode(sd, images: torch.Tensor, cfg: dict, r):
    """Patch embed, [camera, registers] prefix, the blocks (every
    ``cross_view_interval``-th across all views).  Returns (taps, final, grid)."""
    N, Hh, Ww, _ = images.shape
    P, D = cfg["patch_size"], cfg["embed_dim"]
    hp, wp = Hh // P, Ww // P
    x = r(F.conv2d(r(images.permute(0, 3, 1, 2)), r(sd["patch_embed.proj.weight"]),
                   r(sd["patch_embed.proj.bias"]), stride=P)).flatten(2).transpose(1, 2)
    G = cfg["base_grid"]
    pos = sd["pos_embed"][0, 1:].reshape(G, G, D)
    if (G, G) != (hp, wp):
        pos = F.interpolate(pos.permute(2, 0, 1)[None], size=(hp, wp), mode="bilinear",
                            align_corners=False, antialias=True)[0].permute(1, 2, 0)
    x = r(x + r(pos.reshape(1, hp * wp, D)))
    x = torch.cat([r(sd["cls_token"]).expand(N, 1, D),
                   r(sd["register_tokens"]).expand(N, cfg["num_register_tokens"], D), x], dim=1)
    taps = []
    interval = cfg["cross_view_interval"]
    for i in range(cfg["depth"]):
        x = _block(sd, i, x, cfg, (i % interval) == interval - 1, r)
        if i in cfg["dpt_layers"]:
            taps.append(x)
    return taps, _ln(sd, "norm", x, r), (hp, wp)


def _conv(sd, name, x, r, stride=1):
    w = sd[name + ".weight"]
    return r(F.conv2d(x, r(w), r(sd[name + ".bias"]), stride=stride, padding=w.shape[-1] // 2))


def _rcu(sd, name, x, r):
    h = _conv(sd, name + ".conv1", F.relu(x), r)
    return r(x + _conv(sd, name + ".conv2", F.relu(h), r))


def _resize_ac(x, h, w, r):
    return r(F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True))


def dpt(sd, taps, grid, out_hw, cfg, r):
    """The DPT head: depth, confidence (ray maps are not used by the SLAM path)."""
    hp, wp = grid
    n_prefix = 1 + cfg["num_register_tokens"]
    stages = []
    for k, tap in enumerate(taps):
        t = tap[:, n_prefix:, :]
        f = _conv(sd, f"depth_head.projects.{k}", t.reshape(t.shape[0], hp, wp, -1).permute(0, 3, 1, 2), r)
        if k in (0, 1):
            name = f"depth_head.resize_layers.{k}"
            f = r(F.conv_transpose2d(f, r(sd[name + ".weight"]), r(sd[name + ".bias"]),
                                     stride=4 if k == 0 else 2))
        elif k == 3:
            f = _conv(sd, "depth_head.resize_layers.3", f, r, stride=2)
        stages.append(_conv(sd, f"depth_head.scratch.layer{k + 1}_rn", f, r))
    rn = "depth_head.scratch.refinenet"
    y = _rcu(sd, f"{rn}4.resConfUnit2", stages[3], r)
    for k in (2, 1, 0):
        y = _resize_ac(y, stages[k].shape[2], stages[k].shape[3], r)
        y = _conv(sd, f"{rn}{k + 2}.out_conv", y, r)
        x = _rcu(sd, f"{rn}{k + 1}.resConfUnit1", stages[k], r)
        y = _rcu(sd, f"{rn}{k + 1}.resConfUnit2", r(y + x), r)
    y = _resize_ac(y, 2 * stages[0].shape[2], 2 * stages[0].shape[3], r)
    y = _conv(sd, f"{rn}1.out_conv", y, r)
    y = _conv(sd, "depth_head.scratch.output_conv1", y, r)
    y = _resize_ac(y, *out_hw, r)
    y = F.relu(_conv(sd, "depth_head.scratch.output_conv2.0", y, r))
    out = _conv(sd, "depth_head.scratch.output_conv2.2", y, r).permute(0, 2, 3, 1)
    return F.softplus(out[..., 0]), 1.0 + F.softplus(out[..., 1])


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-8)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def se3_inverse(E):
    Rt = E[..., :3, :3].transpose(-1, -2)
    return torch.cat([Rt, -(Rt @ E[..., :3, 3:4])], dim=-1)


def se3_compose(A, B):
    R = A[..., :3, :3] @ B[..., :3, :3]
    t = A[..., :3, :3] @ B[..., :3, 3:4] + A[..., :3, 3:4]
    return torch.cat([R, t], dim=-1)


def camera_head(sd, tokens: torch.Tensor, hw: tuple[int, int], ref_idx: int = 0):
    """Camera tokens ``[N, D]`` → (w2c extrinsics ``[N, 3, 4]`` with the reference
    view at the identity, intrinsics ``[N, 3, 3]``)."""
    f32 = Rounding(torch.float32)
    h = F.gelu(_lin(sd, "camera_head.mlp.fc1", tokens, f32), approximate="tanh")
    h = F.gelu(_lin(sd, "camera_head.mlp.fc2", h, f32), approximate="tanh")
    out = _lin(sd, "camera_head.out", h, f32)
    E = torch.cat([quat_to_rotmat(out[:, 0:4]), out[:, 4:7, None]], dim=-1)
    ext = se3_compose(E, se3_inverse(E[ref_idx])[None])
    H, W = hw
    fx = torch.exp(out[:, 7]) * max(H, W)
    fy = torch.exp(out[:, 8]) * max(H, W)
    cx = (0.5 + 0.1 * torch.tanh(out[:, 9])) * W
    cy = (0.5 + 0.1 * torch.tanh(out[:, 10])) * H
    K = torch.zeros(tokens.shape[0], 3, 3, dtype=tokens.dtype, device=tokens.device)
    K[:, 0, 0], K[:, 0, 2], K[:, 1, 1], K[:, 1, 2], K[:, 2, 2] = fx, cx, fy, cy, 1.0
    return ext, K


def forward(sd: dict, cfg: dict, raw: torch.Tensor, process_res: int = 504,
            act: torch.dtype = torch.float32) -> dict:
    """One chunk of uint8 views ``[N, H, W, 3]`` → depth, conf, extrinsics,
    intrinsics (reference view 0) and retrieval descriptors, activations
    stored in ``act``."""
    r = Rounding(act)
    x = preprocess(raw, process_res, cfg["patch_size"])
    taps, final, grid = encode(sd, x, cfg, r)
    depth, conf = dpt(sd, taps, grid, (x.shape[1], x.shape[2]), cfg, r)
    ext, K = camera_head(sd, final[:, 0, :], (x.shape[1], x.shape[2]))
    # the retrieval descriptor: L2-normalised mean of the final patch tokens
    pooled = final[:, 1 + cfg["num_register_tokens"]:, :].mean(dim=1)
    desc = pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)
    return {"depth": depth, "conf": conf, "extrinsics": ext, "intrinsics": K, "frame_desc": desc}


def _median(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def metric_scale(any_depth, any_conf, metric_depth, metric_conf, eps: float = 1e-6):
    """Median of ``metric / anyview`` depth over pixels confident in both
    branches (confidence at or above each branch's median); 1 when none."""
    a, m, ca, cm = (t.reshape(-1) for t in (any_depth, metric_depth, any_conf, metric_conf))
    valid = (a > eps) & (m > eps) & (ca >= _median(ca)) & (cm >= _median(cm))
    ratio = (m / a.clamp_min(eps))[valid]
    if ratio.numel() == 0:
        return torch.ones((), dtype=a.dtype, device=a.device)
    s = _median(ratio)
    return s if bool(torch.isfinite(s)) and float(s) > 0 else torch.ones_like(s)


def forward_nested(sd_any: dict, cfg_any: dict, sd_metric: dict, cfg_metric: dict,
                   raw: torch.Tensor, process_res: int = 504,
                   act: torch.dtype = torch.float32) -> dict:
    """The nested tier: the any-view chunk, then the metric model on the
    reference view; depth and extrinsic translations times the metric scale."""
    out = forward(sd_any, cfg_any, raw, process_res, act)
    mono = forward(sd_metric, cfg_metric, raw[0:1], process_res, act)
    s = metric_scale(out["depth"][0], out["conf"][0], mono["depth"][0], mono["conf"][0])
    ext = out["extrinsics"].clone()
    ext[:, :, 3] *= s
    return {**out, "depth": out["depth"] * s, "extrinsics": ext, "metric_scale": s}
