"""Plain VGGT forward over a state dict (VGGT's names): the benchmark's
reference for the ``vggt`` kind's outputs.

Written from VGGT's equations (github.com/facebookresearch/vggt,
arXiv:2503.11651), not from the port's code: the DINOv2 ViT-L/14 patch embed
with 4 registers; the aggregator's camera and register tokens (the first
view's pair its own), 24 frame and 24 global blocks alternating, each
attention with QK-norm (LayerNorm over each head's channels, eps 1e-5) and 2D
RoPE at frequency 100 (the y and x halves of each head, channel j with
j + D/4, at the patch's row or column counted from 1, special tokens at 0,
global blocks at each token's position within its own view); taps ``[frame_i
‖ global_i]``; the DPT head with a LayerNorm over each tap, the uv sin-cos
embedding (``create_uv_grid`` and ``position_grid_to_embed`` at ω₀ = 100,
scaled by 0.1) after each projection and after the last resize, ``exp``
depth and ``1 + exp`` confidence; the camera head's 4 adaLN-modulated trunk
iterations from the same layer-normed camera tokens, decoded as
``absT_quaR_FoV``.

Precision as the configuration states it, and as ``model.py`` computes: every
operation in float32 (the caller turns TF32 off), activations rounded to
``act`` where the port stores them in that dtype, QK-norm's output rotated
in float32 and rounded once, the camera head in float32; attention is plain
softmax in float32 in blocks of query rows.

Departures from VGGT, as in the port: the point and track heads are left out;
the extrinsics are re-anchored to the first view; ``frame_desc`` (which
VGGT has not) is the L2-normalised mean of the last tap's patch tokens; the
uv grid is made in float64 (VGGT's in the maps' dtype).  Imports torch and
the helpers of ``model.py`` only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import model as base

DINO_EPS = 1e-6  # DINOv2's LayerNorms
TORCH_EPS = 1e-5  # VGGT's own LayerNorms (torch's default), QK-norm included
ADALN_EPS = 1e-6
UV_OMEGA0 = 100.0
UV_RATIO = 0.1


def _ln(sd, name, x, r, eps):
    """LayerNorm in float32, its output stored in the activation dtype."""
    return r(F.layer_norm(x, (x.shape[-1],), sd[name + ".weight"], sd[name + ".bias"], eps))


def _residual(sd, name, h, branch, r):
    return r(h + r(branch * r(sd[name])))


def _block(sd, p, x, r, eps, attend):
    """Pre-norm block: attention and exact-GELU MLP with LayerScale."""
    qkv = base._lin(sd, p + ".attn.qkv", _ln(sd, p + ".norm1", x, r, eps), r)
    a = base._lin(sd, p + ".attn.proj", r(attend(qkv)), r)
    x = _residual(sd, p + ".ls1.gamma", x, a, r)
    y = _ln(sd, p + ".norm2", x, r, eps)
    m = base._lin(sd, p + ".mlp.fc2", r(F.gelu(base._lin(sd, p + ".mlp.fc1", y, r))), r)
    return _residual(sd, p + ".ls2.gamma", x, m, r)


def _heads(qkv, H):
    B, S, D3 = qkv.shape
    D = D3 // 3
    return [t.reshape(B, S, H, D // H) for t in qkv.split(D, dim=-1)]


def _plain_attention(H):
    def attend(qkv):
        q, k, v = _heads(qkv, H)
        return base.attention(q, k, v).flatten(-2)
    return attend


def rope(x, pos_y, pos_x, freq):
    """2D RoPE of ``x [..., P, H, hd]`` at positions ``pos_y``, ``pos_x``
    ``[P]``: channels [0, hd/2) by the row, [hd/2, hd) by the column; within
    each half channel j < hd/4 pairs with j + hd/4."""
    hd = x.shape[-1]
    half, q = hd // 2, hd // 4
    inv = freq ** (-torch.arange(q, dtype=torch.float64, device=x.device) / q)
    out = []
    for axis, pos in enumerate((pos_y, pos_x)):
        seg = x[..., axis * half:(axis + 1) * half]
        a, b = seg[..., :q], seg[..., q:]
        ang = pos.to(torch.float64)[:, None] * inv[None, :]
        c = torch.cos(ang).float()[:, None, :]  # [P, 1, q]: over the heads
        s = torch.sin(ang).float()[:, None, :]
        out += [a * c - b * s, b * c + a * s]
    return torch.cat(out, dim=-1)


def _qk_attention(sd, p, H, pos, freq, is_global, r):
    """A frame (within each view) or global (all views as one sequence)
    attention with QK-norm and 2D RoPE, on ``qkv [N, P, 3D]``."""
    def attend(qkv):
        N, P, _ = qkv.shape
        q, k, v = _heads(qkv, H)
        hd = q.shape[-1]
        q = r(rope(F.layer_norm(q, (hd,), sd[p + ".attn.q_norm.weight"],
                                sd[p + ".attn.q_norm.bias"], TORCH_EPS), *pos, freq))
        k = r(rope(F.layer_norm(k, (hd,), sd[p + ".attn.k_norm.weight"],
                                sd[p + ".attn.k_norm.bias"], TORCH_EPS), *pos, freq))
        if is_global:
            q, k, v = (t.reshape(1, N * P, H, hd) for t in (q, k, v))
        return base.attention(q, k, v).reshape(N, P, -1)
    return attend


def patch_embed(sd, images, cfg, r):
    """DINOv2 over each view → its final-norm patch tokens and the grid."""
    pe = "aggregator.patch_embed."
    N, Hh, Ww, _ = images.shape
    P, D = cfg["patch_size"], cfg["embed_dim"]
    hp, wp = Hh // P, Ww // P
    x = r(F.conv2d(r(images.permute(0, 3, 1, 2)), r(sd[pe + "patch_embed.proj.weight"]),
                   r(sd[pe + "patch_embed.proj.bias"]), stride=P)).flatten(2).transpose(1, 2)
    G = cfg["base_grid"]
    pos = sd[pe + "pos_embed"][0, 1:].reshape(G, G, D)
    if (G, G) != (hp, wp):
        pos = F.interpolate(pos.permute(2, 0, 1)[None], size=(hp, wp), mode="bicubic",
                            align_corners=False, antialias=True)[0].permute(1, 2, 0)
    x = r(x + r(pos.reshape(1, hp * wp, D)))
    cls = r(r(sd[pe + "cls_token"]) + r(sd[pe + "pos_embed"][:, :1]))
    R = cfg["num_register_tokens"]
    x = torch.cat([cls.expand(N, 1, D), r(sd[pe + "register_tokens"]).expand(N, R, D), x], dim=1)
    attend = _plain_attention(cfg["num_heads"])
    for i in range(cfg["dino_depth"]):
        x = _block(sd, f"{pe}blocks.{i}", x, r, DINO_EPS, attend)
    return _ln(sd, pe + "norm", x, r, DINO_EPS)[:, 1 + R:], (hp, wp)


def aggregate(sd, images, cfg, r):
    """Taps ``{i: [N, S, 2D]}`` of the depth head's block pairs and the last
    one, and the grid."""
    patches, (hp, wp) = patch_embed(sd, images, cfg, r)
    N = patches.shape[0]
    cam, reg = r(sd["aggregator.camera_token"][0]), r(sd["aggregator.register_token"][0])
    first = torch.cat([cam[0], reg[0]])[None]
    others = torch.cat([cam[1], reg[1]])[None].expand(N - 1, -1, -1)
    x = torch.cat([torch.cat([first, others]), patches], dim=1)
    n_special = 1 + cfg["num_register_tokens"]
    dev = images.device
    zeros = torch.zeros(n_special, device=dev)
    pos_y = torch.cat([zeros, torch.arange(hp, device=dev).repeat_interleave(wp) + 1.0])
    pos_x = torch.cat([zeros, torch.arange(wp, device=dev).repeat(hp) + 1.0])
    H, freq = cfg["num_heads"], cfg["rope_freq"]
    keep = set(cfg["dpt_layers"]) | {cfg["depth"] - 1}
    taps = {}
    for i in range(cfg["depth"]):
        fp, gp = f"aggregator.frame_blocks.{i}", f"aggregator.global_blocks.{i}"
        f = _block(sd, fp, x, r, TORCH_EPS, _qk_attention(sd, fp, H, (pos_y, pos_x), freq,
                                                          False, r))
        x = _block(sd, gp, f, r, TORCH_EPS, _qk_attention(sd, gp, H, (pos_y, pos_x), freq,
                                                          True, r))
        if i in keep:
            taps[i] = torch.cat([f, x], dim=-1)
    return taps, (hp, wp)


def _sincos(d, pos):
    """VGGT's ``make_sincos_pos_embed``: ``[n, d]`` = sin ‖ cos of
    ``pos · ω₀^(−i / (d/2))``."""
    omega = torch.arange(d // 2, dtype=torch.float64, device=pos.device) / (d / 2.0)
    out = pos.reshape(-1)[:, None] * (1.0 / UV_OMEGA0 ** omega)[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def uv_embed(h, w, c, aspect, device):
    """VGGT's ``create_uv_grid`` → ``position_grid_to_embed``: ``[c, h, w]``
    float32 (x's channels first, then y's)."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, steps=w, dtype=torch.float64,
                        device=device)
    ys = torch.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, steps=h, dtype=torch.float64,
                        device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")  # [h, w]
    emb = torch.cat([_sincos(c // 2, uu), _sincos(c // 2, vv)], dim=-1).reshape(h, w, c)
    return emb.permute(2, 0, 1).float()


def _add_uv(x, aspect, r):
    _, c, h, w = x.shape
    return r(x + r(UV_RATIO * uv_embed(h, w, c, aspect, x.device))[None])


def _conv_no_bias(sd, name, x, r):
    w = sd[name + ".weight"]
    return r(F.conv2d(x, r(w), None, padding=w.shape[-1] // 2))


def dpt(sd, taps, grid, out_hw, n_prefix, r):
    """VGGT's depth head: depth = exp(y₀), conf = 1 + exp(y₁)."""
    hp, wp = grid
    H, W = out_hw
    aspect = W / H
    stages = []
    for k, tap in enumerate(taps):
        t = _ln(sd, "depth_head.norm", tap[:, n_prefix:, :], r, TORCH_EPS)
        f = base._conv(sd, f"depth_head.projects.{k}",
                       t.reshape(t.shape[0], hp, wp, -1).permute(0, 3, 1, 2), r)
        f = _add_uv(f, aspect, r)
        if k in (0, 1):
            name = f"depth_head.resize_layers.{k}"
            f = r(F.conv_transpose2d(f, r(sd[name + ".weight"]), r(sd[name + ".bias"]),
                                     stride=4 if k == 0 else 2))
        elif k == 3:
            f = base._conv(sd, "depth_head.resize_layers.3", f, r, stride=2)
        stages.append(_conv_no_bias(sd, f"depth_head.scratch.layer{k + 1}_rn", f, r))
    rn = "depth_head.scratch.refinenet"
    y = base._rcu(sd, f"{rn}4.resConfUnit2", stages[3], r)
    for k in (2, 1, 0):
        y = base._resize_ac(y, stages[k].shape[2], stages[k].shape[3], r)
        y = base._conv(sd, f"{rn}{k + 2}.out_conv", y, r)
        x = base._rcu(sd, f"{rn}{k + 1}.resConfUnit1", stages[k], r)
        y = base._rcu(sd, f"{rn}{k + 1}.resConfUnit2", r(y + x), r)
    y = base._resize_ac(y, 2 * stages[0].shape[2], 2 * stages[0].shape[3], r)
    y = base._conv(sd, f"{rn}1.out_conv", y, r)
    y = base._conv(sd, "depth_head.scratch.output_conv1", y, r)
    y = _add_uv(base._resize_ac(y, H, W, r), aspect, r)
    y = F.relu(base._conv(sd, "depth_head.scratch.output_conv2.0", y, r))
    out = base._conv(sd, "depth_head.scratch.output_conv2.2", y, r)
    return torch.exp(out[:, 0]), 1.0 + torch.exp(out[:, 1])


def quat_xyzw_to_rotmat(q):
    """Scalar-last quaternion → rotation (VGGT's ``quat_to_mat``: 2 / |q|²)."""
    x, y, z, w = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    return torch.stack([
        torch.stack([1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w)], -1),
        torch.stack([two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w)], -1),
        torch.stack([two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y)], -1),
    ], dim=-2)


def camera_head(sd, tokens, cfg, hw):
    """Camera tokens ``[N, 2D]`` of the last tap → (w2c ``[N, 3, 4]`` with the
    first view at the identity, intrinsics ``[N, 3, 3]``), in float32."""
    f32 = base.Rounding(torch.float32)
    ch = "camera_head."
    C = tokens.shape[-1]
    t = _ln(sd, ch + "token_norm", tokens, f32, TORCH_EPS)
    t0 = F.layer_norm(t, (C,), eps=ADALN_EPS)
    attend = _plain_attention(cfg["camera_heads"])
    pose = None
    for _ in range(cfg["camera_iters"]):
        inp = sd[ch + "empty_pose_tokens"][0].expand(t.shape[0], -1) if pose is None else pose
        m = base._lin(sd, ch + "embed_pose", inp, f32)
        shift, scale, gate = base._lin(sd, ch + "poseLN_modulation.1", F.silu(m), f32).chunk(3, -1)
        u = (t + gate * (t0 * (1 + scale) + shift))[None]
        for j in range(cfg["camera_depth"]):
            u = _block(sd, f"{ch}trunk.{j}", u, f32, TORCH_EPS, attend)
        h = F.gelu(base._lin(sd, ch + "pose_branch.fc1", _ln(sd, ch + "trunk_norm", u[0], f32,
                                                                TORCH_EPS), f32))
        delta = base._lin(sd, ch + "pose_branch.fc2", h, f32)
        pose = delta if pose is None else pose + delta
    H, W = hw
    fov = F.relu(pose[:, 7:9])
    E = torch.cat([quat_xyzw_to_rotmat(pose[:, 3:7]), pose[:, 0:3, None]], dim=-1)
    ext = base.se3_compose(E, base.se3_inverse(E[0])[None])
    K = torch.zeros(tokens.shape[0], 3, 3, dtype=tokens.dtype, device=tokens.device)
    K[:, 0, 0] = (W / 2.0) / torch.tan(fov[:, 1] / 2.0)
    K[:, 1, 1] = (H / 2.0) / torch.tan(fov[:, 0] / 2.0)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2.0, H / 2.0, 1.0
    return ext, K


def forward(sd: dict, cfg: dict, raw: torch.Tensor, process_res: int = 504,
            act: torch.dtype = torch.float32) -> dict:
    """One chunk of uint8 views ``[N, H, W, 3]`` → depth, conf, extrinsics,
    intrinsics (the first view at the identity) and retrieval descriptors,
    activations stored in ``act``."""
    r = base.Rounding(act)
    x = base.preprocess(raw, process_res, cfg["patch_size"])
    taps, grid = aggregate(sd, x, cfg, r)
    n_prefix = 1 + cfg["num_register_tokens"]
    depth, conf = dpt(sd, [taps[i] for i in cfg["dpt_layers"]], grid, (x.shape[1], x.shape[2]),
                      n_prefix, r)
    last = taps[cfg["depth"] - 1]
    ext, K = camera_head(sd, last[:, 0], cfg, (x.shape[1], x.shape[2]))
    pooled = last[:, n_prefix:, :].mean(dim=1)
    desc = pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)
    return {"depth": depth, "conf": conf, "extrinsics": ext, "intrinsics": K, "frame_desc": desc}

