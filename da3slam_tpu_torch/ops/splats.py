"""3DGS refinement and training over a splat cloud (counterpart of
``da3slam_tpu/ops/splats.py``).

``refine_splats`` optimizes splat positions, colors and opacity for
multi-view consistency without rendering: each splat projects into every
view, its depth must match the view's depth map (a splat in front of the
surface is a floater; one far behind it is occluded there and masked out),
its color must match what the views see (Huber), and opacity follows the
share of views that agree.  ``train_splats`` optimizes every attribute
against the rendered-vs-observed photometric loss through the tile
rasterizer (``ops/rasterize.py``), with optional fixed-budget densification.

Both are Adam over Python loops of steps on the tensors' device, with
optax's update (``_Adam``); no step reads back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from da3slam_tpu_torch.core.geometry import median, project_points
from da3slam_tpu_torch.core.transforms import highest_precision


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi), whose gradient at a bound is 1/2
    (``torch.clamp`` passes 1).  Colors read from uint8 sit at 0 and 1."""
    def bound(v):  # a fill on the device, not an upload
        return torch.full((), v, dtype=x.dtype, device=x.device)

    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


class _Adam:
    """``optax.adam`` group by group over a dict of parameters: the moments
    ``mu``, ``nu`` stay reachable (densify zeroes rows of them), and each
    group's step is ``-lr · m̂ / (√v̂ + eps)`` times an optional device
    tensor (the scene scale of the positions), read by no host."""

    def __init__(self, params: dict, lrs: dict, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lrs, self.b1, self.b2, self.eps = lrs, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, scale: dict | None = None) -> None:
        """Update ``params`` in place; ``scale[name]`` multiplies that group's step."""
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            u = -self.lrs[k] * u
            if scale is not None and k in scale:
                u = u * scale[k]
            p.add_(u)


def _bilinear(imgs: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample ``imgs [V, H, W]`` or ``[V, H, W, C]`` at ``uv [V, G, 2]``
    (u = column, v = row), clamped to the border → ``[V, G]`` or ``[V, G, C]``."""
    V, H, W = imgs.shape[:3]
    u = _clip(uv[..., 0], 0.0, W - 1.0)
    v = _clip(uv[..., 1], 0.0, H - 1.0)
    u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, W - 2)
    v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 2)
    fu = u - u0
    fv = v - v0
    flat = imgs.reshape(V * H * W, *imgs.shape[3:])
    base = torch.arange(V, device=imgs.device)[:, None] * (H * W) + v0 * W + u0
    if imgs.ndim == 4:
        fu, fv = fu[..., None], fv[..., None]
    g00, g01 = flat[base], flat[base + 1]
    g10, g11 = flat[base + W], flat[base + W + 1]
    top = g00 * (1 - fu) + g01 * fu
    bot = g10 * (1 - fu) + g11 * fu
    return top * (1 - fv) + bot * fv


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample ``img [H, W]`` or ``[H, W, C]`` at continuous pixel coords
    ``uv [G, 2]`` (u = column, v = row), clamped to the border."""
    return _bilinear(img[None], uv[None])[0]


class RefineResult(NamedTuple):
    points: torch.Tensor   # [G, 3]
    colors: torch.Tensor   # [G, 3] float in [0, 1]
    opacity: torch.Tensor  # [G] in (0, 1)
    support: torch.Tensor  # [G] share of views that see the splat consistently
    losses: torch.Tensor   # [iters] total loss trace


def _view_terms(pts, colors, depth_maps, images, K, E, occl_margin, huber_delta):
    """Residual terms of all splats in all views ``[V, G]``: (geo, photo,
    visible, consistent)."""
    V = depth_maps.shape[0]
    uv, z = project_points(pts[None].expand(V, -1, -1), K, E)
    H, W = depth_maps.shape[1:]
    inb = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= W - 1.0)
           & (uv[..., 1] >= 0.0) & (uv[..., 1] <= H - 1.0) & (z > 1e-6))
    d_obs = _bilinear(depth_maps, uv)
    valid = inb & (d_obs > 1e-6)
    r = (z - d_obs) / torch.clamp_min(d_obs, 1e-6)
    # r << 0: the splat floats in front of the surface, penalised;
    # r >> 0: the surface hides the splat, no evidence, masked out
    occluded = r > occl_margin
    visible = valid & ~occluded

    ah = torch.abs(r)
    geo = torch.where(ah <= huber_delta, 0.5 * r * r / huber_delta, ah - 0.5 * huber_delta)
    # the photometric term trains colors only: a position gradient through
    # the projection would drag splats toward pixels that match their
    # still-converging colors
    c_obs = _bilinear(images, uv.detach())                      # [V, G, 3]
    photo = torch.sum(torch.abs(colors - c_obs), dim=-1)
    w = visible.float()
    # support counts consistent views, not merely unoccluded ones: a floater
    # in front of the surface is visible everywhere
    cons = (visible & (ah <= occl_margin)).float()
    return geo * w, photo * w, w, cons


def _as_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 → float in [0, 1]; anything else → float32."""
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


def refine_splats(
    points: torch.Tensor,      # [G, 3] world
    colors: torch.Tensor,      # [G, 3] float in [0, 1] (or uint8)
    opacity: torch.Tensor,     # [G] in (0, 1)
    depth_maps: torch.Tensor,  # [V, H, W]
    images: torch.Tensor,      # [V, H, W, 3] float in [0, 1] (or uint8)
    K: torch.Tensor,           # [V, 3, 3]
    extrinsics: torch.Tensor,  # [V, 3, 4] w2c
    iters: int = 60,
    lr_points_rel: float = 3e-4,
    lr_colors: float = 2e-2,
    lr_opacity: float = 5e-2,
    occl_margin: float = 0.05,
    huber_delta: float = 0.02,
    photo_weight: float = 0.2,
    support_weight: float = 0.1,
) -> RefineResult:
    """Optimize splat positions, colors and opacity for multi-view
    consistency (module docstring), on the tensors' device.

    Adam steps about ``lr`` per parameter, so positions step at
    ``lr_points_rel × median scene depth`` (world units), colors in [0, 1],
    opacity in logit units.  The scene depth is ``jnp.median`` over every
    pixel with pixels ≤ 1e-6 as NaN, then NaN → 1: one such pixel makes the
    scale 1.0, as in the JAX package."""
    images = _as_float(images)
    colors = _as_float(colors)
    depth_maps = depth_maps.float()
    eps = 1e-6
    op0 = torch.clamp(opacity.float(), eps, 1 - eps)
    params = {"points": points.float().clone(), "colors": colors.clone(),
              "logit_op": torch.log(op0 / (1 - op0))}
    for p in params.values():
        p.requires_grad_(True)

    def loss_fn():
        geo, photo, w, cons = _view_terms(params["points"], params["colors"], depth_maps,
                                          images, K, extrinsics, occl_margin, huber_delta)
        nvis = torch.clamp_min(w.sum(0), 1.0)
        op = torch.sigmoid(params["logit_op"])
        support = cons.mean(0)
        # data terms are not opacity-weighted ("everything transparent" would
        # be their minimum); opacity follows the stop-gradiented support
        sg = support.detach()
        op_target = op * (1.0 - sg) + (1.0 - op) * sg
        loss = (torch.mean(geo.sum(0) / nvis) + photo_weight * torch.mean(photo.sum(0) / nvis)
                + support_weight * torch.mean(op_target))
        return loss, support

    scene_scale = median(torch.where(depth_maps > 1e-6, depth_maps, torch.nan))
    scene_scale = torch.nan_to_num(scene_scale, nan=1.0)
    opt = _Adam(params, {"points": lr_points_rel, "colors": lr_colors, "logit_op": lr_opacity})
    losses = []
    for _ in range(iters):
        loss, _ = loss_fn()
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.step(params, dict(zip(params, grads)), scale={"points": scene_scale})
        losses.append(loss.detach())
    with torch.no_grad():
        _, support = loss_fn()
        return RefineResult(
            points=params["points"].detach(),
            colors=torch.clamp(params["colors"], 0.0, 1.0),
            opacity=torch.sigmoid(params["logit_op"]),
            support=support,
            losses=torch.stack(losses) if losses else torch.zeros(0, device=points.device),
        )


def _gaussian_window(window: int, sigma: float, device) -> torch.Tensor:
    r = window // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


@highest_precision()
def ssim(a: torch.Tensor, b: torch.Tensor, window: int = 11, sigma: float = 1.5,
         c1: float = 0.01**2, c2: float = 0.03**2) -> torch.Tensor:
    """Mean SSIM between ``[H, W, C]`` images in [0, 1]: the gaussian window
    as two depthwise ``F.conv2d`` passes with zero padding."""
    r = window // 2
    g = _gaussian_window(window, sigma, a.device)
    C = a.shape[-1]
    kh = g.view(1, 1, -1, 1).repeat(C, 1, 1, 1)   # [C, 1, w, 1]
    kw = g.view(1, 1, 1, -1).repeat(C, 1, 1, 1)   # [C, 1, 1, w]

    def blur(img):  # [H, W, C] → gaussian-filtered, same shape
        z = img.permute(2, 0, 1)[None]             # [1, C, H, W]
        z = F.conv2d(z, kh, padding=(r, 0), groups=C)
        z = F.conv2d(z, kw, padding=(0, r), groups=C)
        return z[0].permute(1, 2, 0)

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a**2
    var_b = blur(b * b) - mu_b**2
    cov = blur(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return torch.mean(s)


class TrainResult(NamedTuple):
    points: torch.Tensor   # [G, 3]
    scales: torch.Tensor   # [G, 3] per-axis radii (σ)
    quats: torch.Tensor    # [G, 4] (w,x,y,z), unit
    colors: torch.Tensor   # [G, 3] in [0, 1]
    opacity: torch.Tensor  # [G] in (0, 1)
    losses: torch.Tensor   # [iters] photometric loss trace


def jitter_directions(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """The densify step's one random draw: ``[n, 3]`` standard normals."""
    return torch.randn(n, 3, generator=generator, device=device)


def _resample(params: dict, opt: _Adam, grad_ema: torch.Tensor, prune_opacity: float,
              generator: torch.Generator) -> torch.Tensor:
    """Fixed-budget densify, in place: slots whose opacity fell below
    ``prune_opacity`` take shrunk, jittered clones of the live splats with
    the largest position-gradient average (the i-th dead slot the i-th
    best), and their Adam moments are zeroed.  Returns the new average."""
    G = grad_ema.shape[0]
    dead = torch.sigmoid(params["logit_op"]) < prune_opacity
    score = torch.where(dead, -torch.inf, grad_ema)
    donors = torch.argsort(-score, stable=True)                 # best first
    dead_rank = torch.cumsum(dead.to(torch.int64), 0) - 1
    src = donors[torch.clamp(dead_rank, 0, G - 1)]
    jit_dir = jitter_directions(G, generator, grad_ema.device)
    sigma = torch.exp(params["log_scales"][src])                # donor σ, axis-aligned

    def mix(dst, donor_val):
        return torch.where(dead.view((G,) + (1,) * (dst.ndim - 1)), donor_val, dst)

    # the clone lands one donor-σ away at 1/1.6 the donor's scale (the 3DGS
    # split ratio), its opacity raised to at least 0.1
    new = {
        "points": mix(params["points"], params["points"][src] + jit_dir * sigma),
        "log_scales": mix(params["log_scales"], params["log_scales"][src] - math.log(1.6)),
        "quats": mix(params["quats"], params["quats"][src]),
        "colors": mix(params["colors"], params["colors"][src]),
        "logit_op": mix(params["logit_op"],
                        torch.clamp_min(params["logit_op"][src], math.log(0.1 / 0.9))),
    }
    for k, v in new.items():
        params[k].copy_(v)
        opt.mu[k] = mix(opt.mu[k], torch.zeros_like(opt.mu[k]))
        opt.nu[k] = mix(opt.nu[k], torch.zeros_like(opt.nu[k]))
    return torch.where(dead, 0.0, grad_ema)


def train_splats(
    points: torch.Tensor,      # [G, 3] world
    scales: torch.Tensor,      # [G] or [G, 3] radii (σ, world units)
    quats: torch.Tensor,       # [G, 4] (w,x,y,z)
    colors: torch.Tensor,      # [G, 3] float [0,1] or uint8
    opacity: torch.Tensor,     # [G] in (0, 1)
    images: torch.Tensor,      # [V, H, W, 3] float [0,1] or uint8
    K: torch.Tensor,           # [V, 3, 3]
    extrinsics: torch.Tensor,  # [V, 3, 4] w2c
    img_hw: tuple[int, int],
    iters: int = 100,
    tile: int = 16,
    max_per_tile: int = 256,
    fan: int = 5,
    lr_points_rel: float = 2e-4,
    lr_scales: float = 5e-3,
    lr_quats: float = 1e-3,
    lr_colors: float = 2.5e-2,
    lr_opacity: float = 5e-2,
    scale_reg: float = 0.01,
    ssim_weight: float = 0.2,
    densify_every: int = 0,
    prune_opacity: float = 0.02,
    seed: int = 0,
) -> TrainResult:
    """Optimize every splat attribute against the rendered-vs-observed
    photometric loss through the tile rasterizer, on the tensors' device.

    Loss = (1 − ssim_weight)·L1 + ssim_weight·(1 − SSIM)/2 over the views,
    plus a soft scale regulariser that keeps footprints inside the binner's
    ``fan``.  Each view's render is differentiated and freed before the next
    (its share of the loss backpropagated alone, the gradients summed), so
    one view's ``[tiles, K, px]`` tensors are alive at a time.

    ``densify_every > 0`` resamples every ``densify_every`` steps, at a fixed
    budget G: splats whose opacity fell below ``prune_opacity`` become
    jittered, shrunk clones of the splats with the largest position
    gradients, their Adam moments reset.  The jitter comes from a
    ``torch.Generator`` seeded with ``seed`` (``jitter_directions``)."""
    from da3slam_tpu_torch.ops.rasterize import rasterize

    images = _as_float(images)
    colors = _as_float(colors)
    if scales.ndim == 1:
        scales = scales[:, None] * torch.ones(1, 3, device=scales.device)
    eps = 1e-6
    op0 = torch.clamp(opacity.float(), eps, 1 - eps)
    params = {
        "points": points.float().clone(),
        "log_scales": torch.log(torch.clamp_min(scales.float(), 1e-8)),
        "quats": quats.float().clone(),
        "colors": colors.clone(),
        "logit_op": torch.log(op0 / (1 - op0)),
    }
    for p in params.values():
        p.requires_grad_(True)

    # footprint cap of the scale regulariser: a 3σ radius past ~fan/2 tiles
    # starts being truncated by the binner
    pts0 = points.float()
    depth_med = median(torch.linalg.vector_norm(pts0 - pts0.mean(0), dim=-1))
    f_px = torch.mean(K[:, 0, 0])
    max_sigma = torch.clamp_min((fan / 2) * tile / 3.0 * depth_med / f_px, 1e-6)
    V = images.shape[0]

    def view_loss(v: int) -> torch.Tensor:
        rgb, _, _ = rasterize(
            params["points"], torch.exp(params["log_scales"]), params["quats"],
            _clip(params["colors"], 0.0, 1.0), torch.sigmoid(params["logit_op"]),
            K[v], extrinsics[v], img_hw, tile=tile, max_per_tile=max_per_tile, fan=fan)
        l1 = torch.mean(torch.abs(rgb - images[v]))
        if ssim_weight == 0.0:
            return l1
        return (1.0 - ssim_weight) * l1 + ssim_weight * 0.5 * (1.0 - ssim(rgb, images[v]))

    scene_scale = torch.clamp_min(depth_med, 1e-6)
    opt = _Adam(params, {"points": lr_points_rel, "log_scales": lr_scales, "quats": lr_quats,
                         "colors": lr_colors, "logit_op": lr_opacity})
    G = points.shape[0]
    grad_ema = torch.zeros(G, dtype=torch.float32, device=points.device)
    generator = torch.Generator(device=points.device).manual_seed(seed)
    losses = []
    for i in range(iters):
        for p in params.values():
            p.grad = None
        photo = torch.zeros((), device=points.device)
        for v in range(V):
            loss_v = view_loss(v) / V
            loss_v.backward()
            photo = photo + loss_v.detach()
        reg = torch.mean(F.relu(params["log_scales"] - torch.log(max_sigma)))
        (scale_reg * reg).backward()
        grads = {k: p.grad for k, p in params.items()}
        opt.step(params, grads, scale={"points": scene_scale})
        with torch.no_grad():
            grad_ema = 0.9 * grad_ema + 0.1 * torch.linalg.vector_norm(grads["points"], dim=-1)
            if densify_every > 0 and i % densify_every == densify_every - 1:
                grad_ema = _resample(params, opt, grad_ema, prune_opacity, generator)
        losses.append(photo)
    with torch.no_grad():
        q = params["quats"]
        return TrainResult(
            points=params["points"].detach(),
            scales=torch.exp(params["log_scales"]),
            quats=q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12),
            colors=torch.clamp(params["colors"], 0.0, 1.0),
            opacity=torch.sigmoid(params["logit_op"]),
            losses=torch.stack(losses) if losses else torch.zeros(0, device=points.device),
        )
