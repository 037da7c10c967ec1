"""Differentiable 3D-Gaussian-splat tile rasterizer (counterpart of
``da3slam_tpu/ops/rasterize.py``).

EWA splatting with fixed shapes, forward and backward on the device, and no
host wait in a render:

  binning    — each splat emits a fixed ``fan × fan`` block of (tile, depth,
               splat) triples over its 3σ footprint (tiles past it drop,
               counted).  One ``torch.sort`` of a single int64 key,
               ``tile << 32 | float bits of depth``, groups the triples by
               tile and orders each tile front to back (every kept depth is
               > near > 0, so its bits order as the float does; dropped
               triples carry tile T and sort last).  A rank scatter packs
               them into a dense ``[tiles, K]`` table: ranks past K go to an
               extra column K, which is then cut off.
  composite  — front-to-back blending as a parallel scan, transmittance
               ``exp(cumsum(log1p(−α)))``, over all tiles at once as
               ``[T, K, P]`` tensors (T tiles, K splats a tile, P pixels a
               tile); autograd differentiates it exactly.

Gradients reach every splat attribute (means, scales, rotations, colors,
opacity) through the gathered per-tile values; the binning indices are
integer scheduling, constant within a step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Projected2D(NamedTuple):
    """Per-view screen-space gaussians (all ``[G, ...]``)."""

    mean2d: torch.Tensor  # [G, 2] pixel coords (u, v)
    conic: torch.Tensor   # [G, 3] inverse 2D covariance (a, b, c): ax²+2bxy+cy²
    depth: torch.Tensor   # [G] camera z
    radius: torch.Tensor  # [G] 3σ footprint radius in pixels (0 = culled)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalised (w, x, y, z) quaternions ``[..., 4]`` → ``[..., 3, 3]``.
    The norm's floor is 1e-12, as in the JAX rasterizer (``core/transforms``
    floors it at 1e-8; training can drive quaternions that small)."""
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def project_gaussians(
    means: torch.Tensor,   # [G, 3] world
    scales: torch.Tensor,  # [G, 3] per-axis radii (σ, world units)
    quats: torch.Tensor,   # [G, 4] (w, x, y, z)
    K: torch.Tensor,       # [3, 3] zero-skew pinhole
    E: torch.Tensor,       # [3, 4] w2c, OpenCV convention
    img_hw: tuple[int, int],
    near: float = 1e-2,
) -> Projected2D:
    """EWA splatting: perspective-project 3D gaussians to screen space.

    Σ_world = R·diag(s²)·Rᵀ;  Σ_2D = J·W·Σ_world·Wᵀ·Jᵀ + 0.3·I, with J the
    projection's Jacobian at the mean and W the camera rotation (the +0.3 px
    dilation is 3DGS's anti-aliasing floor)."""
    H, W_img = img_hw
    M = quat_to_rotmat(quats) * scales[..., None, :]   # R·diag(s)
    cov3d = M @ M.transpose(-1, -2)                    # [G, 3, 3]

    Rc, tc = E[:3, :3], E[:3, 3]
    # camera coords as elementwise products and sums, not a GEMM: the card
    # then rounds each depth as the CPU does, and the depth sort agrees
    t = means[:, 0:1] * Rc[:, 0] + means[:, 1:2] * Rc[:, 1] + means[:, 2:3] * Rc[:, 2] + tc
    z = t[:, 2]
    z_safe = torch.clamp_min(z, near)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = fx * t[:, 0] / z_safe + cx
    v = fy * t[:, 1] / z_safe + cy

    zero = torch.zeros_like(z_safe)
    J = torch.stack([
        torch.stack([fx / z_safe, zero, -fx * t[:, 0] / z_safe**2], -1),
        torch.stack([zero, fy / z_safe, -fy * t[:, 1] / z_safe**2], -1),
    ], dim=-2)                                         # [G, 2, 3]
    JW = J @ Rc                                        # [G, 2, 3]
    cov2d = JW @ cov3d @ JW.transpose(-1, -2)          # [G, 2, 2]
    a = cov2d[:, 0, 0] + 0.3
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + 0.3

    det = torch.clamp_min(a * c - b**2, 1e-12)
    conic = torch.stack([c / det, -b / det, a / det], -1)
    # 3σ of the major axis bounds the footprint
    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    radius = torch.ceil(3.0 * torch.sqrt(lam_max))

    on_screen = ((z > near)
                 & (u + radius >= 0.0) & (u - radius <= W_img - 1.0)
                 & (v + radius >= 0.0) & (v - radius <= H - 1.0))
    radius = torch.where(on_screen, radius, torch.zeros_like(radius))
    return Projected2D(torch.stack([u, v], -1), conic, z, radius)


def _n_tiles(H: int, W: int, tile: int) -> tuple[int, int]:
    return -(-H // tile), -(-W // tile)


def sort_keys(tile_id: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """One int64 key per triple that orders by (tile, depth) as a
    lexicographic sort would, for depths > 0 (the kept triples)."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (tile_id.to(torch.int64) << 32) | bits


@torch.no_grad()
def bin_splats(
    proj: Projected2D,
    img_hw: tuple[int, int],
    tile: int = 16,
    max_per_tile: int = 256,
    fan: int = 5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack splats into a dense front-to-back per-tile table.

    Each splat emits a ``fan × fan`` block of candidate tiles anchored at its
    footprint's top-left tile (larger footprints are truncated).  One sort of
    the (tile, depth) key groups and depth-orders the triples; a triple's
    rank within its tile comes from a ``searchsorted`` of the sorted tile ids.

    Returns ``(table [T, K] int32 splat indices (-1 = empty), overflow [T]
    int32)``.  As in the JAX package, every dropped triple is counted in
    ``overflow[0]`` (its scatter row is the one of a dropped triple), so only
    the sum is per view.
    """
    H, W = img_hw
    ty_n, tx_n = _n_tiles(H, W, tile)
    T = ty_n * tx_n
    K = max_per_tile
    dev = proj.mean2d.device

    u, v = proj.mean2d[:, 0], proj.mean2d[:, 1]
    r = proj.radius
    tx0 = torch.floor((u - r) / tile).to(torch.int64)
    ty0 = torch.floor((v - r) / tile).to(torch.int64)
    tx1 = torch.floor((u + r) / tile).to(torch.int64)
    ty1 = torch.floor((v + r) / tile).to(torch.int64)

    steps = torch.arange(fan, dtype=torch.int64, device=dev)
    cand_ty = ty0[:, None, None] + steps[None, :, None]   # [G, fan, 1]
    cand_tx = tx0[:, None, None] + steps[None, None, :]   # [G, 1, fan]
    valid = ((cand_ty <= ty1[:, None, None]) & (cand_tx <= tx1[:, None, None])
             & (cand_ty >= 0) & (cand_ty < ty_n)
             & (cand_tx >= 0) & (cand_tx < tx_n)
             & (r[:, None, None] > 0.0))                  # [G, fan, fan]
    tile_id = torch.where(valid, cand_ty * tx_n + cand_tx, T).reshape(-1)
    depth = proj.depth[:, None, None].expand(valid.shape).reshape(-1)

    order = torch.sort(sort_keys(tile_id, depth), stable=True).indices
    tile_s = tile_id[order]
    splat_s = (order // (fan * fan)).to(torch.int32)
    starts = torch.searchsorted(tile_s, tile_s, side="left")
    rank = torch.arange(tile_s.shape[0], device=dev) - starts

    binned = tile_s < T
    keep = binned & (rank < K)
    scat_tile = torch.where(keep, tile_s, 0)
    scat_rank = torch.where(keep, rank, K)
    table = torch.full((T * (K + 1),), -1, dtype=torch.int32, device=dev)
    table.scatter_(0, scat_tile * (K + 1) + scat_rank, torch.where(keep, splat_s, -1))
    overflow = torch.zeros(T, dtype=torch.int32, device=dev)
    overflow.scatter_add_(0, scat_tile, (binned & (rank >= K)).to(torch.int32))
    return table.view(T, K + 1)[:, :K], overflow


def _composite(alpha: torch.Tensor, colors: torch.Tensor, bg: torch.Tensor):
    """Front-to-back blend as a parallel scan (module docstring).

    alpha  [..., K, P]   per splat per pixel, already masked and clamped
    colors [..., K, 3]   per splat
    →  rgb [..., P, 3], alpha_out [..., P]
    """
    # exclusive cumulative transmittance: T_k = Π_{j<k} (1 - α_j)
    log_t = torch.cumsum(torch.log1p(-alpha), dim=-2)
    trans = torch.exp(torch.cat([torch.zeros_like(log_t[..., :1, :]), log_t[..., :-1, :]], -2))
    w = alpha * trans                                           # [..., K, P]
    rgb = torch.einsum("...kp,...kc->...pc", w, colors)
    t_final = torch.exp(log_t[..., -1, :])                      # [..., P]
    return rgb + t_final[..., None] * bg, 1.0 - t_final


def _splat_alpha(dx, dy, conic, radius, opacity):
    """α of K splats over P pixels, ``dx, dy [..., K, P]`` the pixel minus the
    mean: the gaussian, clamped to 0.995, cut to the 3σ box (the binner's
    predicate) and to CUDA 3DGS's 1/255 floor, so that the tiled and the
    dense renders share one footprint."""
    power = -0.5 * (conic[..., 0:1] * dx**2
                    + 2.0 * conic[..., 1:2] * dx * dy
                    + conic[..., 2:3] * dy**2)
    alpha = torch.clamp(opacity[..., None] * torch.exp(torch.clamp_max(power, 0.0)), 0.0, 0.995)
    in_foot = (torch.abs(dx) <= radius[..., None]) & (torch.abs(dy) <= radius[..., None])
    return torch.where(in_foot & (alpha >= 1.0 / 255.0), alpha, torch.zeros_like(alpha))


def rasterize(
    means: torch.Tensor,    # [G, 3]
    scales: torch.Tensor,   # [G, 3]
    quats: torch.Tensor,    # [G, 4] (w,x,y,z)
    colors: torch.Tensor,   # [G, 3] in [0, 1]
    opacity: torch.Tensor,  # [G] in (0, 1)
    K: torch.Tensor,        # [3, 3]
    E: torch.Tensor,        # [3, 4] w2c
    img_hw: tuple[int, int],
    bg: torch.Tensor | None = None,
    tile: int = 16,
    max_per_tile: int = 256,
    fan: int = 5,
):
    """Render one view on the tensors' device.  Returns ``(rgb [H, W, 3],
    alpha [H, W], aux dict(overflow [T], n_binned []))``, differentiable
    with respect to every splat attribute; no host wait."""
    H, W = img_hw
    dev = means.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    proj = project_gaussians(means, scales, quats, K, E, img_hw)
    table, overflow = bin_splats(proj, img_hw, tile=tile, max_per_tile=max_per_tile, fan=fan)
    ty_n, tx_n = _n_tiles(H, W, tile)

    valid = table >= 0
    g = torch.clamp_min(table, 0).long()                       # [T, K]
    mu = proj.mean2d[g]                                        # [T, K, 2]
    op = torch.where(valid, opacity[g], torch.zeros((), dtype=opacity.dtype, device=dev))
    offs = torch.arange(tile, dtype=torch.float32, device=dev)
    ty = torch.arange(ty_n, dtype=torch.float32, device=dev)
    tx = torch.arange(tx_n, dtype=torch.float32, device=dev)
    # pixel centers of each tile, row-major inside the tile: [T, P]
    py = (ty[:, None, None, None] * tile + offs[None, None, :, None]).expand(ty_n, tx_n, tile, tile)
    px = (tx[None, :, None, None] * tile + offs[None, None, None, :]).expand(ty_n, tx_n, tile, tile)
    py, px = py.reshape(ty_n * tx_n, 1, -1), px.reshape(ty_n * tx_n, 1, -1)
    alpha = _splat_alpha(px - mu[..., 0:1], py - mu[..., 1:2], proj.conic[g], proj.radius[g], op)
    rgb_t, a_t = _composite(alpha, colors[g], bg)              # [T, P, 3], [T, P]

    rgb = (rgb_t.reshape(ty_n, tx_n, tile, tile, 3).permute(0, 2, 1, 3, 4)
           .reshape(ty_n * tile, tx_n * tile, 3)[:H, :W])
    alpha_img = (a_t.reshape(ty_n, tx_n, tile, tile).permute(0, 2, 1, 3)
                 .reshape(ty_n * tile, tx_n * tile)[:H, :W])
    return rgb, alpha_img, {"overflow": overflow, "n_binned": valid.sum()}


def rasterize_dense(means, scales, quats, colors, opacity, K, E, img_hw, bg=None):
    """Reference renderer: every splat against every pixel, one global depth
    sort, no tiling or truncation.  O(G·H·W): tests and tiny scenes only;
    the oracle the tiled path is held to."""
    H, W = img_hw
    dev = means.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    proj = project_gaussians(means, scales, quats, K, E, img_hw)
    order = torch.argsort(proj.depth, stable=True)
    mu = proj.mean2d[order]
    rad = proj.radius[order]
    op = torch.where(rad > 0.0, opacity[order], torch.zeros_like(opacity[order]))
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    px, py = xx.reshape(1, -1), yy.reshape(1, -1)
    alpha = _splat_alpha(px - mu[:, 0:1], py - mu[:, 1:2], proj.conic[order], rad, op)
    rgb, a = _composite(alpha, colors[order], bg)
    return rgb.reshape(H, W, 3), a.reshape(H, W)
