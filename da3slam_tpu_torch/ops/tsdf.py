"""TSDF volumetric fusion on the device (counterpart of
``da3slam_tpu/ops/tsdf.py``).

A truncated signed distance field updated in place: O(voxels) memory
whatever the sequence length, meshed by ``inout/mesh.py``'s marching
tetrahedra.  Two paths, both plain PyTorch on the grid's device:

  * DENSE (``integrate_frames``): per frame, every voxel center is projected,
    reads its nearest pixel's depth and confidence, and takes the truncated
    observation into a weighted running average.  A Python loop over
    frames; the voxel centers are built once.
  * BLOCK-SPARSE (``integrate_frames_sparse``): the voxel-hashing
    formulation: per frame only the bs³ blocks that can meet a truncation
    band are gathered, updated and scattered back (band-only semantics;
    ``carve`` adds free-space carving of occupied blocks).

Conventions: w2c OpenCV extrinsics and zero-skew pinhole K; sdf is stored in
truncation-normalised units (+1 free space → -1 behind the surface),
weights accumulate confidence.  A voxel reads the pixel ``round(u)``: a
center that projects within rounding of a half pixel can read a
neighbouring pixel in another library, so grids compare equal apart from
such voxels.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch


class TSDFGrid(NamedTuple):
    """Volumetric state, every field a tensor on one device: ``sdf``/``weight``
    are ``[X, Y, Z]`` f32; ``origin`` ``[3]`` is the world position of voxel
    (0,0,0)'s center; ``voxel`` the edge length; ``trunc`` the truncation
    distance (world units); ``color`` (optional) the premultiplied colour
    accumulator ``[X, Y, Z, 4]``: (sum w·rgb, sum w) in 0..255.  Colour keeps
    its own weight sum (near-surface observations only): normalising by the
    sdf weight, which also counts free-space hits, would bias early-seen
    voxels toward black."""

    sdf: torch.Tensor
    weight: torch.Tensor
    origin: torch.Tensor
    voxel: torch.Tensor
    trunc: torch.Tensor
    color: torch.Tensor | None = None


def make_grid(
    origin,
    size_xyz: tuple[int, int, int],
    voxel: float,
    trunc: float | None = None,
    with_color: bool = False,
    device: str | torch.device = "cuda",
) -> TSDFGrid:
    """Fresh grid: sdf=+1 (free), weight=0.  ``trunc`` defaults to 3 voxels."""
    if trunc is None:
        trunc = 3.0 * voxel
    size_xyz = tuple(int(n) for n in size_xyz)

    def scalar(v):
        return torch.full((), float(v), dtype=torch.float32, device=device)

    return TSDFGrid(
        sdf=torch.ones(size_xyz, dtype=torch.float32, device=device),
        weight=torch.zeros(size_xyz, dtype=torch.float32, device=device),
        origin=torch.stack([scalar(v) for v in np.asarray(origin, np.float32)]),
        voxel=scalar(np.float32(voxel)),
        trunc=scalar(np.float32(trunc)),
        color=torch.zeros((*size_xyz, 4), dtype=torch.float32, device=device)
        if with_color else None,
    )


def grid_from_bounds(
    lo, hi, resolution: int = 192, with_color: bool = False,
    device: str | torch.device = "cuda",
) -> TSDFGrid:
    """Grid covering the axis-aligned box [lo, hi] with ``resolution`` voxels
    along the longest axis (shapes derived on the host)."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    extent = np.maximum(hi - lo, 1e-6)
    voxel = float(extent.max() / resolution)
    size = tuple(int(n) for n in np.maximum(np.ceil(extent / voxel), 2).astype(int))
    return make_grid(lo, size, voxel, with_color=with_color, device=device)


def _voxel_centers_world(grid: TSDFGrid) -> torch.Tensor:
    """World voxel centers ``[V, 3]`` (constant across frames: build once)."""
    X, Y, Z = grid.sdf.shape
    dev = grid.sdf.device
    gx, gy, gz = torch.meshgrid(
        torch.arange(X, dtype=torch.float32, device=dev),
        torch.arange(Y, dtype=torch.float32, device=dev),
        torch.arange(Z, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    pts = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
    return pts * grid.voxel + grid.origin


def _transform_points(E_w2c: torch.Tensor, pts_world: torch.Tensor) -> torch.Tensor:
    """Rigid transform of points ``[V, 3]`` by ``E_w2c`` ``[..., 3, 4]`` →
    ``[..., V, 3]``, written elementwise in the JAX package's order (nine
    products and sums, no matmul: the same roundings)."""
    R, t = E_w2c[..., :3, :3], E_w2c[..., :3, 3]
    x, y, z = pts_world[..., 0], pts_world[..., 1], pts_world[..., 2]

    def row(i):
        return (R[..., i, 0, None] * x + R[..., i, 1, None] * y + R[..., i, 2, None] * z
                + t[..., i, None])

    return torch.stack([row(0), row(1), row(2)], dim=-1)


def _observe(z, u, v, depth_flat, conf_flat, hw, trunc, band_only, pix_offset=None):
    """The per-voxel observation shared by both paths: nearest-pixel
    lookup, truncated sdf and its weight.  Returns (sdf_obs, w_obs, flat
    pixel index)."""
    H, W = hw
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    in_img = (z > 1e-6) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    flat = torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)
    if pix_offset is not None:
        flat = flat + pix_offset
    d_pix = depth_flat[flat]
    w_pix = conf_flat[flat]
    sdf_obs = (d_pix - z) / trunc
    valid = in_img & (d_pix > 1e-6) & (sdf_obs > -1.0)
    if band_only:
        valid = valid & (sdf_obs <= 1.0)
    sdf_obs = torch.clamp(sdf_obs, -1.0, 1.0)
    w_obs = torch.where(valid, torch.clamp_min(w_pix, 0.0), torch.zeros_like(w_pix))
    return sdf_obs, w_obs, flat


def _running_average(s_old, w_old, sdf_obs, w_obs, max_weight: float):
    w_new = w_old + w_obs
    s_new = torch.where(w_new > 0.0,
                        (s_old * w_old + sdf_obs * w_obs) / torch.clamp_min(w_new, 1e-12),
                        s_old)
    return s_new, torch.clamp_max(w_new, max_weight)


def integrate(
    grid: TSDFGrid,
    depth: torch.Tensor,  # [H, W]
    conf: torch.Tensor,  # [H, W] (>= 0; used as the observation weight)
    K: torch.Tensor,  # [3, 3]
    E_w2c: torch.Tensor,  # [3, 4]
    max_weight: float = 64.0,
    image: torch.Tensor | None = None,  # [H, W, 3] (needs grid.color)
    pts_world: torch.Tensor | None = None,  # precomputed [V, 3] voxel centers
    band_only: bool = False,
) -> TSDFGrid:
    """Fuse one depth frame into the grid (returns a new grid).

    Per voxel: project its center; voxels that land on a valid pixel with
    positive depth get the truncated SDF observation
    ``clamp((d_pix - z_vox)/trunc, -1, 1)``; observations strictly behind
    the surface (< -1 before clamping) are occluded, not updated.  The
    running average is weighted by ``conf`` and capped at ``max_weight``.

    ``band_only=True`` restricts updates to the truncation band
    (``|d_pix - z_vox| <= trunc``): the voxel-hashing semantics, and the
    exact dense oracle for :func:`integrate_frames_sparse`.
    """
    if pts_world is None:
        pts_world = _voxel_centers_world(grid)
    cam = _transform_points(E_w2c, pts_world)  # [V, 3]
    z = cam[:, 2]
    zs = torch.clamp_min(z, 1e-9)
    u = cam[:, 0] / zs * K[0, 0] + K[0, 2]
    v = cam[:, 1] / zs * K[1, 1] + K[1, 2]
    sdf_obs, w_obs, flat = _observe(z, u, v, depth.reshape(-1), conf.reshape(-1),
                                    depth.shape, grid.trunc, band_only)
    shape = grid.sdf.shape
    s_new, w_new = _running_average(grid.sdf.reshape(-1), grid.weight.reshape(-1),
                                    sdf_obs, w_obs, max_weight)

    color = grid.color
    if color is not None and image is not None:
        c_pix = image.reshape(-1, 3).to(torch.float32)[flat]  # [V, 3]
        # colour only accumulates NEAR the surface (|sdf| < 1): free-space
        # voxels would otherwise average in whatever pixel they project to
        w_col = torch.where(sdf_obs.abs() < 1.0, w_obs, torch.zeros_like(w_obs))[:, None]
        c = color.reshape(-1, 4)
        color = torch.cat([c[:, :3] + c_pix * w_col, c[:, 3:] + w_col], dim=1).reshape(*shape, 4)
    return grid._replace(sdf=s_new.reshape(shape), weight=w_new.reshape(shape), color=color)


def integrate_frames(
    grid: TSDFGrid,
    depth: torch.Tensor,  # [N, H, W]
    conf: torch.Tensor,  # [N, H, W]
    K: torch.Tensor,  # [N, 3, 3]
    E_w2c: torch.Tensor,  # [N, 3, 4]
    max_weight: float = 64.0,
    images: torch.Tensor | None = None,  # [N, H, W, 3] (needs grid.color)
) -> TSDFGrid:
    """Fuse a stack of frames, one :func:`integrate` each."""
    pts_world = _voxel_centers_world(grid)  # constant: built once, not per frame
    for i in range(depth.shape[0]):
        grid = integrate(grid, depth[i], conf[i], K[i], E_w2c[i], max_weight=max_weight,
                         image=None if images is None else images[i], pts_world=pts_world)
    return grid


# ---------------------------------------------------------------------------
# Block-sparse fusion
#
# Per frame: (1) test every bs³ BLOCK against a pooled min/max depth pyramid
# (a conservative truncation-band intersection test), (2) compact the active
# blocks to a FIXED budget (a cumsum gives each active block its slot, one
# scatter writes the ids; overflow and inactive blocks land in one extra slot
# that is cut off), (3) gather just those blocks' sdf/weight rows from the
# blocked grid, run the per-voxel update on budget·bs³ voxels and scatter
# back.  Semantics are band-only (``integrate(band_only=True)`` is the exact
# dense oracle): free-space voxels outside the band keep sdf=+1/w=0.
# ``carve=True`` restores the dense path's free-space carving for OCCUPIED
# blocks (on sdf=+1/w=0 voxels a free-space observation changes nothing).
# Unselected slots hold the sentinel id NB, which decodes to a block outside
# the grid and reads and writes the blocked grid's trailing dummy row: many
# slots write it at once (in no set order), and nothing reads it as grid data.
# ---------------------------------------------------------------------------

_POOL_T0 = 16  # finest min/max depth tile, pixels
_POOL_LEVELS = 4  # coarsest tile = 16 * 2**3 = 128 px


def _depth_minmax_pyramid(depth: torch.Tensor, conf: torch.Tensor | None = None):
    """Per-frame min/max depth pyramids ``[B, L*Ht*Wt, 2]`` of ``[B, H, W]``
    frames for the block activity test.

    Levels l=0..3 pool valid depth over (16·2^l)² pixel tiles; every level
    is replicated back to the finest tile grid so one flat table serves
    per-block level lookups.  Invalid pixels pool to (+inf, -inf), so an
    all-invalid tile meets no band.  ``conf`` tightens validity to
    ``conf > 0`` pixels: a zero-weight observation is a no-op, so this is
    exact."""
    B, H, W = depth.shape
    coarse = _POOL_T0 * 2 ** (_POOL_LEVELS - 1)
    Hp = -(-H // coarse) * coarse
    Wp = -(-W // coarse) * coarse
    valid = depth > 1e-6
    if conf is not None:
        valid = valid & (conf > 0.0)
    inf = torch.full_like(depth, float("inf"))
    dmin = torch.full((B, Hp, Wp), float("inf"), dtype=torch.float32, device=depth.device)
    dmin[:, :H, :W] = torch.where(valid, depth, inf)
    dmax = torch.full((B, Hp, Wp), float("-inf"), dtype=torch.float32, device=depth.device)
    dmax[:, :H, :W] = torch.where(valid, depth, -inf)
    Ht, Wt = Hp // _POOL_T0, Wp // _POOL_T0
    lv_min = dmin.reshape(B, Ht, _POOL_T0, Wt, _POOL_T0).amin(dim=(2, 4))
    lv_max = dmax.reshape(B, Ht, _POOL_T0, Wt, _POOL_T0).amax(dim=(2, 4))
    levels = []
    for lvl in range(_POOL_LEVELS):
        if lvl:
            h, w = lv_min.shape[1:]
            lv_min = lv_min.reshape(B, h // 2, 2, w // 2, 2).amin(dim=(2, 4))
            lv_max = lv_max.reshape(B, h // 2, 2, w // 2, 2).amax(dim=(2, 4))
        rep = 2**lvl

        def up(a):
            return a.repeat_interleave(rep, dim=1).repeat_interleave(rep, dim=2)

        levels.append(torch.stack([up(lv_min), up(lv_max)], dim=-1))
    return torch.stack(levels, dim=1).reshape(B, _POOL_LEVELS * Ht * Wt, 2)


def _block_activity(
    centers_world: torch.Tensor,  # [NB, 3]
    half_extent: torch.Tensor,  # scalar: half the block's voxel-center cube edge
    depth_hw: tuple[int, int],
    K: torch.Tensor,  # [B, 3, 3]
    E_w2c: torch.Tensor,  # [B, 3, 4]
    pyramid: torch.Tensor,  # [B, L*Ht*Wt, 2]
    tiles_hw: tuple[int, int],
    trunc: torch.Tensor,
    occupied: torch.Tensor | None = None,  # [NB] bool: carve mode
) -> torch.Tensor:
    """Conservative per-block activity ``[B, NB]``: could any voxel of the
    block fall inside the truncation band of any pixel it projects to?

    The block is an axis-aligned world cube of half-edge ``half_extent``; its
    camera-space extent per axis is bounded by the L1 norm of that rotation
    row.  Pixel footprint per axis:
    |u_p - u_c| <= (fx·xh + |u_c - cx|·zh) / z_min with z_min = z_c - zh, plus
    half a pixel for the voxel's nearest-pixel rounding.  The pyramid level
    is picked so the footprint box spans at most two level tiles per axis,
    and its four corner lookups cover it.  Blocks too close for the coarsest
    level, or straddling the camera plane, are active.

    ``occupied`` (carving): blocks that already hold weight stay active
    whenever any voxel could receive an observation at all (the back-side
    bound ``z - zh <= dmax + trunc`` alone), so the clipped +1 free-space
    observations reach and erase spurious early surfaces."""
    H, W = depth_hw
    Ht, Wt = tiles_hw
    cam = _transform_points(E_w2c, centers_world)  # [B, NB, 3]
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    eps = 1e-6
    R = E_w2c[:, :3, :3]
    l1 = torch.sum(torch.abs(R), dim=2)  # [B, 3] per-camera-axis L1 row norms
    xh = half_extent * l1[:, 0, None]
    yh = half_extent * l1[:, 1, None]
    zh = half_extent * l1[:, 2, None]
    zs = torch.clamp_min(z, eps)
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    cx, cy = K[:, 0, 2, None], K[:, 1, 2, None]
    u = x / zs * fx + cx
    v = y / zs * fy + cy
    zmin = torch.clamp_min(z - zh, eps)
    # +0.5: the voxel samples depth at round(u), up to half a pixel beyond
    # the continuous projection (else a block whose rounded pixel crosses a
    # tile boundary can read a tile the corners never covered)
    rho_u = (fx * xh + torch.abs(u - cx) * zh) / zmin + 0.5
    rho_v = (fy * yh + torch.abs(v - cy) * zh) / zmin + 0.5
    rho = torch.maximum(rho_u, rho_v)

    lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp_min(2.0 * rho, 1.0) / _POOL_T0)),
                      0, _POOL_LEVELS - 1).to(torch.int64)
    base = lvl * (Ht * Wt)
    dmin = torch.full_like(z, float("inf"))
    dmax = torch.full_like(z, float("-inf"))
    for du in (-1.0, 1.0):
        for dv in (-1.0, 1.0):
            xx = torch.clamp(torch.floor((u + du * rho_u) / _POOL_T0).to(torch.int64), 0, Wt - 1)
            yy = torch.clamp(torch.floor((v + dv * rho_v) / _POOL_T0).to(torch.int64), 0, Ht - 1)
            idx = (base + yy * Wt + xx)[..., None].expand(*z.shape, 2)
            mm = torch.gather(pyramid, 1, idx)
            dmin = torch.minimum(dmin, mm[..., 0])
            dmax = torch.maximum(dmax, mm[..., 1])

    in_front = (z + zh) > eps
    straddle = (z - zh) <= eps  # center projection unusable
    in_img = (u >= -rho_u - 1.0) & (u <= W + rho_u) & (v >= -rho_v - 1.0) & (v <= H + rho_v)
    front_ok = (z - zh) <= dmax + trunc
    back_ok = (z + zh) >= dmin - trunc
    if occupied is not None:
        # carve: occupied blocks need only the front-side bound; empty blocks
        # keep the full band test (a free-space update on sdf=+1/w=0 changes
        # nothing but a weight prior)
        band = front_ok & (occupied | back_ok)
    else:
        band = front_ok & back_ok
    too_big = 2.0 * rho > _POOL_T0 * 2 ** (_POOL_LEVELS - 1)
    return in_front & (straddle | (in_img & (band | too_big)))


def _block_layout(a: torch.Tensor, bs: int, pad_value: float) -> torch.Tensor:
    """[X, Y, Z(, C)] → [NB, bs³(, C)] blocked layout (padded to multiples
    of ``bs`` with ``pad_value``), plus one trailing dummy row for the
    unselected-slot sentinel."""
    X, Y, Z = a.shape[:3]
    trail = tuple(a.shape[3:])
    Xp, Yp, Zp = -(-X // bs) * bs, -(-Y // bs) * bs, -(-Z // bs) * bs
    padded = torch.full((Xp, Yp, Zp, *trail), pad_value, dtype=a.dtype, device=a.device)
    padded[:X, :Y, :Z] = a
    blocked = padded.reshape(Xp // bs, bs, Yp // bs, bs, Zp // bs, bs, *trail)
    blocked = blocked.permute(0, 2, 4, 1, 3, 5, *range(6, 6 + len(trail)))
    nb = (Xp // bs) * (Yp // bs) * (Zp // bs)
    blocked = blocked.reshape(nb, bs**3, *trail)
    dummy = torch.full((1, bs**3, *trail), pad_value, dtype=a.dtype, device=a.device)
    return torch.cat([blocked, dummy], dim=0)


def _unblock(a: torch.Tensor, dims: tuple[int, int, int], bs: int) -> torch.Tensor:
    """Inverse of :func:`_block_layout` (drops the dummy row and padding)."""
    X, Y, Z = dims
    bx, by, bz = -(-X // bs), -(-Y // bs), -(-Z // bs)
    trail = tuple(a.shape[2:])
    a = a[:-1].reshape(bx, by, bz, bs, bs, bs, *trail)
    a = a.permute(0, 3, 1, 4, 2, 5, *range(6, 6 + len(trail)))
    a = a.reshape(bx * bs, by * bs, bz * bs, *trail)
    return a[:X, :Y, :Z].contiguous()


def _block_meta(bdims, bs: int, voxel: torch.Tensor, origin: torch.Tensor):
    """Per-grid constants: block centers (world) ``[NB, 3]``, the half-edge of
    a block's voxel-center cube, in-block voxel offsets ``[bs³, 3]``."""
    BX, BY, BZ = bdims
    nb = BX * BY * BZ
    dev = origin.device
    bi = torch.arange(nb, dtype=torch.int64, device=dev)
    bxyz = torch.stack([bi // (BY * BZ), (bi // BZ) % BY, bi % BZ], dim=-1)
    centers = (bxyz.to(torch.float32) * bs + (bs - 1) / 2.0) * voxel + origin
    half_extent = 0.5 * (bs - 1) * voxel
    o = torch.arange(bs, dtype=torch.float32, device=dev)
    ox, oy, oz = torch.meshgrid(o, o, o, indexing="ij")
    offs = torch.stack([ox, oy, oz], dim=-1).reshape(bs**3, 3)
    return centers, half_extent, offs


def _tiles_hw(hw) -> tuple[int, int]:
    coarse = _POOL_T0 * 2 ** (_POOL_LEVELS - 1)
    return ((-(-hw[0] // coarse) * coarse) // _POOL_T0,
            (-(-hw[1] // coarse) * coarse) // _POOL_T0)


def _count_active_impl(origin, voxel, trunc, depth, conf, K, E_w2c, bdims, block_size: int,
                       hw, occ0=None, carve: bool = False) -> torch.Tensor:
    """True per-frame active-block counts ``[N]`` (the activity-only pass
    behind ``active_blocks=None`` auto-sizing; no host wait).

    ``carve`` threads a conservative occupancy through the frames: a block
    MAY be occupied by frame i if it started occupied (``occ0``) or was
    band-active in any earlier frame, a superset of true occupancy, so the
    counts bound the carve path's true active sets from above and the
    auto-sized budget never drops blocks."""
    centers, half_extent, _ = _block_meta(bdims, block_size, voxel, origin)
    tiles = _tiles_hw(hw)
    occ = occ0 if carve else None
    counts = []
    for i in range(depth.shape[0]):
        pyr = _depth_minmax_pyramid(depth[i:i + 1], conf[i:i + 1])
        a = _block_activity(centers, half_extent, hw, K[i:i + 1], E_w2c[i:i + 1], pyr, tiles,
                            trunc, occupied=occ)[0]
        if carve:
            occ = occ | a
        counts.append(a.sum())
    return torch.stack(counts)


def _integrate_sparse_impl(sw_b, col_b, origin, voxel, trunc, depth, conf, K, E_w2c, images,
                           bdims, block_size: int, active_blocks: int, max_weight: float,
                           hw, batch: int, carve: bool = False):
    """The sparse update over ``[N, H, W]`` frames (N a multiple of
    ``batch``) on the blocked grid ``sw_b`` ``[NB+1, 2·bs³]`` (sdf | weight)
    and ``col_b`` ``[NB+1, bs³, 4]`` or None.  Returns (sw_b, col_b, counts)."""
    bs = block_size
    BX, BY, BZ = bdims
    nb = BX * BY * BZ
    H, W = hw
    b3 = bs**3
    A = active_blocks
    dev = sw_b.device
    centers, half_extent, offs = _block_meta(bdims, bs, voxel, origin)
    tiles = _tiles_hw(hw)
    block_ids = torch.arange(nb, dtype=torch.int64, device=dev)
    pix_offset = (torch.arange(batch, dtype=torch.int64, device=dev) * (H * W))[:, None]
    with_color = col_b is not None and images is not None
    counts = []
    for s in range(depth.shape[0] // batch):
        sl = slice(s * batch, (s + 1) * batch)
        d, c, k, e = depth[sl], conf[sl], K[sl], E_w2c[sl]
        # One step handles `batch` frames: activity, selection and the
        # per-voxel observation math are frame-independent and batch; only
        # the row-granular state updates stay sequential, which keeps the
        # results those of frame-at-a-time updates.
        pyr = _depth_minmax_pyramid(d, c)
        # carve: occupancy snapshot once a step: a block filled by frame i of
        # this step is carve-eligible from the next step on (exact at batch=1)
        occ = (sw_b[:-1, b3:] > 0.0).any(dim=1) if carve else None
        active = _block_activity(centers, half_extent, hw, k, e, pyr, tiles, trunc,
                                 occupied=occ)  # [B, NB]
        counts.append(active.sum(dim=1))
        # fixed-budget compaction: each active block's slot is its rank among
        # the active ones (ascending block index); overflow and inactive
        # blocks go to the extra slot A, cut off below
        pos = torch.cumsum(active, dim=1) - 1
        dest = torch.where(active & (pos < A), pos, torch.full_like(pos, A))
        ids = torch.full((batch, A + 1), nb, dtype=torch.int64, device=dev)
        ids.scatter_(1, dest, block_ids.expand(batch, nb).contiguous())
        ids = ids[:, :A]

        # voxel centers of the selected blocks (sentinel ids decode outside
        # the grid; their updates land in the dummy row)
        cxv = (ids // (BY * BZ)).to(torch.float32) * bs  # [B, A]
        cyv = ((ids // BZ) % BY).to(torch.float32) * bs
        czv = (ids % BZ).to(torch.float32) * bs
        px = ((cxv[..., None] + offs[:, 0]) * voxel + origin[0]).reshape(batch, -1)
        py = ((cyv[..., None] + offs[:, 1]) * voxel + origin[1]).reshape(batch, -1)
        pz = ((czv[..., None] + offs[:, 2]) * voxel + origin[2]).reshape(batch, -1)
        cam = _transform_points(e, torch.stack([px, py, pz], dim=-1))  # [B, A·b3, 3]
        z = cam[..., 2]
        zs = torch.clamp_min(z, 1e-9)
        u = cam[..., 0] / zs * k[:, 0, 0, None] + k[:, 0, 2, None]
        v = cam[..., 1] / zs * k[:, 1, 1, None] + k[:, 1, 2, None]
        sdf_obs, w_obs, flat = _observe(z, u, v, d.reshape(-1), c.reshape(-1), hw, trunc,
                                        band_only=not carve, pix_offset=pix_offset)
        if with_color:
            c_pix = images[sl].reshape(-1, 3).to(torch.float32)[flat]  # [B, A·b3, 3]
            w_col = torch.where(sdf_obs.abs() < 1.0, w_obs, torch.zeros_like(w_obs))

        # sequential (exact) state updates, row-granular
        for b in range(batch):
            idb = ids[b]
            rows = sw_b[idb]  # [A, 2·b3]
            s_new, w_new = _running_average(rows[:, :b3].reshape(-1), rows[:, b3:].reshape(-1),
                                            sdf_obs[b], w_obs[b], max_weight)
            sw_b[idb] = torch.cat([s_new.reshape(-1, b3), w_new.reshape(-1, b3)], dim=1)
            if with_color:
                add = torch.stack([c_pix[b, :, 0] * w_col[b], c_pix[b, :, 1] * w_col[b],
                                   c_pix[b, :, 2] * w_col[b], w_col[b]], dim=-1)
                col_b[idb] = col_b[idb] + add.reshape(-1, b3, 4)
    return sw_b, col_b, torch.cat(counts)


def integrate_frames_sparse(
    grid: TSDFGrid,
    depth: torch.Tensor,  # [N, H, W]
    conf: torch.Tensor,  # [N, H, W]
    K: torch.Tensor,  # [N, 3, 3]
    E_w2c: torch.Tensor,  # [N, 3, 4]
    max_weight: float = 64.0,
    images: torch.Tensor | None = None,
    block_size: int = 4,
    active_blocks: int | None = None,
    batch: int = 8,
    carve: bool = False,
) -> tuple[TSDFGrid, np.ndarray]:
    """Block-sparse fusion of a frame stack (band-only semantics).

    Equivalent to ``integrate(band_only=True)`` per frame whenever the
    per-frame active-block count fits ``active_blocks``; over budget, the
    active blocks of highest index are dropped for that frame.  The default
    ``active_blocks=None`` auto-sizes the budget with an activity-only
    counting pass (one host wait, for its max).  ``batch`` frames share one
    activity test and lookup a step; results are those of frame-at-a-time
    updates.

    ``carve=True`` adds free-space carving (the dense ``band_only=False``
    semantics): blocks that already hold weight are also updated whenever
    they sit in front of observed depth.  Never-occupied free-space blocks
    still skip the (value-neutral) weight prior.  Occupancy refreshes once a
    step: a surface written by frame i becomes carve-eligible ``<= batch``
    frames later (exact at ``batch=1``), so carve results depend on
    ``batch``.

    Returns ``(grid, counts)``, ``counts`` the TRUE per-frame active-block
    counts (numpy): with an explicit budget, callers check
    ``counts.max() <= active_blocks``.
    """
    bs = block_size
    X, Y, Z = grid.sdf.shape
    dev = grid.sdf.device
    bdims = (-(-X // bs), -(-Y // bs), -(-Z // bs))
    nb = bdims[0] * bdims[1] * bdims[2]
    hw = (int(depth.shape[1]), int(depth.shape[2]))
    depth, conf, K, E_w2c = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                             for a in (depth, conf, K, E_w2c))
    if depth.shape[0] == 0:  # empty stack: nothing to fuse
        return grid, np.zeros((0,), np.int64)
    if images is not None and grid.color is None:
        raise ValueError("images given but grid has no color accumulator")

    sw_b = torch.cat([_block_layout(grid.sdf, bs, 1.0), _block_layout(grid.weight, bs, 0.0)],
                     dim=1)
    col_b = _block_layout(grid.color, bs, 0.0) if grid.color is not None else None

    if active_blocks is None:
        occ0 = (sw_b[:-1, bs**3:] > 0.0).any(dim=1) if carve else None
        counts = _count_active_impl(grid.origin, grid.voxel, grid.trunc, depth, conf, K, E_w2c,
                                    bdims, bs, hw, occ0=occ0, carve=carve)
        # rounded up to a multiple of 128, as the JAX package's compile key
        active_blocks = -(-(int(counts.max()) + 1) // 128) * 128
    active_blocks = max(1, min(int(active_blocks), nb))

    n = depth.shape[0]
    batch = max(1, min(int(batch), n))
    pad = -n % batch
    if pad:
        # zero-confidence frames under identity cameras: exact no-ops
        def padf(a):
            return torch.cat([a, torch.zeros((pad, *a.shape[1:]), dtype=a.dtype, device=dev)])

        depth, conf = padf(depth), padf(conf)
        K = torch.cat([K, torch.eye(3, device=dev).expand(pad, 3, 3)])
        E_w2c = torch.cat([E_w2c, torch.eye(4, device=dev)[:3].expand(pad, 3, 4)])
    if images is not None:
        images = torch.as_tensor(images, device=dev)
        if pad:
            images = padf(images)

    sw_b, col_b, counts = _integrate_sparse_impl(
        sw_b, col_b, grid.origin, grid.voxel, grid.trunc, depth, conf, K, E_w2c, images,
        bdims, bs, int(active_blocks), float(max_weight), hw, batch, carve=carve)
    dims = (X, Y, Z)
    b3 = bs**3
    return grid._replace(
        sdf=_unblock(sw_b[:, :b3], dims, bs),
        weight=_unblock(sw_b[:, b3:], dims, bs),
        color=None if col_b is None else _unblock(col_b, dims, bs),
    ), counts.cpu().numpy()[:n]


def vertex_colors(grid: TSDFGrid, verts_world) -> np.ndarray:
    """Per-vertex uint8 colours by nearest-voxel lookup of the colour
    accumulator (on the host; vertices from ``inout.mesh.tsdf_to_mesh``).

    Vertices whose nearest voxel never received near-surface colour weight
    fall back to the scene's mean colour instead of black."""
    if grid.color is None:
        raise ValueError("grid has no color accumulator (make_grid with_color)")
    c = grid.color.cpu().numpy()
    idx = np.round(
        (np.asarray(verts_world) - grid.origin.cpu().numpy()) / float(grid.voxel)
    ).astype(np.int64)
    idx = np.clip(idx, 0, np.asarray(c.shape[:3]) - 1)
    acc = c[idx[:, 0], idx[:, 1], idx[:, 2]]
    has_w = acc[:, 3] > 1e-12
    rgb = acc[:, :3] / np.maximum(acc[:, 3:], 1e-12)
    if not has_w.all():
        fallback = rgb[has_w].mean(axis=0) if has_w.any() else np.full(3, 128.0)
        rgb[~has_w] = fallback
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def estimate_bounds(depth, K, E_w2c, resolution: int = 192,
                    margin: float = 0.05) -> tuple[np.ndarray, np.ndarray]:
    """Scene bounds (lo, hi) from a strided backprojection: 1%/99% point
    quantiles, padded past the truncation band (a wall-facing camera puts
    ~99% of its points ON one plane, so the raw quantile box edge would land
    on the surface and clip the sign change a mesh needs).  Tensors in, the
    backprojection on their device, the quantiles on the host."""
    from da3slam_tpu_torch.core.geometry import backproject_depth

    depth = torch.as_tensor(depth, dtype=torch.float32)
    dev = depth.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    E_w2c = torch.as_tensor(E_w2c, dtype=torch.float32, device=dev)
    # the 8x-strided grid needs 8x-smaller intrinsics (pixel (u,v) of the
    # strided map is (8u, 8v) in the original)
    K8 = K.clone()
    K8[:, :2, :] *= 1.0 / 8.0
    d8 = depth[:, ::8, ::8]
    pts = backproject_depth(d8, K8, E_w2c).reshape(-1, 3).cpu().numpy()
    d8 = d8.reshape(-1).cpu().numpy()
    ok = np.isfinite(pts).all(axis=1) & (d8 > 1e-6)
    if not ok.any():
        raise ValueError(
            "TSDF bounds estimation found no valid depth sample — every "
            "strided pixel is non-finite or <= 1e-6; check the depth scale "
            "and validity masking"
        )
    lo = np.quantile(pts[ok], 0.01, axis=0)
    hi = np.quantile(pts[ok], 0.99, axis=0)
    pad = max(margin, 4.0 * float(np.max(hi - lo, initial=1e-6)) / resolution)
    return lo - pad, hi + pad


def fuse_frames(
    depth,  # [T, H, W]
    conf,  # [T, H, W]
    K,  # [T, 3, 3]
    E_w2c,  # [T, 3, 4]
    resolution: int = 192,
    conf_floor: float = 1.0,
    max_weight: float = 64.0,
    margin: float = 0.05,
    images=None,  # [T, H, W, 3] → coloured grid
    sparse: bool = False,
    block_size: int = 4,
    active_blocks: int | None = None,
    carve: bool = False,
    batch: int = 8,
    device: str | torch.device = "cuda",
) -> TSDFGrid:
    """TSDF-fuse a stack of posed depth frames (numpy or tensors) on
    ``device``, bounds auto-estimated.

    Confidence below ``conf_floor`` contributes zero weight.
    ``sparse=True`` routes through the block-sparse band-only path
    (:func:`integrate_frames_sparse`); a warning fires if any frame's active
    set exceeded an explicit block budget.  ``carve=True`` (sparse only) adds
    free-space carving of occupied blocks; the dense path always carves."""
    depth, conf, K, E = (torch.as_tensor(a, dtype=torch.float32, device=device)
                         for a in (depth, conf, K, E_w2c))
    lo, hi = estimate_bounds(depth, K, E, resolution=resolution, margin=margin)
    grid = grid_from_bounds(lo, hi, resolution, with_color=images is not None, device=device)

    w = torch.clamp_min(conf - conf_floor, 0.0)
    if images is not None:
        images = torch.as_tensor(images, device=device)
    if sparse:
        grid, counts = integrate_frames_sparse(
            grid, depth, w, K, E, max_weight=max_weight, images=images,
            block_size=block_size, active_blocks=active_blocks, carve=carve, batch=batch)
        # active_blocks=None auto-sizes from a counting pass → never drops
        if active_blocks is not None and counts.max() > active_blocks:
            warnings.warn(
                f"sparse TSDF: {int(counts.max())} active blocks exceed the "
                f"budget of {active_blocks}; some surface observations were "
                "dropped — raise active_blocks", stacklevel=2)
        return grid
    return integrate_frames(grid, depth, w, K, E, max_weight=max_weight, images=images)


def fuse_pipeline_output(
    out,  # slam.pipeline.PipelineOutput
    resolution: int = 192,
    conf_floor: float = 1.0,
    max_weight: float = 64.0,
    margin: float = 0.05,
    window_idx=None,  # [C, N] original-frame indices (pipeline.make_windows)
    sparse: bool = False,
    carve: bool = False,
) -> TSDFGrid:
    """TSDF-fuse a whole pipeline run (flattens the window axis) on the
    device its outputs live on (the CPU for a host spill).

    Pipeline windows overlap, so a physical frame appears in more than one
    window; fusing the flat stack double-weights those observations at window
    seams.  Pass the pipeline's ``window_idx`` to keep only each frame's first
    occurrence (duplicate slots contribute zero weight)."""
    device = out.depth.device if isinstance(out.depth, torch.Tensor) else torch.device("cpu")

    def flat(a, *tail):
        a = torch.as_tensor(a, dtype=torch.float32, device=device)
        return a.reshape(a.shape[0] * a.shape[1], *(tail or a.shape[2:]))

    conf = flat(out.conf)
    if window_idx is not None:
        ids = np.asarray(window_idx).reshape(-1)
        first = np.zeros(ids.shape[0], bool)
        first[np.unique(ids, return_index=True)[1]] = True
        keep = torch.from_numpy(first).to(device)
        # conf_floor gating maps masked slots to zero fusion weight
        conf = torch.where(keep[:, None, None], conf, torch.zeros_like(conf))
    return fuse_frames(flat(out.depth), conf, flat(out.intrinsics, 3, 3),
                       flat(out.extrinsics_global, 3, 4), resolution=resolution,
                       conf_floor=conf_floor, max_weight=max_weight, margin=margin,
                       sparse=sparse, carve=carve, device=device)
