"""ICP via projective data association (counterpart of ``da3slam_tpu/ops/icp.py``).

Both clouds in the SLAM overlap step come from depth maps of near-identical
viewpoints, so correspondences are found by projecting the moving cloud into
the target camera and reading the target's point map at that pixel
(KinectFusion-style).  Each iteration: associate (project + one gather) →
Huber-weighted point-to-plane Gauss-Newton step.  Fixed iteration count, no
data-dependent control flow, so nothing synchronises with the host.

On CUDA inputs that fixed shape lets the whole body run as one captured CUDA
graph: ``run_icp`` captures it once per ``GraphKey`` (device, shapes, dtypes,
the static arguments) in a cache of the process and replays it after, so a
call costs a few copies and one graph launch in place of ~2,500 eager
launches.  The replay runs the captured kernels in the captured order, so its
result is the eager body's bit for bit.  CPU inputs run the body eagerly.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

import torch

from da3slam_tpu_torch.core.transforms import (
    Sim3,
    highest_precision,
    orthonormalize_rotation,
    sim3_compose,
)


class ICPResult(NamedTuple):
    transform: Sim3  # maps source points into the target frame
    fitness: torch.Tensor  # inlier fraction of valid source points (Open3D-style)
    inlier_rmse: torch.Tensor  # RMS distance over inliers


def estimate_normals(point_map: torch.Tensor) -> torch.Tensor:
    """Per-pixel normals of an organised ``[H, W, 3]`` point map, from central
    differences along the pixel grid, oriented towards the camera."""
    du = torch.roll(point_map, -1, dims=1) - torch.roll(point_map, 1, dims=1)
    dv = torch.roll(point_map, -1, dims=0) - torch.roll(point_map, 1, dims=0)
    n = torch.linalg.cross(du, dv, dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    # orient towards the camera at the origin: n · p must be negative
    flip = torch.sign(torch.sum(n * point_map, dim=-1, keepdim=True))
    return -n * torch.where(flip == 0, torch.ones_like(flip), flip)


def bilinear_gather(point_map: torch.Tensor, uv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinearly sample a ``[H, W, C]`` map at continuous pixel coordinates
    ``[N, 2]`` (u = column, v = row).  Returns ``(values [N, C], in_bounds
    [N])``: a coordinate within half a pixel of the border counts as inside
    and reads the clamped edge; farther out ``in_bounds`` is False (the
    values are still the clamped edge's, as in the JAX package)."""
    H, W = point_map.shape[0], point_map.shape[1]
    u, v = uv[..., 0], uv[..., 1]
    # half-pixel slop so border pixels survive f32 projection round-trip noise
    in_bounds = (u >= -0.5) & (u <= W - 0.5) & (v >= -0.5) & (v <= H - 0.5)
    u = u.clamp(0.0, W - 1.0)
    v = v.clamp(0.0, H - 1.0)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = (u0 + 1).clamp_max(W - 1)
    v1 = (v0 + 1).clamp_max(H - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    top = point_map[v0, u0] * (1 - fu) + point_map[v0, u1] * fu
    bot = point_map[v1, u0] * (1 - fu) + point_map[v1, u1] * fu
    return top * (1 - fv) + bot * fv, in_bounds


def _icp(
    src_points: torch.Tensor,
    tgt_point_map: torch.Tensor,
    tgt_K: torch.Tensor,
    src_valid: torch.Tensor | None,
    tgt_valid: torch.Tensor | None,
    threshold: float,
    max_iterations: int,
    with_scale: bool,
) -> ICPResult:
    """The arithmetic of ``icp_point_to_point``, run eagerly or captured."""
    dev = src_points.device
    f32 = torch.float32
    n = src_points.shape[0]
    if src_valid is None:
        src_valid = torch.ones(n, dtype=torch.bool, device=dev)
    src_valid = src_valid & torch.isfinite(src_points).all(-1)
    src = torch.where(src_valid[:, None], src_points, torch.zeros_like(src_points))

    tgt_map = torch.nan_to_num(tgt_point_map, nan=0.0, posinf=0.0, neginf=0.0)
    if tgt_valid is None:
        tgt_valid = torch.isfinite(tgt_point_map).all(-1) & (tgt_point_map[..., 2] > 0)
    tgt_w = tgt_valid.to(f32)[..., None]

    fx, fy = tgt_K[0, 0], tgt_K[1, 1]
    cx, cy = tgt_K[0, 2], tgt_K[1, 2]
    tgt_normals = estimate_normals(tgt_map)
    H, W = tgt_map.shape[0], tgt_map.shape[1]
    # one stacked [point(3) | normal(3) | validity(1)] map, so each
    # association is a single gather
    stacked = torch.cat([tgt_map, tgt_normals, tgt_w], dim=-1).reshape(H * W, 7)

    def associate(T: Sim3):
        p = T.s * (src @ T.R.T) + T.t  # moved source
        z = p[..., 2].clamp_min(1e-8)
        u = fx * p[..., 0] / z + cx
        v = fy * p[..., 1] / z + cy
        # nearest pixel (round half to even, as jnp.round)
        ui = torch.round(u).long().clamp(0, W - 1)
        vi = torch.round(v).long().clamp(0, H - 1)
        in_bounds = (u >= -0.5) & (u <= W - 0.5) & (v >= -0.5) & (v <= H - 0.5)
        vals = stacked.index_select(0, vi * W + ui)  # [N, 7]
        q = vals[..., 0:3]
        nrm = vals[..., 3:6]
        nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True).clamp_min(1e-12)
        tgt_ok = vals[..., 6] > 0.5
        dist = torch.linalg.vector_norm(p - q, dim=-1)
        valid = (src_valid & in_bounds & tgt_ok & (p[..., 2] > 0)).to(f32)
        return p, q, nrm, dist, valid

    n_params = 7 if with_scale else 6
    eye = torch.eye(n_params, dtype=f32, device=dev)
    T = Sim3(torch.ones((), dtype=f32, device=dev), torch.eye(3, dtype=f32, device=dev),
             torch.zeros(3, dtype=f32, device=dev))
    for _ in range(max_iterations):
        # point-to-plane Gauss-Newton step with a Huber weight on the residual
        p, q, nrm, dist, valid = associate(T)
        r = torch.sum(nrm * (p - q), dim=-1)
        absr = r.abs()
        w = valid * torch.where(absr <= threshold, torch.ones_like(r),
                                threshold / absr.clamp_min(1e-12))
        # jacobian rows of r wrt the twist [σ?, ω, u]: δr = n·(σ p + ω×p + u)
        cross_pn = torch.linalg.cross(p, nrm, dim=-1)
        if with_scale:
            A = torch.cat([torch.sum(nrm * p, -1, keepdim=True), cross_pn, nrm], dim=-1)
        else:
            A = torch.cat([cross_pn, nrm], dim=-1)
        Aw = A * w[:, None]
        Hm = Aw.T @ A + 1e-6 * eye
        g = Aw.T @ (-r)
        xi = torch.linalg.solve_ex(Hm, g).result  # no error check: no host sync
        if with_scale:
            sigma, omega, upd = xi[0], xi[1:4], xi[4:7]
        else:
            sigma, omega, upd = torch.zeros((), dtype=f32, device=dev), xi[0:3], xi[3:6]
        zero = torch.zeros((), dtype=f32, device=dev)
        skew = torch.stack([
            torch.stack([zero, -omega[2], omega[1]]),
            torch.stack([omega[2], zero, -omega[0]]),
            torch.stack([-omega[1], omega[0], zero]),
        ])
        R_delta = orthonormalize_rotation(torch.eye(3, dtype=f32, device=dev) + skew)
        T_new = sim3_compose(Sim3(1.0 + sigma, R_delta, upd), T)
        has_corr = torch.sum(w) >= float(n_params)
        T = Sim3(
            torch.where(has_corr, T_new.s, T.s),
            torch.where(has_corr, T_new.R, T.R),
            torch.where(has_corr, T_new.t, T.t),
        )

    _, _, _, dist, valid = associate(T)
    w = valid * (dist < threshold)  # hard gate for Open3D-style diagnostics
    n_src = torch.sum(src_valid.to(f32)).clamp_min(1.0)
    n_inlier = torch.sum(w)
    fitness = n_inlier / n_src
    inlier_rmse = torch.sqrt(torch.sum(w * dist**2) / n_inlier.clamp_min(1.0))
    return ICPResult(T, fitness, inlier_rmse)


# captured bodies kept at once, the least recently used dropped first: a
# process aligns at one shape a frame size, so a few cover callers that mix
# frame sizes or devices
GRAPH_ENTRIES = 4


class GraphKey(NamedTuple):
    """What changes the captured work: a call at another key captures anew."""

    device: int
    src_shape: tuple[int, ...]
    tgt_shape: tuple[int, ...]
    dtypes: tuple[torch.dtype, ...]  # of src_points, tgt_point_map, tgt_K
    threshold: float
    max_iterations: int
    with_scale: bool
    src_valid: bool  # given, or made by the body
    tgt_valid: bool


def graph_key(src_points: torch.Tensor, tgt_point_map: torch.Tensor, tgt_K: torch.Tensor,
              src_valid: torch.Tensor | None, tgt_valid: torch.Tensor | None,
              threshold: float, max_iterations: int, with_scale: bool) -> GraphKey:
    return GraphKey(src_points.device.index, tuple(src_points.shape), tuple(tgt_point_map.shape),
                    (src_points.dtype, tgt_point_map.dtype, tgt_K.dtype), float(threshold),
                    int(max_iterations), bool(with_scale), src_valid is not None,
                    tgt_valid is not None)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple[torch.Tensor | None, ...]  # the static copies each replay reads
    result: ICPResult  # the static outputs each replay overwrites


class ICPGraphs:
    """The process's captured ICP bodies by ``GraphKey``, at most ``entries``
    of them (least recently used first)."""

    def __init__(self, entries: int = GRAPH_ENTRIES):
        self.entries = entries
        self.graphs: OrderedDict[GraphKey, _Graph] = OrderedDict()
        self.captures = 0  # bodies captured in all, evicted ones included
        self._lock = threading.Lock()

    def __call__(self, src_points, tgt_point_map, tgt_K, src_valid, tgt_valid, threshold,
                 max_iterations, with_scale) -> tuple[ICPResult, str]:
        """``_icp`` on CUDA inputs by replaying the graph captured at their
        ``graph_key``, captured first if there is none.  Returns the result,
        cloned out of the graph's buffers (the next replay overwrites them),
        and "capture" or "replay"."""
        tensors = (src_points, tgt_point_map, tgt_K, src_valid, tgt_valid)
        statics = (threshold, max_iterations, with_scale)
        key = graph_key(*tensors, *statics)
        with self._lock:
            g = self.graphs.get(key)
            if g is None:
                g, mode = self._capture(tensors, statics), "capture"
                self.graphs[key] = g
                if len(self.graphs) > self.entries:
                    self.graphs.popitem(last=False)
            else:
                mode = "replay"
                self.graphs.move_to_end(key)
                for static, x in zip(g.inputs, tensors):
                    if static is not None:
                        static.copy_(x)
            g.graph.replay()
            T, fitness, rmse = g.result
            return ICPResult(Sim3(T.s.clone(), T.R.clone(), T.t.clone()), fitness.clone(),
                             rmse.clone()), mode

    def _capture(self, tensors: tuple, statics: tuple) -> _Graph:
        self.captures += 1
        dev = tensors[0].device
        inputs = tuple(None if x is None else x.to(dev, copy=True) for x in tensors)
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            # one eager run on the capturing stream first: it makes that
            # stream's cuBLAS and cuSOLVER handles and workspaces, which a
            # capture may not
            with torch.cuda.stream(side):
                _icp(*inputs, *statics)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: the frame prefetcher's threads may call the CUDA
            # runtime meanwhile; only this thread must not
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                result = _icp(*inputs, *statics)
        return _Graph(graph, inputs, result)


GRAPHS = ICPGraphs()


@highest_precision()
def run_icp(
    src_points: torch.Tensor,
    tgt_point_map: torch.Tensor,
    tgt_K: torch.Tensor,
    src_valid: torch.Tensor | None = None,
    tgt_valid: torch.Tensor | None = None,
    threshold: float = 0.1,
    max_iterations: int = 50,
    with_scale: bool = False,
) -> tuple[ICPResult, str]:
    """``icp_point_to_point``, and how it ran: "eager" (CPU inputs), or, on
    CUDA inputs, "capture" (the first call at its ``GraphKey``) or "replay"."""
    args = (src_points, tgt_point_map, tgt_K, src_valid, tgt_valid, threshold, max_iterations,
            with_scale)
    if src_points.device.type != "cuda":
        return _icp(*args), "eager"
    return GRAPHS(*args)


def icp_point_to_point(
    src_points: torch.Tensor,
    tgt_point_map: torch.Tensor,
    tgt_K: torch.Tensor,
    src_valid: torch.Tensor | None = None,
    tgt_valid: torch.Tensor | None = None,
    threshold: float = 0.1,
    max_iterations: int = 50,
    with_scale: bool = False,
) -> ICPResult:
    """Align ``src_points`` ``[N, 3]`` onto the cloud behind ``tgt_point_map``
    ``[H, W, 3]`` (camera coords, intrinsics ``tgt_K``), from the identity.

    Returns ``ICPResult`` with ``transform`` s.t. ``tgt ≈ s R src + t``.
    """
    return run_icp(src_points, tgt_point_map, tgt_K, src_valid, tgt_valid, threshold,
                   max_iterations, with_scale)[0]
