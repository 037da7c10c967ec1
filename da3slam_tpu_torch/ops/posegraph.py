"""Sim(3) pose-graph optimisation by Levenberg-Marquardt (counterpart of
``da3slam_tpu/ops/posegraph.py``).

Nodes are chunk-to-world Sim(3) transforms; edges carry relative Sim(3)
measurements (sequential chunk alignments and loop closures).  The residual
of edge (i, j, M) with node transforms S_i, S_j (chunk → world) and
measurement M (chunk_j → chunk_i coordinates) is the 7-vector chart

    r = [log s_e, so3_log(R_e), t_e]   where   E = S_i ∘ M ∘ S_j^{-1}

(E = identity ⟺ the edge is satisfied).  Two solvers share one LM outer loop:

- ``dense``: the Jacobian by ``torch.func.jacfwd`` and the damped normal
  equations by ``torch.linalg.solve_ex`` (no error-check wait on the card);
  right for tens of nodes, one per chunk.
- ``cg``: matrix-free LM-CG for long sequences.  (JᵀJ + λI)v is a
  ``torch.func.jvp`` followed by the ``torch.func.vjp`` of the residual, and
  the step is solved by conjugate gradients.  The JAX package runs CG in a
  device ``while_loop``; here every iteration after convergence is carried
  through unchanged (``torch.where``), so the result is the same, and the
  host reads the convergence test once every ``CG_CHECK_EVERY`` iterations.

``solver="auto"`` picks dense up to 700 free parameters and CG above.

Everything runs on the nodes' device at full f32 (``highest_precision``).
The LM loop keeps the JAX package's accept/reject sequence, so the host
reads back one pair (trial cost, step norm) per trial: up to
``max_iterations`` × 8 waits for the device, plus one per
``CG_CHECK_EVERY`` CG iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from da3slam_tpu_torch.core.transforms import (
    Sim3,
    highest_precision,
    sim3_compose,
    sim3_inverse,
    so3_exp,
    so3_log,
)

CG_CHECK_EVERY = 8


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor  # [E] source node (earlier chunk)
    j: torch.Tensor  # [E] target node
    measurement: Sim3  # stacked [E]: chunk_j coords → chunk_i coords
    weight: torch.Tensor  # [E]


def _params_to_sim3(x: torch.Tensor) -> Sim3:
    """[K, 7] = [log s, rotvec, t] → stacked Sim3."""
    return Sim3(torch.exp(x[:, 0]), so3_exp(x[:, 1:4]), x[:, 4:7])


def _sim3_to_params(T: Sim3) -> torch.Tensor:
    return torch.cat([torch.log(T.s)[:, None], so3_log(T.R), T.t], dim=-1)


def _edge_residuals(x: torch.Tensor, edges: PoseGraphEdges,
                    huber_delta: float | None = None) -> torch.Tensor:
    nodes = _params_to_sim3(x)
    Si = Sim3(nodes.s[edges.i], nodes.R[edges.i], nodes.t[edges.i])
    Sj = Sim3(nodes.s[edges.j], nodes.R[edges.j], nodes.t[edges.j])
    E = sim3_compose(sim3_compose(Si, edges.measurement), sim3_inverse(Sj))
    r = torch.cat([torch.log(E.s)[:, None], so3_log(E.R), E.t], dim=-1)  # [E, 7]
    r = r * edges.weight[:, None]
    if huber_delta is not None:
        # robust kernel: an edge whose residual norm exceeds delta grows
        # linearly, so one false loop edge cannot dominate the normal
        # equations.  Safe norm: the plain norm's gradient is 0/0 at an exactly
        # satisfied edge (r = 0), which would poison the CG path's vjp.
        n = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-24)
        scale = torch.sqrt(torch.clamp(huber_delta / torch.clamp_min(n, 1e-12), max=1.0))
        r = r * scale[:, None]
    return r.reshape(-1)


def _cg(Av, b: torch.Tensor, maxiter: int, tol2: torch.Tensor) -> torch.Tensor:
    """Conjugate gradients on ``Av x = b`` from x₀ = 0, stopping where the
    JAX package's ``while_loop`` stops (``rs <= tol2`` or ``maxiter``)."""
    x = torch.zeros_like(b)
    r, p = b, b
    rs = torch.dot(b, b)
    for k in range(maxiter):
        if k % CG_CHECK_EVERY == 0 and not bool(rs > tol2):
            break
        running = rs > tol2
        Ap = Av(p)
        alpha = rs / torch.clamp_min(torch.dot(p, Ap), 1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        rs_new = torch.dot(r_new, r_new)
        p_new = r_new + (rs_new / torch.clamp_min(rs, 1e-30)) * p
        x, r, p, rs = (torch.where(running, new, old)
                       for new, old in ((x_new, x), (r_new, r), (p_new, p), (rs_new, rs)))
    return x


@highest_precision()
def optimize_sim3_pose_graph(
    nodes_init: Sim3,
    edges: PoseGraphEdges,
    max_iterations: int = 30,
    lambda_init: float = 1e-6,
    fix_first: bool = True,
    huber_delta: float | None = 0.1,
    solver: str = "auto",
    cg_maxiter: int | None = None,
) -> Sim3:
    """LM optimisation on the nodes' device (the edges live there too);
    node 0 (the global anchor chunk) stays fixed.

    ``huber_delta`` bounds any single edge's influence (robust kernel in the
    residual); ``None`` restores plain least squares.  ``solver`` is
    "dense" | "cg" | "auto" (see module docstring); ``cg_maxiter`` caps the
    inner CG iterations (default: number of free parameters, capped at 250).
    """
    if solver not in ("auto", "dense", "cg"):
        raise ValueError(f"solver must be auto|dense|cg, got {solver!r}")
    dev = nodes_init.R.device
    x0 = _sim3_to_params(nodes_init).reshape(-1)
    K = nodes_init.R.shape[0]
    n_free = 7 * (K - 1) if fix_first else 7 * K
    use_cg = solver == "cg" or (solver == "auto" and n_free > 700)
    free_idx = torch.arange(7 * K - n_free, 7 * K, device=dev)

    def residual_flat(x_free):
        x = x0.index_put((free_idx,), x_free)  # out of place: torch.func traces it
        return _edge_residuals(x.reshape(K, 7), edges, huber_delta=huber_delta)

    if use_cg:
        maxiter = cg_maxiter if cg_maxiter is not None else min(n_free, 250)

        def trial_step(x_free, cache, lam):
            if cache is None:
                r, vjp_fn = torch.func.vjp(residual_flat, x_free)
                cache = (vjp_fn, vjp_fn(r)[0])
            vjp_fn, g = cache

            def Av(v):
                Jv = torch.func.jvp(residual_flat, (x_free,), (v,))[1]
                return vjp_fn(Jv)[0] + lam * v

            # inexact-Newton forcing: solve to 1% of the gradient norm
            return _cg(Av, -g, maxiter, 1e-4 * torch.dot(g, g)), cache
    else:
        def trial_step(x_free, cache, lam):
            if cache is None:
                J = torch.func.jacfwd(residual_flat)(x_free)
                cache = (J.T @ J, J.T @ residual_flat(x_free))
            H, g = cache
            eye = torch.eye(H.shape[0], dtype=H.dtype, device=dev)
            return torch.linalg.solve_ex(H + lam * eye, -g).result, cache

    x_free = x0[free_idx]
    lam = lambda_init
    cost = float(torch.sum(residual_flat(x_free) ** 2))
    for _ in range(max_iterations):
        cache = None
        step_accepted = False
        for _try in range(8):
            delta, cache = trial_step(x_free, cache, lam)
            x_new = x_free + delta
            # one transfer a trial: the trial's cost and its step's norm
            new_cost, step_norm = torch.stack([torch.sum(residual_flat(x_new) ** 2),
                                               torch.linalg.vector_norm(delta)]).tolist()
            if new_cost < cost:
                x_free, cost = x_new, new_cost
                lam = max(lam * 0.5, 1e-12)
                step_accepted = True
                break
            lam *= 10.0
        if not step_accepted or step_norm < 1e-10:
            break

    return _params_to_sim3(x0.index_put((free_idx,), x_free).reshape(K, 7))


def _stack(transforms: list[Sim3]) -> Sim3:
    return Sim3(*(torch.stack(parts) for parts in zip(*transforms)))


def sequential_edges(sim3_list: list[Sim3]) -> PoseGraphEdges:
    """Edges from the odometry chain: entry k maps chunk k+1 → chunk k."""
    E = len(sim3_list)
    dev = sim3_list[0].R.device
    return PoseGraphEdges(
        i=torch.arange(E, device=dev),
        j=torch.arange(1, E + 1, device=dev),
        measurement=_stack(sim3_list),
        weight=torch.ones(E, device=dev),
    )


def add_loop_edges(
    edges: PoseGraphEdges,
    loops: list[tuple[int, int, Sim3]],
    weight: float = 0.5,
) -> PoseGraphEdges:
    """Append loop edges (a, b, M) with M mapping chunk_b → chunk_a coords.

    Loop edges default to half the odometry weight: odometry comes from dense
    overlap registration of consecutive chunks and is far more reliable than
    appearance-triggered loop constraints.
    """
    if not loops:
        return edges
    dev = edges.i.device
    lm = _stack([T for _, _, T in loops])
    return PoseGraphEdges(
        i=torch.cat([edges.i, torch.tensor([a for a, _, _ in loops], device=dev)]),
        j=torch.cat([edges.j, torch.tensor([b for _, b, _ in loops], device=dev)]),
        measurement=Sim3(*(torch.cat([e, m.to(dev)])
                           for e, m in zip(edges.measurement, lm))),
        weight=torch.cat([edges.weight,
                          torch.full((len(loops),), weight, dtype=edges.weight.dtype, device=dev)]),
    )
