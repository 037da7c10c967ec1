"""Point-set registration: (weighted) Umeyama and Huber-IRLS Sim(3)
(counterpart of ``da3slam_tpu/ops/registration.py``).

Confidence filtering is expressed as weights, never as boolean gathers, so
every shape is fixed and nothing here reads a value back to the host.  On
CUDA the 3×3 ``torch.linalg.svd`` and ``torch.linalg.det`` of
``weighted_umeyama`` still make the host wait for the device (their error
checks): about two waits an IRLS step, 21 more than ICP over the two
alignments of a 31-frame run (``PERF.md``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from da3slam_tpu_torch.core.transforms import Sim3, highest_precision


class RegistrationResult(NamedTuple):
    transform: Sim3
    rmse: torch.Tensor  # weighted RMS residual after alignment
    n_effective: torch.Tensor  # number of points that carry weight


@highest_precision()
def weighted_umeyama(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: torch.Tensor,
    with_scale: bool = True,
    eps: float = 1e-8,
) -> Sim3:
    """Closed-form weighted Sim(3)/SE(3) ``dst ≈ s R src + t`` over ``[N, 3]``
    correspondences with ``[N]`` non-negative weights (zeros drop points),
    with the det-reflection fix."""
    w = weights.to(torch.float32)
    w = w / (torch.sum(w) + eps)

    mu_src = torch.sum(src * w[:, None], dim=0)
    mu_dst = torch.sum(dst * w[:, None], dim=0)
    X = src - mu_src
    Y = dst - mu_dst

    Sigma = (Y * w[:, None]).T @ X  # [3, 3]
    U, S, Vh = torch.linalg.svd(Sigma)
    det = torch.linalg.det(U @ Vh)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), torch.sign(det)])
    R = (U * d[None, :]) @ Vh

    if with_scale:
        var_src = torch.sum(w * torch.sum(X * X, dim=1))
        s = torch.sum(S * d) / (var_src + eps)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)

    t = mu_dst - s * (R @ mu_src)
    return Sim3(s, R, t)


def umeyama(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = True) -> Sim3:
    """Unweighted Umeyama."""
    return weighted_umeyama(src, dst, torch.ones_like(src[:, 0]), with_scale)


def huber_weights(residuals: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """IRLS weights of the Huber loss: ``ρ'(r)/r`` = 1 if |r| <= δ else δ/|r|."""
    abs_r = residuals.abs()
    return torch.where(abs_r <= delta, torch.ones_like(abs_r), delta / abs_r.clamp_min(1e-12))


@highest_precision()
def irls_sim3(
    src: torch.Tensor,
    dst: torch.Tensor,
    conf: torch.Tensor | None = None,
    delta: float = 0.1,
    max_iters: int = 5,
    min_points: int = 100,
    with_scale: bool = True,
    tol: float | None = None,
) -> RegistrationResult:
    """Huber-IRLS Sim(3) alignment of corresponding points ``dst ≈ T(src)``.

    Per-iteration weights are ``conf_i · huber'(r_i)/r_i`` normalised by their
    max; confidence gating is pre-folded into ``conf`` by the caller as hard
    zeros; non-finite points get weight 0.  The identity comes back when fewer
    than ``min_points`` carry weight.

    ``tol`` is the convergence early exit: once an update changes the
    transform by ``|Δs| + ‖ΔR‖_F + ‖Δt‖ < tol``, later iterations are skipped.
    The JAX package leaves its loop there; reading ``change`` on the host
    would wait for the device every iteration, so here all ``max_iters``
    steps run and a converged transform is carried through them unchanged
    (``torch.where``): the same result.
    """
    n = src.shape[0]
    c = torch.ones(n, device=src.device) if conf is None else conf.to(torch.float32)
    finite = torch.isfinite(src).all(-1) & torch.isfinite(dst).all(-1)
    c = torch.where(finite, c, torch.zeros_like(c))
    src = torch.where(finite[:, None], src, torch.zeros_like(src))
    dst = torch.where(finite[:, None], dst, torch.zeros_like(dst))

    def step(T: Sim3) -> Sim3:
        pred = T.s * (src @ T.R.T) + T.t
        r = torch.linalg.vector_norm(dst - pred, dim=-1)
        w = c * huber_weights(r, delta)
        w = w / (w.max() + 1e-8)
        return weighted_umeyama(src, dst, w, with_scale=with_scale)

    T = Sim3(torch.ones((), device=src.device), torch.eye(3, device=src.device),
             torch.zeros(3, device=src.device))
    running = torch.ones((), dtype=torch.bool, device=src.device)  # change >= tol so far
    for _ in range(max_iters):
        T_new = step(T)
        if tol is None:
            T = T_new
            continue
        change = ((T_new.s - T.s).abs() + torch.linalg.matrix_norm(T_new.R - T.R)
                  + torch.linalg.vector_norm(T_new.t - T.t))
        T = Sim3(*(torch.where(running, new, old) for new, old in zip(T_new, T)))
        # a NaN change fails `>= tol`, as it ends the JAX package's loop
        running = running & (change >= tol)

    pred = T.s * (src @ T.R.T) + T.t
    r2 = torch.sum((dst - pred) ** 2, dim=-1)
    rmse = torch.sqrt(torch.sum(c / (c.sum() + 1e-8) * r2))

    n_eff = torch.sum(c > 0)
    enough = n_eff >= min_points
    T = Sim3(
        torch.where(enough, T.s, torch.ones_like(T.s)),
        torch.where(enough, T.R, torch.eye(3, device=src.device)),
        torch.where(enough, T.t, torch.zeros_like(T.t)),
    )
    return RegistrationResult(T, torch.where(enough, rmse, torch.zeros_like(rmse)), n_eff)
