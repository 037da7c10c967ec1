"""The port's splat refinement and training (``ops/splats.py``), lens
distortion (``ops/distortion.py``) and the geometry they use
(``core/geometry.project_points``, ``core/transforms.rotmat_to_quat`` and
``slerp_rotations``, the NaN-propagating median) against the JAX package on
the CPU.

Tolerances: geometry, distortion, ``bilinear_sample`` and ``ssim`` 1e-5;
``refine_splats`` and ``train_splats`` 1e-4 after a few steps, and the JAX
tests' own outcomes after many (Adam turns sign noise in near-zero gradients
into whole steps, so parameters are not compared after many steps).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from da3slam_tpu.core import geometry as jgeom
from da3slam_tpu.core import transforms as jtf
from da3slam_tpu.ops import distortion as jdist
from da3slam_tpu.ops import rasterize as jr
from da3slam_tpu.ops import splats as js
from da3slam_tpu.utils import synthetic as jsyn
from da3slam_tpu_torch.core import geometry, transforms
from da3slam_tpu_torch.ops import distortion, splats
from test_torch_rasterize import HW, J, T, make_scene

torch.set_num_threads(2)


def rotations(n: int, seed: int) -> np.ndarray:
    """Random rotations, plus rotations by about π about each axis (where
    each of Shepperd's four candidates is the best-conditioned one)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3))
    w *= rng.uniform(0.01, math.pi, (n, 1)) / np.linalg.norm(w, axis=-1, keepdims=True)
    w[:3] = np.eye(3) * (math.pi - 1e-3)
    return transforms.so3_exp(torch.from_numpy(w.astype(np.float32))).numpy()


class TestGeometry:
    @pytest.mark.parametrize("with_extrinsics", [True, False])
    def test_project_points_matches_jax(self, with_extrinsics):
        rng = np.random.default_rng(0)
        pts = rng.normal(size=(3, 50, 3)).astype(np.float32) + np.float32([0, 0, 4])
        K = np.tile(np.float32([[90, 0, 40], [0, 95, 30], [0, 0, 1]]), (3, 1, 1))
        E = np.concatenate([rotations(3, 1), rng.normal(size=(3, 3, 1)).astype(np.float32) * 0.1],
                           -1) if with_extrinsics else None
        uv_j, z_j = jgeom.project_points(jnp.asarray(pts), jnp.asarray(K),
                                         None if E is None else jnp.asarray(E))
        uv_t, z_t = geometry.project_points(*T([pts, K]), None if E is None else torch.from_numpy(E))
        np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-5)
        np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5, atol=1e-5)

    def test_rotmat_to_quat_matches_jax(self):
        R = rotations(64, 2)
        q = transforms.rotmat_to_quat(torch.from_numpy(R)).numpy()
        np.testing.assert_allclose(q, np.asarray(jtf.rotmat_to_quat(jnp.asarray(R))), atol=1e-5)
        assert (q[:, 0] >= 0).all()
        np.testing.assert_allclose(transforms.quat_to_rotmat(torch.from_numpy(q)).numpy(), R,
                                   atol=1e-5)

    @pytest.mark.parametrize("t", [0.0, 0.3, 0.5, 1.0])
    def test_slerp_rotations_matches_jax(self, t):
        Ra, Rb = rotations(8, 3), rotations(8, 4)
        Rb[0] = Ra[0]  # parallel: the lerp branch
        out = transforms.slerp_rotations(*T([Ra, Rb]), t).numpy()
        np.testing.assert_allclose(out, np.asarray(jtf.slerp_rotations(*J([Ra, Rb]), t)), atol=1e-5)
        if t in (0.0, 1.0):
            np.testing.assert_allclose(out, Ra if t == 0.0 else Rb, atol=1e-5)

    @pytest.mark.parametrize("n,nan", [(7, False), (8, False), (8, True)])
    def test_median_as_jnp(self, n, nan):
        x = np.random.default_rng(n).normal(size=n).astype(np.float32)
        if nan:
            x[3] = np.nan
        m = geometry.median(torch.from_numpy(x)).item()
        ref = float(jnp.median(jnp.asarray(x)))
        assert (math.isnan(m) and math.isnan(ref)) if nan else m == pytest.approx(ref, abs=1e-7)


DIST_PARAMS = [[0.1], [0.08, -0.03], [0.1, -0.05, 0.01, -0.008]]


class TestDistortion:
    @pytest.mark.parametrize("params", DIST_PARAMS)
    def test_apply_and_undistort_match_jax(self, params):
        uv = np.random.default_rng(0).uniform(-0.6, 0.6, size=(500, 2)).astype(np.float32)
        p = np.float32(params)
        d_t = distortion.apply_distortion(*T([uv, p]))
        np.testing.assert_allclose(d_t.numpy(), np.asarray(jdist.apply_distortion(*J([uv, p]))),
                                   atol=1e-5)
        back = distortion.undistort_points(d_t, torch.from_numpy(p), max_iterations=10)
        back_j = jdist.undistort_points(jnp.asarray(d_t.numpy()), jnp.asarray(p), max_iterations=10)
        np.testing.assert_allclose(back.numpy(), np.asarray(back_j), atol=1e-5)
        np.testing.assert_allclose(back.numpy(), uv, atol=1e-5)

    def test_few_newton_steps_and_batch_dims_match_jax(self):
        uv = np.random.default_rng(1).uniform(-0.9, 0.9, size=(4, 30, 2)).astype(np.float32)
        p = np.float32(DIST_PARAMS[2]) * 3
        out = distortion.undistort_points(*T([uv, p]), max_iterations=2).numpy()
        np.testing.assert_allclose(out, np.asarray(jdist.undistort_points(*J([uv, p]), max_iterations=2)),
                                   atol=1e-5)

    @pytest.mark.parametrize("params", DIST_PARAMS)
    def test_distort_pixels_matches_jax(self, params):
        px = np.random.default_rng(2).uniform(0, 100, size=(2, 40, 2)).astype(np.float32)
        K = np.tile(np.float32([[90, 0, 50], [0, 95, 40], [0, 0, 1]]), (2, 1, 1))[:, None]
        p = np.float32(params)
        np.testing.assert_allclose(distortion.distort_pixels(*T([px, K, p])).numpy(),
                                   np.asarray(jdist.distort_pixels(*J([px, K, p]))), atol=1e-4,
                                   rtol=1e-5)

    def test_zero_params_is_identity(self):
        uv = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (100, 2)).astype(np.float32))
        assert torch.equal(distortion.apply_distortion(uv, torch.zeros(4)), uv)


class TestSampleAndSsim:
    @pytest.mark.parametrize("channels", [None, 3])
    def test_bilinear_sample_matches_jax(self, channels):
        rng = np.random.default_rng(3)
        img = rng.normal(size=(9, 11) + ((channels,) if channels else ())).astype(np.float32)
        uv = rng.uniform(-2, 13, size=(200, 2)).astype(np.float32)
        uv[:3] = [[3.0, 2.0], [0.0, 0.0], [10.0, 8.0]]
        out = splats.bilinear_sample(*T([img, uv])).numpy()
        np.testing.assert_allclose(out, np.asarray(js.bilinear_sample(*J([img, uv]))), atol=1e-5)
        np.testing.assert_allclose(out[:3], [img[2, 3], img[0, 0], img[8, 10]], atol=1e-6)

    def test_ssim_and_its_gradient_match_jax(self):
        rng = np.random.default_rng(8)
        a = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
        assert splats.ssim(*T([a, a])).item() == pytest.approx(1.0, abs=1e-5)
        x = torch.from_numpy(b).requires_grad_(True)
        s = splats.ssim(x, torch.from_numpy(a))
        s.backward()
        assert s.item() == pytest.approx(float(js.ssim(*J([b, a]))), abs=1e-5) and s.item() < 0.9
        g = np.asarray(jax.grad(lambda y: js.ssim(y, jnp.asarray(a)))(jnp.asarray(b)))
        np.testing.assert_allclose(x.grad.numpy(), g, atol=1e-5 * max(1.0, np.abs(g).max()))


# ---------------------------------------------------------------------------
# refine_splats on test_splats.py's world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    hw = (64, 80)
    poses = jsyn.make_trajectory(5)
    K = jsyn.default_intrinsics(hw)
    depth = np.stack([jsyn.render_depth(E, K, hw) for E in poses]).astype(np.float32)
    images = np.stack([jsyn.render_rgb(E, K, hw) for E in poses])
    Ks = np.tile(K[None], (5, 1, 1)).astype(np.float32)
    return hw, poses.astype(np.float32), Ks, depth, images


def init_splats(world, n=400, noise=0.03, seed=0):
    """``test_splats.py``'s initial splats: view 0's surface points, noised."""
    hw, poses, Ks, depth, images = world
    rng = np.random.default_rng(seed)
    H, W = hw
    vs, us = rng.integers(2, H - 2, n), rng.integers(2, W - 2, n)
    z = depth[0][vs, us]
    K = Ks[0]
    rays = np.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1], np.ones(n)], -1)
    R, t = poses[0][:3, :3], poses[0][:3, 3]
    pts = (rays * z[:, None] - t) @ R + rng.normal(size=(n, 3)) * noise
    colors = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    return pts.astype(np.float32), colors, np.full(n, 0.7, np.float32)


def plane_distance(pts: np.ndarray) -> np.ndarray:
    d = np.full(pts.shape[0], np.inf)
    for n, c in jsyn.PLANES:
        d = np.minimum(d, np.abs(pts @ n - c))
    return d


def depths(world, zero_pixel: bool) -> np.ndarray:
    d = world[3].copy()
    if zero_pixel:
        d[2, 10, 7] = 0.0
    return d


class TestRefineSplats:
    @pytest.mark.parametrize("zero_pixel", [False, True])
    def test_scene_scale_is_the_jnp_median(self, world, zero_pixel):
        """One step moves each coordinate by at most lr_points_rel × scene
        scale (Adam's first step is ±lr where |g| ≫ eps).  The scale is the
        median depth, and 1.0 as soon as one depth pixel is ≤ 1e-6
        (``jnp.median`` of a NaN is NaN, then ``nan_to_num``): both packages."""
        hw, poses, Ks, _, images = world
        d = depths(world, zero_pixel)
        pts, colors, op = init_splats(world)
        scale = 1.0 if zero_pixel else float(np.median(d))
        args = (pts, colors, op, d, images, Ks, poses)
        step_t = (splats.refine_splats(*T(args), iters=1).points.numpy() - pts).__abs__().max()
        step_j = np.abs(np.asarray(js.refine_splats(*J(args), iters=1).points) - pts).max()
        for step in (step_t, step_j):
            assert step == pytest.approx(3e-4 * scale, rel=1e-2)

    @pytest.mark.parametrize("zero_pixel", [False, True])
    def test_few_steps_match_jax(self, world, zero_pixel):
        """Three steps.  The positions' lateral gradients are differences of
        near-equal terms (1e-12 to 1e-9 against an Adam eps of 1e-8), so f32
        rounding moves them by a share of a step: the JAX package's jitted
        and eager programs differ by 5e-4 here.  The port is held to the
        eager program within 1e-4 × scene scale, and no further from the
        jitted one than the eager one is, plus that."""
        hw, poses, Ks, _, images = world
        d = depths(world, zero_pixel)
        pts, colors, op = init_splats(world)
        args = (pts, colors, op, d, images, Ks, poses)
        rt = splats.refine_splats(*T(args), iters=3)
        rj = js.refine_splats(*J(args), iters=3)
        with jax.disable_jit():
            re = js.refine_splats(*J(args), iters=3)
        for name in ("colors", "opacity", "support", "losses"):
            np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                       atol=1e-4, err_msg=name)
        tol = 1e-4 * (1.0 if zero_pixel else float(np.median(d)))
        eager = np.abs(rt.points.numpy() - np.asarray(re.points)).max()
        jitted = np.abs(rt.points.numpy() - np.asarray(rj.points)).max()
        spread = np.abs(np.asarray(rj.points) - np.asarray(re.points)).max()
        assert eager <= tol and jitted <= spread + tol, (eager, jitted, spread, tol)

    def test_geometry_improves_and_colors_converge(self, world):
        hw, poses, Ks, depth, images = world
        pts, colors, op = init_splats(world)
        res = splats.refine_splats(*T((pts, colors, op, depth, images, Ks, poses)), iters=60)
        assert plane_distance(res.points.numpy()).mean() < 0.6 * plane_distance(pts).mean()
        losses = res.losses.numpy()
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        uv, _ = geometry.project_points(res.points[None], *T([Ks[:1], poses[:1]]))
        obs = splats.bilinear_sample(torch.from_numpy(images[0]).float() / 255.0, uv[0]).numpy()
        assert np.abs(res.colors.numpy() - obs).mean() < 0.5 * np.abs(colors - obs).mean()

    def test_floaters_lose_opacity(self, world):
        hw, poses, Ks, depth, images = world
        pts, colors, op = init_splats(world, noise=0.005)
        n = pts.shape[0]
        # the last quarter floats: pulled 35% toward view 0's camera center
        R, t = poses[0][:3, :3], poses[0][:3, 3]
        idx = np.arange(3 * n // 4, n)
        pts[idx] = pts[idx] + 0.35 * (-R.T @ t - pts[idx])
        res = splats.refine_splats(*T((pts, colors, op, depth, images, Ks, poses)), iters=60)
        opacity = res.opacity.numpy()
        still_off = plane_distance(res.points.numpy()[idx]) > 0.05
        assert still_off.any()
        assert opacity[idx][still_off].mean() < 0.6 * opacity[: 3 * n // 4].mean()


# ---------------------------------------------------------------------------
# train_splats on test_rasterize.py's toy scene
# ---------------------------------------------------------------------------

def toy_scene(dead: int = 0):
    """``test_rasterize.py::test_loss_decreases_on_toy_scene``: 25 splats,
    targets rendered from two views with other colors; ``dead`` splats start
    at opacity 1e-3 (below the prune threshold)."""
    means, scales, quats, colors, opacity, K, E = make_scene(6, G=25)
    opacity[:dead] = 1e-3
    E2 = np.float32([[1, 0, 0, 0.05], [0, 1, 0, 0.0], [0, 0, 1, 0.02]])
    gt = np.random.default_rng(7).uniform(0.1, 0.9, colors.shape).astype(np.float32)
    imgs = np.stack([np.asarray(jr.rasterize(*J((means, scales, quats, gt, opacity, K, e)), HW)[0])
                     for e in (E, E2)])
    return [means, scales, quats, colors, opacity, imgs, np.stack([K, K]), np.stack([E, E2])]


def assert_train_close(rt, rj, skip=()):
    for name in rj._fields:
        if name in skip:
            continue
        a = np.asarray(getattr(rj, name))
        np.testing.assert_allclose(getattr(rt, name).numpy(), a, atol=1e-4 * np.abs(a).max(),
                                   err_msg=name)


class TestTrainSplats:
    def test_few_steps_match_jax(self):
        args = toy_scene()
        kw = dict(iters=3, max_per_tile=64, fan=9)
        assert_train_close(splats.train_splats(*T(args), HW, **kw),
                           js.train_splats(*J(args), HW, **kw))

    def test_loss_decreases_on_toy_scene(self):
        res = splats.train_splats(*T(toy_scene()), HW, iters=30, max_per_tile=64, fan=9)
        losses = res.losses.numpy()
        assert np.isfinite(losses).all() and losses[-1] < 0.6 * losses[0]
        assert np.isfinite(res.points.numpy()).all()
        np.testing.assert_allclose(torch.linalg.vector_norm(res.quats, dim=-1).numpy(), 1.0,
                                   atol=1e-5)

    def test_densify_matches_jax(self, monkeypatch):
        """``iters == densify_every``: only the last step resamples.  With the
        JAX package's own jitter draw substituted every parameter matches; with
        the port's draw every parameter but the resampled positions does, and
        those lie within 6 donor-σ of their donor on each axis.  The scene is
        the toy scene with dead splats: ``test_rasterize.py``'s densify scene
        takes its own initial render as the target, so its loss starts at
        rounding noise and every Adam step there is sign noise."""
        n, G, dead = 3, 25, 8
        args = toy_scene(dead)
        kw = dict(iters=n, max_per_tile=64, fan=9, densify_every=n)
        rj = js.train_splats(*J(args), HW, **kw)
        own = splats.train_splats(*T(args), HW, **kw)
        key = jax.random.PRNGKey(0)
        for _ in range(n):
            key, sub = jax.random.split(key)
        jax_draw = torch.from_numpy(np.array(jax.random.normal(sub, (G, 3))))
        monkeypatch.setattr(splats, "jitter_directions", lambda *_: jax_draw)
        assert_train_close(splats.train_splats(*T(args), HW, **kw), rj)
        monkeypatch.setattr(splats, "jitter_directions", lambda *_: torch.zeros(G, 3))
        at_donor = splats.train_splats(*T(args), HW, **kw)
        assert_train_close(own, rj, skip=("points",))
        resampled = np.asarray(rj.opacity)[:dead] >= 0.1 - 1e-6
        assert resampled.all()
        np.testing.assert_allclose(own.points[dead:].numpy(), np.asarray(rj.points)[dead:],
                                   atol=1e-4 * np.abs(np.asarray(rj.points)).max())
        sigma_donor = 1.6 * own.scales[:dead].numpy()
        offset = np.abs(own.points[:dead].numpy() - at_donor.points[:dead].numpy())
        assert (offset <= 6 * sigma_donor).all() and offset.max() > 0
