"""The port's tile rasterizer (``ops/rasterize.py``) against the JAX package's
on the CPU, on numpy-made scenes of ``tests/test_rasterize.py``'s kind.

Tolerances: projected fields 1e-5; the bin tables and overflow counts
equal; rgb and alpha 2e-5 (JAX's own tiled-vs-dense bound); gradients of a
photometric loss 1e-4 of the largest JAX entry.  The scenes keep opacity
below 0.995 (``jnp.clip``'s gradient at a bound is 1/2, ``torch.clamp``'s 1)
and have distinct depths (``lax.sort`` orders tied keys as it likes).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from da3slam_tpu.ops import rasterize as jr
from da3slam_tpu_torch.core import transforms
from da3slam_tpu_torch.ops import rasterize as tr

torch.set_num_threads(2)

HW = (64, 96)
RAGGED = (50, 70)  # not a multiple of the 16-pixel tile


def make_scene(seed: int, G: int = 40, spread: float = 0.6, hw=HW) -> list[np.ndarray]:
    """Random splats in front of an identity camera (``test_rasterize.py``'s
    ``make_scene``): means, scales, quats, colors, opacity, K, E as f32."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-spread, spread, G), rng.uniform(-spread * 0.6, spread * 0.6, G),
                      rng.uniform(2.0, 4.0, G)], -1)
    scales = rng.uniform(0.02, 0.08, (G, 3))
    quats = rng.normal(size=(G, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    colors = rng.uniform(0.1, 0.9, (G, 3))
    opacity = rng.uniform(0.3, 0.9, G)
    K = np.array([[80.0, 0, hw[1] / 2], [0, 80.0, hw[0] / 2], [0, 0, 1.0]])
    E = np.eye(4)[:3]
    return [np.asarray(a, np.float32) for a in (means, scales, quats, colors, opacity, K, E)]


def J(arrays):
    return [jnp.asarray(a) for a in arrays]


def T(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def proj_pair(scene, hw=HW):
    m, s, q, _, _, K, E = scene
    return (jr.project_gaussians(*J((m, s, q, K, E)), hw),
            tr.project_gaussians(*T((m, s, q, K, E)), hw))


def coincident_scene(G: int = 50):
    """``test_rasterize.py::test_overflow_counted``: G coincident splats at a
    mid-tile point."""
    return [np.tile(np.float32([[-0.16, -0.16, 2.0]]), (G, 1)), np.full((G, 3), 0.01, np.float32),
            np.tile(np.float32([[1.0, 0, 0, 0]]), (G, 1)), None, None,
            np.float32([[100.0, 0, 48.0], [0, 100.0, 32.0], [0, 0, 1]]),
            np.eye(4, dtype=np.float32)[:3]]


class TestProjection:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_project_gaussians_matches_jax(self, seed):
        pj, pt = proj_pair(make_scene(seed))
        for name, a, b in zip(pj._fields, pj, pt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, err_msg=name)
        assert (pt.radius > 0).any()

    def test_culled_behind_and_off_screen(self):
        scene = make_scene(3, G=6)
        scene[0][:3, 2] = -1.0      # behind the camera
        scene[0][3:, 0] = 50.0      # far off to the right
        pj, pt = proj_pair(scene)
        np.testing.assert_array_equal(pt.radius.numpy(), np.asarray(pj.radius))
        assert (pt.radius == 0).all()

    def test_quat_to_rotmat_keeps_its_own_floor(self):
        """The rasterizer floors the norm at 1e-12 (``core/transforms`` at
        1e-8): a quaternion of norm 1e-10 still gives its rotation."""
        rng = np.random.default_rng(4)
        q = rng.normal(size=(16, 4)).astype(np.float32)
        q[:4] *= 1e-10
        R = tr.quat_to_rotmat(torch.from_numpy(q))
        np.testing.assert_allclose(R.numpy(), np.asarray(jr.quat_to_rotmat(jnp.asarray(q))),
                                   atol=1e-6)
        np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, atol=1e-5)
        assert not torch.allclose(transforms.quat_to_rotmat(torch.from_numpy(q[:4])), R[:4],
                                  atol=1e-2)


class TestBinning:
    @pytest.mark.parametrize("seed,K,fan", [(1, 64, 7), (2, 64, 9), (3, 8, 5), (5, 4, 3)])
    def test_table_and_overflow_equal_jax(self, seed, K, fan):
        pj, pt = proj_pair(make_scene(seed))
        tj, oj = jr.bin_splats(pj, HW, tile=16, max_per_tile=K, fan=fan)
        tt, ot = tr.bin_splats(pt, HW, tile=16, max_per_tile=K, fan=fan)
        assert tt.dtype == ot.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        # front to back inside each tile
        depth = pt.depth.numpy()
        for row in tt.numpy():
            idx = row[row >= 0]
            assert (np.diff(depth[idx]) >= 0).all()

    def test_overflow_counted_as_jax(self):
        """50 coincident splats, K = 8: 42 dropped triples, all counted in
        tile 0's slot as the JAX package counts them."""
        m, s, q, _, _, K, E = coincident_scene()
        pj = jr.project_gaussians(*J((m, s, q, K, E)), HW)
        pt = tr.project_gaussians(*T((m, s, q, K, E)), HW)
        tj, oj = jr.bin_splats(pj, HW, tile=16, max_per_tile=8, fan=3)
        tt, ot = tr.bin_splats(pt, HW, tile=16, max_per_tile=8, fan=3)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        assert int((tt >= 0).sum()) == 8 and int(ot.sum()) == 42 and int(ot[0]) == 42

    def test_sort_key_orders_tile_then_depth(self):
        rng = np.random.default_rng(6)
        tile = torch.from_numpy(rng.integers(0, 5, 200))
        depth = torch.from_numpy(rng.uniform(0.01, 50.0, 200).astype(np.float32))
        # dropped triples: tile T with any depth, negative ones included
        tile[:20] = 5
        depth[:10] = -depth[:10]
        order = torch.sort(tr.sort_keys(tile, depth), stable=True).indices
        ref = np.lexsort((depth.numpy(), tile.numpy()))
        kept = tile[ref] < 5
        np.testing.assert_array_equal(order.numpy()[kept.numpy()], ref[kept.numpy()])
        assert (tile[order][-20:] == 5).all()


class TestRasterize:
    @pytest.mark.parametrize("seed", [2, 3])
    @pytest.mark.parametrize("hw", [HW, RAGGED])
    def test_matches_jax_and_dense(self, seed, hw):
        scene = make_scene(seed, hw=hw)
        rgb_j, a_j, aux_j = jr.rasterize(*J(scene), hw, tile=16, max_per_tile=64, fan=9)
        rgb_t, a_t, aux_t = tr.rasterize(*T(scene), hw, tile=16, max_per_tile=64, fan=9)
        assert rgb_t.shape == (*hw, 3) and a_t.shape == hw
        np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=2e-5)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=2e-5)
        np.testing.assert_array_equal(aux_t["overflow"].numpy(), np.asarray(aux_j["overflow"]))
        assert int(aux_t["n_binned"]) == int(aux_j["n_binned"]) > 0
        rgb_d, a_d = tr.rasterize_dense(*T(scene), hw)
        np.testing.assert_allclose(rgb_t.numpy(), rgb_d.numpy(), atol=2e-5)
        np.testing.assert_allclose(a_t.numpy(), a_d.numpy(), atol=2e-5)
        rgb_jd, _ = jr.rasterize_dense(*J(scene), hw)
        np.testing.assert_allclose(rgb_d.numpy(), np.asarray(rgb_jd), atol=2e-5)

    def test_default_binning_and_background(self):
        scene = make_scene(4, G=5)
        bg = np.float32([0.2, 0.4, 0.6])
        rgb_j, a_j, _ = jr.rasterize(*J(scene), HW, bg=jnp.asarray(bg))
        rgb_t, a_t, _ = tr.rasterize(*T(scene), HW, bg=torch.from_numpy(bg))
        np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=2e-5)
        empty = a_t.numpy() < 1e-6
        assert empty.any()
        np.testing.assert_allclose(rgb_t.numpy()[empty], np.broadcast_to(bg, (empty.sum(), 3)),
                                   atol=1e-6)

    def test_front_splat_wins(self):
        K = torch.tensor([[100.0, 0, 48.0], [0, 100.0, 32.0], [0, 0, 1]])
        means = torch.tensor([[0.0, 0.0, 4.0], [0.0, 0.0, 2.0]])  # far blue, near red
        rgb, _, _ = tr.rasterize(means, torch.full((2, 3), 0.15), torch.tensor([[1.0, 0, 0, 0]] * 2),
                                 torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]]),
                                 torch.tensor([0.95, 0.95]), K, torch.eye(4)[:3], HW)
        center = rgb[32, 48]
        assert center[0] > 0.9 and center[2] < 0.06


class TestGradients:
    @pytest.mark.parametrize("seed,G", [(5, 12), (2, 40)])
    def test_photometric_grads_match_jax(self, seed, G):
        scene = make_scene(seed, G=G)
        target = np.random.default_rng(seed + 100).uniform(0, 1, (*HW, 3)).astype(np.float32)
        Kj, Ej = J(scene[5:])

        def jloss(*splats):
            rgb, _, _ = jr.rasterize(*splats, Kj, Ej, HW, max_per_tile=64, fan=9)
            return jnp.mean((rgb - target) ** 2)

        gj = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*J(scene[:5]))
        splats = [x.requires_grad_(True) for x in T(scene[:5])]
        rgb, _, _ = tr.rasterize(*splats, *T(scene[5:]), HW, max_per_tile=64, fan=9)
        torch.mean((rgb - torch.from_numpy(target)) ** 2).backward()
        for name, a, p in zip(("means", "scales", "quats", "colors", "opacity"), gj, splats):
            a = np.asarray(a)
            assert np.abs(a).max() > 0, name
            np.testing.assert_allclose(p.grad.numpy(), a, atol=1e-4 * np.abs(a).max(), err_msg=name)

    def test_mean_grad_matches_finite_difference(self):
        K = torch.tensor([[100.0, 0, 48.0], [0, 100.0, 32.0], [0, 0, 1]])
        E = torch.eye(4)[:3]

        def loss(mx):
            means = torch.stack([mx, torch.zeros(()), torch.tensor(2.0)])[None]
            rgb, _, _ = tr.rasterize(means, torch.full((1, 3), 0.1), torch.tensor([[1.0, 0, 0, 0]]),
                                     torch.ones(1, 3), torch.tensor([0.8]), K, E, HW)
            # an asymmetric target puts pressure along x
            return torch.mean(rgb[:, :48] ** 2) + torch.mean((rgb[:, 48:] - 1.0) ** 2)

        mx = torch.tensor(0.01, requires_grad=True)
        loss(mx).backward()
        eps = 1e-3
        fd = (loss(torch.tensor(0.01 + eps)) - loss(torch.tensor(0.01 - eps))).item() / (2 * eps)
        assert mx.grad.item() == pytest.approx(fd, rel=0.05, abs=1e-5)
