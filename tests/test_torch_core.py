"""The port's transforms and geometry against ``da3slam_tpu.core``.

Inputs are made from a seed with numpy and fed to both packages; f32
throughout, atol 1e-5 unless a test says otherwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from da3slam_tpu.core import geometry as jg
from da3slam_tpu.core import transforms as jt
from da3slam_tpu_torch.core import geometry as tg
from da3slam_tpu_torch.core import transforms as tt

torch.set_num_threads(2)
ATOL = 1e-5


def rand_rot(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return np.array(jt.quat_to_rotmat(jnp.asarray(q)))


def rand_w2c(rng, n):
    t = rng.normal(size=(n, 3, 1)).astype(np.float32)
    return np.concatenate([rand_rot(rng, n), t], axis=-1)


def close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=atol)


class TestTransforms:
    def test_quat_to_rotmat(self):
        q = np.random.default_rng(0).normal(size=(7, 4)).astype(np.float32)
        close(tt.quat_to_rotmat(torch.from_numpy(q)), jt.quat_to_rotmat(jnp.asarray(q)))

    @pytest.mark.parametrize("rows", [3, 4])
    def test_se3_inverse(self, rows):
        E = rand_w2c(np.random.default_rng(1), 5)
        if rows == 4:
            E = np.array(jt.se3_to_4x4(jnp.asarray(E)))
            close(tt.se3_to_4x4(torch.from_numpy(E[:, :3])), E)
        close(tt.se3_inverse(torch.from_numpy(E)), jt.se3_inverse(jnp.asarray(E)))

    def test_se3_compose(self):
        rng = np.random.default_rng(2)
        A, B = rand_w2c(rng, 4), rand_w2c(rng, 4)
        close(tt.se3_compose(torch.from_numpy(A), torch.from_numpy(B)),
              jt.se3_compose(jnp.asarray(A), jnp.asarray(B)))

    @pytest.mark.parametrize("kind", ["perturbed", "icp_update", "icp_update_1e2", "icp_update_1e4"])
    def test_orthonormalize_rotation(self, kind):
        """The port's scaled Newton polar iteration against the JAX package's
        SVD projection: rotations + 1e-1 noise, the ICP's I + [ω]× with |ω|
        from 1e-4 to ~5, and with |ω| = 1e2 and 1e4 (a near-degenerate
        ICP solve)."""
        rng = np.random.default_rng(3)
        if kind == "perturbed":
            R = rand_rot(rng, 64) + 1e-1 * rng.normal(size=(64, 3, 3)).astype(np.float32)
        else:
            w = rng.normal(size=(64, 3))
            if kind == "icp_update":
                w = w * np.geomspace(1e-4, 3, 64)[:, None]
            else:
                w = w / np.linalg.norm(w, axis=1, keepdims=True) * float(kind.rsplit("_", 1)[1])
            w = w.astype(np.float32)
            R = np.tile(np.eye(3, dtype=np.float32), (64, 1, 1))
            R[:, 0, 1], R[:, 0, 2], R[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
            R[:, 1, 0], R[:, 2, 0], R[:, 2, 1] = w[:, 2], -w[:, 1], w[:, 0]
        out = tt.orthonormalize_rotation(torch.from_numpy(R))
        close(out, jt.orthonormalize_rotation(jnp.asarray(R)))
        eye = out @ out.transpose(-1, -2)
        np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(3), eye.shape), atol=1e-5)
        np.testing.assert_allclose(torch.linalg.det(out).numpy(), 1.0, atol=1e-5)

    def test_sim3_compose_and_inverse(self):
        rng = np.random.default_rng(4)

        def sim3():
            s = rng.uniform(0.5, 2.0, size=(3,)).astype(np.float32)
            R = rand_rot(rng, 3)
            t = rng.normal(size=(3, 3)).astype(np.float32)
            return s, R, t

        a, b = sim3(), sim3()
        ta, tb = (tt.Sim3(*(torch.from_numpy(x) for x in p)) for p in (a, b))
        ja, jb = (jt.Sim3(*(jnp.asarray(x) for x in p)) for p in (a, b))
        for t_out, j_out in zip(tt.sim3_compose(ta, tb), jt.sim3_compose(ja, jb)):
            close(t_out, j_out)
        for t_out, j_out in zip(tt.sim3_inverse(ta), jt.sim3_inverse(ja)):
            close(t_out, j_out)

    def test_highest_precision_restores_tf32_flags(self):
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            with tt.highest_precision():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class TestGeometry:
    def test_pixel_grid_and_invert_intrinsics(self):
        close(tg.pixel_grid(5, 7), jg.pixel_grid(5, 7))
        K = np.array([[[50.0, 0, 31.5], [0, 52.0, 23.0], [0, 0, 1]]] * 2, np.float32)
        close(tg._invert_intrinsics(torch.from_numpy(K)), jg._invert_intrinsics(jnp.asarray(K)))

    @pytest.mark.parametrize("with_extrinsics", [False, True])
    def test_backproject_depth(self, with_extrinsics):
        rng = np.random.default_rng(5)
        depth = rng.uniform(0.5, 4.0, size=(2, 12, 16)).astype(np.float32)
        K = np.array([[[20.0, 0, 8.0], [0, 21.0, 6.0], [0, 0, 1]]] * 2, np.float32)
        E = rand_w2c(rng, 2) if with_extrinsics else None
        t_out = tg.backproject_depth(torch.from_numpy(depth), torch.from_numpy(K),
                                     None if E is None else torch.from_numpy(E))
        j_out = jg.backproject_depth(jnp.asarray(depth), jnp.asarray(K),
                                     None if E is None else jnp.asarray(E))
        close(t_out, j_out, atol=2e-5)

    @pytest.mark.parametrize(
        "n_valid",
        [
            64,  # even count: the median averages the two middle ratios
            63,  # odd count
            20,  # below min_points: falls back to 1.0
        ],
    )
    def test_depth_scale_masked_median(self, n_valid):
        rng = np.random.default_rng(6)
        d_prev = rng.uniform(0.5, 3.0, size=(10, 10)).astype(np.float32)
        d_cur = rng.uniform(0.5, 3.0, size=(10, 10)).astype(np.float32)
        conf_prev = np.full((10, 10), 1.5, np.float32)
        conf_cur = np.full((10, 10), 1.5, np.float32)
        flat = conf_cur.reshape(-1)
        flat[rng.permutation(100)[n_valid:]] = 0.1  # below conf_th: masked
        args = (d_prev, d_cur, conf_prev, conf_cur)
        t_out = tg.depth_scale_ratio(*(torch.from_numpy(a) for a in args))
        j_out = jg.depth_scale_ratio(*(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(float(t_out), float(j_out), atol=ATOL)
        ratios = np.sort((d_prev / d_cur).reshape(-1)[flat > 0.2])
        if n_valid >= 50:
            mid = n_valid // 2
            expect = ratios[mid] if n_valid % 2 else 0.5 * (ratios[mid - 1] + ratios[mid])
            np.testing.assert_allclose(float(t_out), expect, rtol=1e-6)
        else:
            assert float(t_out) == 1.0

    def test_depth_scale_drops_nonfinite_and_nonpositive(self):
        rng = np.random.default_rng(7)
        d_prev = rng.uniform(0.5, 3.0, size=(12, 12)).astype(np.float32)
        d_cur = (d_prev / 1.7).astype(np.float32)
        d_cur[0, :6] = np.inf
        d_cur[1, :6] = -1.0
        d_prev[2, :6] = np.nan
        t_out = tg.depth_scale_ratio(torch.from_numpy(d_prev), torch.from_numpy(d_cur))
        j_out = jg.depth_scale_ratio(jnp.asarray(d_prev), jnp.asarray(d_cur))
        np.testing.assert_allclose(float(t_out), float(j_out), atol=ATOL)
        np.testing.assert_allclose(float(t_out), 1.7, rtol=1e-5)


class TestPublicNames:
    """The helpers no path of the port calls, held to the JAX package's
    (ROADMAP queue 1, item 13e)."""

    def test_se3_from_4x4(self):
        E = rand_w2c(np.random.default_rng(8), 3)
        E4 = np.array(jt.se3_to_4x4(jnp.asarray(E)))
        close(tt.se3_from_4x4(torch.from_numpy(E4)), jt.se3_from_4x4(jnp.asarray(E4)), atol=0)
        close(tt.se3_from_4x4(tt.se3_to_4x4(torch.from_numpy(E))), E, atol=0)

    @pytest.mark.parametrize("mode", ["minus_one_to_one", "zero_to_one"])
    def test_pixel_tracks(self, mode):
        """``tests/test_misc.py::TestTrackNormalization``'s round trip, both
        packages on the same tracks."""
        tracks = np.random.default_rng(0).uniform(0, 63, (10, 5, 2)).astype(np.float32)
        n = tg.normalize_pixel_tracks(torch.from_numpy(tracks), (48, 64), mode)
        close(n, jg.normalize_pixel_tracks(jnp.asarray(tracks), (48, 64), mode), atol=1e-7)
        back = tg.denormalize_pixel_tracks(n, (48, 64), mode)
        close(back, jg.denormalize_pixel_tracks(jnp.asarray(n.numpy()), (48, 64), mode),
              atol=1e-6)
        close(back, tracks, atol=1e-4)
        corners = torch.tensor([[0.0, 0.0], [63.0, 47.0]])
        want = [[-1, -1], [1, 1]] if mode == "minus_one_to_one" else [[0, 0], [1, 1]]
        close(tg.normalize_pixel_tracks(corners, (48, 64), mode), np.array(want), atol=1e-6)
        with pytest.raises(ValueError, match="unknown mode"):
            tg.normalize_pixel_tracks(corners, (48, 64), "bad")
        with pytest.raises(ValueError, match="unknown mode"):
            tg.denormalize_pixel_tracks(corners, (48, 64), "bad")

    def test_bilinear_gather(self):
        """Inside, on the border, within the half-pixel slop and beyond it."""
        from da3slam_tpu.ops import icp as jicp
        from da3slam_tpu_torch.ops import icp as ticp

        rng = np.random.default_rng(9)
        H, W = 6, 8
        pm = rng.normal(size=(H, W, 3)).astype(np.float32)
        uv = np.concatenate([
            rng.uniform(0, W - 1, (40, 2)) * [1, (H - 1) / (W - 1)],
            [[0, 0], [W - 1, H - 1], [W - 1, 0], [0, H - 1], [3.5, H - 1], [W - 1, 2.25]],
            [[-0.5, 2], [W - 0.5, 2], [3, -0.5], [3, H - 0.5], [-0.4, -0.4]],
            [[-0.51, 2], [W - 0.49, 2], [3, -2.0], [3, H + 3.0], [-5, H + 5], [W + 9, -9]],
        ]).astype(np.float32)
        vals, ok = ticp.bilinear_gather(torch.from_numpy(pm), torch.from_numpy(uv))
        jvals, jok = jicp.bilinear_gather(jnp.asarray(pm), jnp.asarray(uv))
        close(vals, jvals, atol=1e-6)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        assert ok.numpy()[:51].all() and not ok.numpy()[51:].any()
        np.testing.assert_array_equal(vals.numpy()[40], pm[0, 0])
        np.testing.assert_array_equal(vals.numpy()[41], pm[H - 1, W - 1])
