"""The port's registration, alignment, solver and CLI against ``da3slam_tpu``.

Geometry comes from ``da3slam_tpu.utils.synthetic`` (a closed-form corner
room) or from the real tiny model with the JAX package's seed-0 weights
carried over by ``convert``; both packages get the same numpy inputs.  f32 on
the CPU.  Tolerances: 1e-5 for closed-form math; 1e-4 where an iterative
f32 solve (ICP) or a chain of chunk alignments compounds rounding.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from da3slam_tpu.core.geometry import backproject_depth as jbackproject
from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import DepthAnything3 as JDA3
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.ops import icp as jicp
from da3slam_tpu.ops import registration as jreg
from da3slam_tpu.slam import alignment as jalign
from da3slam_tpu.slam.chunks import make_chunk_indices as jchunks
from da3slam_tpu.slam.solver import SLAMSolver as JSolver
from da3slam_tpu.utils.synthetic import (
    SyntheticDA3,
    make_synthetic_image_dir,
    make_trajectory,
    render_depth,
)
from da3slam_tpu_torch.core.geometry import backproject_depth
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net
from da3slam_tpu_torch.models.da3 import DepthAnything3 as TDA3
from da3slam_tpu_torch.ops import icp, registration
from da3slam_tpu_torch.slam import alignment
from da3slam_tpu_torch.slam.chunks import make_chunk_indices
from da3slam_tpu_torch.slam.solver import SLAMSolver

torch.set_num_threads(2)

HW = (48, 64)
K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]], np.float32)


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


def J(x):
    return jnp.asarray(np.array(x, np.float32))


def local_chunk(poses, idxs, scale=1.0):
    """Chunk-local w2c (first frame = identity) and depth, as SyntheticDA3."""
    E_ref = np.eye(4)
    E_ref[:3] = poses[idxs[0]]
    inv = np.linalg.inv(E_ref)
    ext = []
    for i in idxs:
        E = np.eye(4)
        E[:3] = poses[i]
        ext.append((E @ inv)[:3])
    ext = np.stack(ext).astype(np.float32)
    ext[:, :, 3] *= scale
    depth = np.stack([render_depth(poses[i], K, HW) for i in idxs]) * scale
    return depth.astype(np.float32), ext


class TestChunks:
    @pytest.mark.parametrize("n,c,o", [(10, 4, 1), (11, 4, 1), (3, 5, 1), (31, 15, 1), (13, 5, 2)])
    def test_matches_jax(self, n, c, o):
        assert make_chunk_indices(n, c, o) == jchunks(n, c, o)

    def test_invalid_overlap_raises(self):
        with pytest.raises(ValueError):
            make_chunk_indices(10, 3, 3)


class TestRegistration:
    def test_estimate_normals(self):
        depth = render_depth(make_trajectory(3)[1], K, HW)
        pm = np.asarray(jbackproject(J(depth), J(K)))
        np.testing.assert_allclose(icp.estimate_normals(T(pm)).numpy(),
                                   np.asarray(jicp.estimate_normals(J(pm))), atol=1e-5)

    @pytest.mark.parametrize("with_scale", [False, True])
    def test_icp_point_to_point(self, with_scale):
        """The overlap case: the target frame's own cloud, moved by a small
        known similarity; ICP recovers its inverse.  The surface is bumpy so
        that all 6-7 degrees of freedom are observable (the corner room seen
        head-on is nearly one plane)."""
        v, u = np.mgrid[0:HW[0], 0:HW[1]].astype(np.float32)
        depth = 2.5 + 0.4 * np.sin(u / 5.0) * np.cos(v / 4.0) + 0.2 * np.sin((u + v) / 9.0)
        tgt = np.asarray(jbackproject(J(depth), J(K)))
        ang = 0.02
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        s = 1.03 if with_scale else 1.0
        src = (s * tgt[::4, ::4].reshape(-1, 3) @ R.T + [0.01, -0.02, 0.015]).astype(np.float32)
        kw = dict(threshold=0.1, max_iterations=12, with_scale=with_scale)
        jr = jicp.icp_point_to_point(J(src), J(tgt), J(K), **kw)
        tr = icp.icp_point_to_point(T(src), T(tgt), T(K), **kw)
        for a, b in zip(tr.transform, jr.transform):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
        np.testing.assert_allclose(float(tr.fitness), float(jr.fitness), atol=1e-3)
        np.testing.assert_allclose(float(tr.inlier_rmse), float(jr.inlier_rmse), atol=1e-4)
        np.testing.assert_allclose(tr.transform.R.numpy(), R.T, atol=1e-3)
        np.testing.assert_allclose(float(tr.transform.s), 1 / s, atol=1e-3)
        assert float(tr.fitness) > 0.9

    @pytest.mark.parametrize("with_scale", [False, True])
    def test_weighted_umeyama(self, with_scale):
        rng = np.random.default_rng(0)
        src = rng.normal(size=(200, 3)).astype(np.float32)
        ang = 0.3
        R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        dst = (1.3 * src @ R.T + np.array([0.2, -0.1, 0.5])).astype(np.float32)
        dst += rng.normal(scale=1e-3, size=dst.shape).astype(np.float32)
        w = rng.uniform(0, 1, size=200).astype(np.float32)
        w[:20] = 0
        jr = jreg.weighted_umeyama(J(src), J(dst), J(w), with_scale)
        tr = registration.weighted_umeyama(T(src), T(dst), T(w), with_scale)
        for a, b in zip(tr, jr):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)

    def test_umeyama_and_huber_weights(self):
        rng = np.random.default_rng(1)
        src = rng.normal(size=(50, 3)).astype(np.float32)
        dst = (0.8 * src[:, [1, 2, 0]] + 0.3).astype(np.float32)
        for a, b in zip(registration.umeyama(T(src), T(dst)), jreg.umeyama(J(src), J(dst))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        r = np.array([0.0, 0.05, 0.1, 0.2, -3.0, 1e-13], np.float32)
        np.testing.assert_allclose(registration.huber_weights(T(r), 0.1).numpy(),
                                   np.asarray(jreg.huber_weights(J(r), 0.1)), rtol=1e-6)

    @staticmethod
    def irls_case(n=400, outliers=40, seed=2):
        rng = np.random.default_rng(seed)
        src = rng.normal(size=(n, 3)).astype(np.float32)
        ang = 0.2
        R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        dst = (1.1 * src @ R.T + np.array([0.1, 0.2, -0.3])).astype(np.float32)
        dst += rng.normal(scale=2e-3, size=dst.shape).astype(np.float32)
        dst[:outliers] += rng.normal(scale=0.8, size=(outliers, 3)).astype(np.float32)
        conf = rng.uniform(0.2, 2.0, size=n).astype(np.float32)
        return src, dst, conf

    # tol None: the fixed count.  1e-9: never reached in max_iters steps.  3e-2:
    # reached after a few steps, so the frozen carry must equal JAX's early
    # exit (its while_loop stops; the port runs on and keeps the converged
    # transform).  10.0: reached at the first step.
    # The comparison's atol is 1e-5: closed-form f32 steps from the same inputs.
    @pytest.mark.parametrize("tol", [None, 1e-9, 3e-2, 10.0])
    @pytest.mark.parametrize("with_scale", [False, True])
    def test_irls_sim3(self, tol, with_scale):
        src, dst, conf = self.irls_case()
        kw = dict(delta=0.1, max_iters=6, with_scale=with_scale, tol=tol)
        jr = jreg.irls_sim3(J(src), J(dst), J(conf), **kw)
        tr = registration.irls_sim3(T(src), T(dst), T(conf), **kw)
        for a, b in zip(tr.transform, jr.transform):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        np.testing.assert_allclose(float(tr.rmse), float(jr.rmse), atol=1e-5)
        assert int(tr.n_effective) == int(jr.n_effective) == 400

    def test_irls_tol_changes_the_result(self):
        """The early exit is live in both packages: a loose tol stops after
        the first update, which the fixed count moves on from."""
        src, dst, conf = self.irls_case()
        loose = registration.irls_sim3(T(src), T(dst), T(conf), max_iters=6, tol=10.0)
        fixed = registration.irls_sim3(T(src), T(dst), T(conf), max_iters=6)
        one = registration.irls_sim3(T(src), T(dst), T(conf), max_iters=1)
        np.testing.assert_array_equal(loose.transform.R.numpy(), one.transform.R.numpy())
        assert np.abs(loose.transform.t.numpy() - fixed.transform.t.numpy()).max() > 1e-4

    def test_irls_nonfinite_points_and_default_conf(self):
        src, dst, _ = self.irls_case()
        src[5] = np.nan
        dst[7, 1] = np.inf
        jr = jreg.irls_sim3(J(src), J(dst), tol=1e-9)
        tr = registration.irls_sim3(T(src), T(dst), tol=1e-9)
        for a, b in zip(tr.transform, jr.transform):
            assert np.isfinite(a.numpy()).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        np.testing.assert_allclose(float(tr.rmse), float(jr.rmse), atol=1e-5)
        assert int(tr.n_effective) == int(jr.n_effective) == 398

    def test_irls_too_few_points_gives_identity(self):
        src, dst, conf = self.irls_case(n=120)
        conf[30:] = 0  # 30 weighted points < min_points 100
        jr = jreg.irls_sim3(J(src), J(dst), J(conf))
        tr = registration.irls_sim3(T(src), T(dst), T(conf))
        assert float(tr.transform.s) == 1.0 and float(tr.rmse) == 0.0 == float(jr.rmse)
        np.testing.assert_array_equal(tr.transform.R.numpy(), np.eye(3, dtype=np.float32))
        np.testing.assert_array_equal(tr.transform.t.numpy(), np.zeros(3, np.float32))
        assert int(tr.n_effective) == int(jr.n_effective) == 30


class TestAlignment:
    def test_chain_extrinsics(self):
        poses = make_trajectory(5).astype(np.float32)
        anchor = make_trajectory(3, seed=7)[2].astype(np.float32)
        for idx in (0, 3):
            np.testing.assert_allclose(
                alignment.chain_extrinsics(T(poses), T(anchor), idx).numpy(),
                np.asarray(jalign.chain_extrinsics(J(poses), J(anchor), idx)), atol=1e-5)

    @pytest.mark.parametrize("method,anchor_idx", [("icp", 0), ("icp", 2), ("umeyama", 0),
                                                   ("irls", 0), ("irls", 2)])
    def test_align_chunk_single_overlap(self, method, anchor_idx):
        poses = make_trajectory(9)
        prev_depth, prev_ext = local_chunk(poses, [0, 1, 2, 3])
        cur_idx = list(range(3 - anchor_idx, 8 - anchor_idx))
        cur_depth, cur_ext = local_chunk(poses, cur_idx, scale=1.3)
        conf = np.full((5, *HW), 1.5, np.float32)
        args = dict(
            prev_depth=prev_depth[-1], prev_conf=conf[0], prev_K=K,
            cur_depth=cur_depth, cur_conf=conf, cur_K=np.stack([K] * 5),
            cur_extrinsics=cur_ext, prev_overlap_global=prev_ext[-1],
        )
        cfg_j = jalign.AlignmentConfig(method=method, icp_max_iterations=25, irls_tol=1e-9)
        cfg_t = alignment.AlignmentConfig(method=method, icp_max_iterations=25, irls_tol=1e-9)
        jo = jalign.align_chunk_single_overlap(**{k: J(v) for k, v in args.items()},
                                               config=cfg_j, anchor_idx=anchor_idx)
        to = alignment.align_chunk_single_overlap(**{k: T(v) for k, v in args.items()},
                                                  config=cfg_t, anchor_idx=anchor_idx)
        np.testing.assert_allclose(float(to.depth_scale), float(jo.depth_scale), rtol=1e-6)
        np.testing.assert_allclose(float(to.depth_scale), 1 / 1.3, rtol=1e-4)
        for a, b in ((to.extrinsics_global, jo.extrinsics_global),
                     (to.prev_overlap_for_next, jo.prev_overlap_for_next),
                     (to.depth_scaled, jo.depth_scaled)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
        np.testing.assert_allclose(float(to.fitness), float(jo.fitness), atol=1e-3)
        np.testing.assert_allclose(float(to.inlier_rmse), float(jo.inlier_rmse), atol=1e-4)
        # the chain recovers the ground-truth global poses of the chunk
        np.testing.assert_allclose(to.extrinsics_global.numpy(),
                                   poses[cur_idx].astype(np.float32), atol=5e-3)

    def test_irls_not_ported_raises(self):
        """``irls`` is ported and runs; what still raises is a method that
        neither package knows."""
        poses = make_trajectory(4)
        d, e = local_chunk(poses, [0, 1, 2, 3])
        conf = np.ones_like(d)
        args = (T(d[-1]), T(conf[0]), T(K), T(d), T(conf), T(np.stack([K] * 4)), T(e), T(e[-1]))
        out = alignment.align_chunk_single_overlap(
            *args, config=alignment.AlignmentConfig(method="irls"))
        assert torch.isfinite(out.extrinsics_global).all() and float(out.fitness) == 1.0
        with pytest.raises(ValueError, match="unknown alignment method"):
            alignment.align_chunk_single_overlap(
                *args, config=alignment.AlignmentConfig(method="teaser"))

    def test_alignment_config_from_yaml_blocks(self):
        """``Align`` keys are the fields' names; the ``IRLS`` block fills the
        ``irls_*`` fields; ``Align`` wins; unknown keys are rejected."""
        from da3slam_tpu_torch.inout import load_config

        cfg = alignment.AlignmentConfig.from_config(load_config("configs/config1.yaml"))
        assert (cfg.method, cfg.irls_delta, cfg.irls_max_iters, cfg.irls_tol) == \
            ("icp", 0.1, 5, 1e-9)
        cfg = alignment.AlignmentConfig.from_config(
            {"Align": {"method": "irls", "irls_max_iters": 9}, "IRLS": {"max_iters": 3, "tol": 0.5}})
        assert (cfg.method, cfg.irls_max_iters, cfg.irls_tol) == ("irls", 9, 0.5)
        assert alignment.AlignmentConfig.from_config({}) == alignment.AlignmentConfig()
        with pytest.raises(TypeError):
            alignment.AlignmentConfig.from_config({"IRLS": {"huber": 1}})


def ate_rmse(c2w_est, c2w_gt):
    """RMS of the camera-center errors, unaligned: the ported
    ``evaluate_trajectory`` (held to the JAX one in test_torch_loop.py)."""
    from da3slam_tpu_torch.slam.evaluate import evaluate_trajectory

    return evaluate_trajectory(c2w_est, c2w_gt, align="none", device="cpu").ate_rmse


def gt_c2w(poses_w2c):
    out = []
    for E in poses_w2c:
        M = np.eye(4)
        M[:3] = E
        out.append(np.linalg.inv(M))
    return np.stack(out)


class TestSolver:
    CONFIG = {
        "Model": {"chunk_size": 5, "overlap_size": 1, "keyframe_interval": 1,
                  "sleep_between_chunk": 0, "port": 8080},
        "Align": {"icp_max_iterations": 25},
    }
    SCALES = [1.0, 1.4, 0.7, 1.2, 0.9]  # tests/test_slam.py's
    # powers of two: every rescale is exact in f32, so each overlap cloud is
    # bitwise the previous chunk's and ICP's fixed point is exactly the identity
    POW2_SCALES = [1.0, 2.0, 0.5, 1.0, 0.25]

    def run_both(self, tmp_path, chunk_scales, n_frames=14, device_resident=False):
        """14 frames in chunks of 5: [0, 5), [4, 9), [8, 13) and the
        re-anchored tail [9, 14), whose anchor sits at index 3."""
        poses = make_trajectory(n_frames)
        image_dir = make_synthetic_image_dir(tmp_path, n_frames)
        jsolver = JSolver(image_dir, self.CONFIG,
                          model=SyntheticDA3(poses, chunk_scales=chunk_scales), viewer=None)
        jsolver.run()
        cfg = {k: dict(v) for k, v in self.CONFIG.items()}
        cfg["Model"]["device_resident"] = device_resident
        tsolver = SLAMSolver(image_dir, cfg, model=SyntheticDA3(poses, chunk_scales=chunk_scales),
                             device="cpu")
        tsolver.run()
        return tsolver, jsolver.trajectory()[0], gt_c2w(poses)

    @pytest.mark.parametrize("chunk_scales,ate_bound,n_frames,dedup_skip", [
        (None, 5e-3, 14, [0, 1, 1, 4]), (POW2_SCALES, 1e-2, 14, [0, 1, 1, 4]),
        # fewer frames than one chunk: the tail runs as chunk 0
        (None, 5e-3, 3, [0])])
    def test_matches_jax_solver(self, tmp_path, chunk_scales, ate_bound, n_frames, dedup_skip):
        tsolver, c2w_jax, gt = self.run_both(tmp_path, chunk_scales, n_frames=n_frames)
        c2w, intrs = tsolver.trajectory()
        assert c2w.shape == (n_frames, 4, 4) and intrs.shape == (n_frames, 3, 3)
        assert [r["dedup_skip"] for r in tsolver.results] == dedup_skip
        np.testing.assert_allclose(c2w, c2w_jax, atol=1e-4)
        assert ate_rmse(c2w, gt) < ate_bound

    def test_inexact_chunk_scales(self, tmp_path, capsys):
        """Scales like 1.4 are inexact in f32: the rescaled overlap cloud
        differs from the previous chunk's by rounding, and ICP between two
        near-identical clouds wanders at that noise floor.  The test first
        pins that conditioning: one ulp more in one chunk scale moves the
        JAX package's own trajectory by more than 1e-4, so 1e-4 agreement
        between two f32 implementations that sum in different orders is
        below what the problem resolves.  The port is then held to the JAX
        package's per-chunk depth scales (as printed), to its trajectory at
        1e-3, and to the ground truth at tests/test_slam.py's ATE bound."""
        tsolver, c2w_jax, gt = self.run_both(tmp_path, self.SCALES)
        scales = [ln.split("depth_scale=")[1].split()[0]
                  for ln in capsys.readouterr().out.splitlines() if "depth_scale=" in ln]
        assert len(scales) == 6 and scales[:3] == scales[3:]  # JAX's 3 chunks, then the port's

        nudged = list(self.SCALES)
        nudged[2] = float(np.nextafter(np.float32(nudged[2]), np.float32(1.0)))
        jsolver = JSolver(tsolver.image_dir, self.CONFIG,
                          model=SyntheticDA3(make_trajectory(14), chunk_scales=nudged), viewer=None)
        jsolver.run()
        assert np.abs(jsolver.trajectory()[0] - c2w_jax).max() > 1e-4

        c2w, _ = tsolver.trajectory()
        np.testing.assert_allclose(c2w, c2w_jax, atol=1e-3)
        assert ate_rmse(c2w, gt) < 1e-2

    def test_device_resident_matches_host_path(self, tmp_path):
        tsolver, c2w_jax, gt = self.run_both(tmp_path, self.SCALES, device_resident=True)
        host = SLAMSolver(tsolver.image_dir, self.CONFIG,
                          model=SyntheticDA3(make_trajectory(14), chunk_scales=self.SCALES),
                          device="cpu")
        host.run()
        np.testing.assert_allclose(tsolver.trajectory()[0], host.trajectory()[0], atol=1e-6)
        assert all(isinstance(r["extrinsics_global"], np.ndarray) for r in tsolver.results)

    def test_device_resident_prints_and_exports_what_the_host_path_does(self, tmp_path, capsys):
        """The device-resident run defers every stat and pose to one packed
        fetch; what it prints and what ``trajectory()`` returns are the host
        path's, bit for bit (the same operations on the same tensors; the
        pack's f64 holds every f32 exactly)."""
        out = {}
        for resident in (False, True):
            cfg = {k: dict(v) for k, v in self.CONFIG.items()}
            cfg["Model"]["device_resident"] = resident
            solver = SLAMSolver(make_synthetic_image_dir(tmp_path / str(resident), 14), cfg,
                                model=SyntheticDA3(make_trajectory(14), chunk_scales=self.SCALES),
                                device="cpu")
            solver.run()
            stats = [ln for ln in capsys.readouterr().out.splitlines() if "depth_scale=" in ln]
            out[resident] = (stats, *solver.trajectory())
        assert len(out[True][0]) == 3 and out[True][0] == out[False][0]
        for a, b in zip(out[True][1:], out[False][1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)

    def test_materialize_is_one_packed_fetch(self, tmp_path, capsys, monkeypatch):
        """Device-resident without a loop closer: stats (f32 and f64 scalars),
        f64 poses and f32 intrinsics of three chunks leave the device in ONE
        ``.cpu()`` call and come back bit for bit in their own dtypes.  With
        a loop closer the poses were fetched a chunk: they stay, and the
        intrinsics come back in one call.  The host path fetches nothing."""
        def solver(resident, loop=False):
            cfg = {k: dict(v) for k, v in self.CONFIG.items()}
            cfg["Model"]["device_resident"] = resident
            if loop:
                cfg["Loop"] = {"enable": True}
            return SLAMSolver(str(tmp_path), cfg, model=SyntheticDA3(make_trajectory(3)),
                              viewer=None, device="cpu")

        rng = np.random.default_rng(0)
        ext = [torch.from_numpy(rng.normal(size=(5, 3, 4))) for _ in range(3)]  # f64
        intr = [torch.from_numpy(rng.normal(size=(5, 3, 3)).astype(np.float32)) for _ in range(3)]
        calls = []
        fetch = torch.Tensor.cpu
        monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: (calls.append(1),
                                                                    fetch(t, *a, **k))[1])
        deferred = solver(True)
        deferred.results = [{"extrinsics_global": e, "intrinsics": k} for e, k in zip(ext, intr)]
        deferred._deferred_stats = [
            ("chunk 1", torch.tensor(1.23456789), torch.tensor(0.5, dtype=torch.float64),
             torch.tensor(1e-3)),
            ("tail chunk (2 new frames)", torch.tensor(0.987654321), torch.tensor(1.0),
             torch.tensor(2.5e-4)),
        ]
        deferred._materialize()
        assert len(calls) == 1 and not deferred._deferred_stats
        assert capsys.readouterr().out.splitlines() == [
            "  chunk 1: depth_scale=1.2346 fitness=0.5000 inlier_rmse=0.00100",
            "  tail chunk (2 new frames): depth_scale=0.9877 fitness=1.0000 inlier_rmse=0.00025"]
        for r, e, k in zip(deferred.results, ext, intr):
            assert r["extrinsics_global"].dtype == np.float64
            assert r["intrinsics"].dtype == np.float32
            assert np.array_equal(r["extrinsics_global"], e.numpy())
            assert np.array_equal(r["intrinsics"], k.numpy())

        looped = solver(True, loop=True)
        poses = [e.numpy() for e in ext]
        looped.results = [{"extrinsics_global": e, "intrinsics": k} for e, k in zip(poses, intr)]
        looped._materialize()
        assert len(calls) == 2 and capsys.readouterr().out == ""
        for r, e, k in zip(looped.results, poses, intr):
            assert r["extrinsics_global"] is e
            assert r["intrinsics"].dtype == np.float32 and np.array_equal(r["intrinsics"], k.numpy())

        host = solver(False)
        host.results = [dict(r) for r in looped.results]
        host._materialize()  # nothing on the device: no fetch, no output
        assert len(calls) == 2 and capsys.readouterr().out == ""
        assert all(r["intrinsics"] is k["intrinsics"] for r, k in zip(host.results, looped.results))

    def test_rejects_what_is_not_ported(self, tmp_path, capsys, monkeypatch):
        """Nothing is refused now.  ``viewer="auto"`` (the default) runs
        headless with the JAX package's message where viser is missing
        (test_torch_viewer.py drives the viewer itself), and a Loop block
        builds the closer on the solver's device (test_torch_loop.py runs it)."""
        model = SyntheticDA3(make_trajectory(3))
        monkeypatch.setitem(sys.modules, "viser", None)  # an import of viser fails
        for viewer in ("auto", None):
            solver = SLAMSolver(str(tmp_path), self.CONFIG, model=model, viewer=viewer,
                                device="cpu")
            assert solver.viewer is None
        out = capsys.readouterr().out.splitlines()
        assert [ln for ln in out if "Viewer" in ln] == [
            "Viewer unavailable (import of viser halted; None in sys.modules); running headless"]
        solver = SLAMSolver(str(tmp_path), {**self.CONFIG, "Loop": {"enable": True}}, model=model,
                            device="cpu")
        assert solver.loop_closer is not None and solver.loop_closer.device.type == "cpu"


class TestHostIO:
    def test_paths_config_and_trajectory_files_match_jax(self, tmp_path):
        from da3slam_tpu.inout import (
            extract_keyframes as j_kf,
            load_config as j_cfg,
            load_image_paths as j_paths,
            save_camera_poses as j_save,
        )
        from da3slam_tpu_torch.inout import (
            extract_keyframes,
            load_config,
            load_image_paths,
            save_camera_poses,
        )

        d = Path(make_synthetic_image_dir(tmp_path, 12))
        (d / "frame_100.png").touch()
        assert load_image_paths(d) == j_paths(d)
        assert extract_keyframes(load_image_paths(d), 3) == j_kf(j_paths(d), 3)
        assert load_config("configs/config1.yaml") == j_cfg("configs/config1.yaml")

        c2w = gt_c2w(make_trajectory(4))
        intr = np.stack([K] * 4)
        for save, out in ((save_camera_poses, tmp_path / "t"), (j_save, tmp_path / "j")):
            save(out, c2w, intr, chunk_indices=np.array([0, 0, 1, 1]))
        for name in ("camera_poses.txt", "intrinsic.txt", "camera_poses.ply"):
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()

    def test_load_images_matches_jax(self, tmp_path):
        from PIL import Image

        from da3slam_tpu.inout.images import load_images as j_load
        from da3slam_tpu_torch.inout import load_image_paths, load_images

        frames = make_frames(3)
        for i, f in enumerate(frames):
            Image.fromarray(f).save(tmp_path / f"{i:06d}.png")
        Image.fromarray(frames[0][..., 0]).save(tmp_path / "000003.png")  # grey → RGB
        paths = load_image_paths(tmp_path)
        got = load_images(paths)
        assert got.dtype == np.uint8 and got.shape == (4, 56, 70, 3)
        np.testing.assert_array_equal(got, j_load(paths))
        np.testing.assert_array_equal(got[:3], frames)

    def test_prefetcher_returns_decoded_frames(self, tmp_path):
        from PIL import Image

        from da3slam_tpu_torch.inout.images import decode_image
        from da3slam_tpu_torch.inout.prefetch import ImagePrefetcher

        rng = np.random.default_rng(0)
        paths = []
        for i in range(9):
            p = tmp_path / f"{i:03d}.png"
            Image.fromarray(rng.integers(0, 256, size=(8, 10, 3)).astype(np.uint8)).save(p)
            paths.append(str(p))
        pf = ImagePrefetcher(paths, lookahead=4, workers=2)
        try:
            for chunk in (paths[0:4], paths[3:7], paths[5:9], paths[0:2]):
                got = pf.get_batch(chunk)
                np.testing.assert_array_equal(got, np.stack([decode_image(p) for p in chunk]))
        finally:
            pf.close()
        assert not any(t.is_alive() for t in pf._threads)

    @pytest.mark.parametrize("binary", [True, False])
    @pytest.mark.parametrize("colors", ["uint8", "float01", "float255", None])
    def test_write_ply_matches_jax_byte_for_byte(self, tmp_path, binary, colors):
        from da3slam_tpu.inout import write_ply as j_write
        from da3slam_tpu_torch.inout import write_ply

        rng = np.random.default_rng(3)
        pts = rng.normal(size=(37, 3))
        cols = {"uint8": rng.integers(0, 256, size=(37, 3)).astype(np.uint8),
                "float01": rng.uniform(0, 1, size=(37, 3)),
                "float255": rng.uniform(0, 300, size=(37, 3)), None: None}[colors]
        write_ply(tmp_path / "t" / "c.ply", pts, cols, binary=binary)
        j_write(tmp_path / "j" / "c.ply", pts, cols, binary=binary)
        assert (tmp_path / "t" / "c.ply").read_bytes() == (tmp_path / "j" / "c.ply").read_bytes()

    def test_stage_next_on_cpu(self, tmp_path):
        """Staging on the CPU: the partition's chunks come back as stacked
        arrays, in order; at most ``stage_ahead`` are held; ``stage_next``
        says False once the partition is exhausted or staging is off; a chunk
        outside the partition is decoded as before."""
        from PIL import Image

        from da3slam_tpu_torch.inout.images import decode_image
        from da3slam_tpu_torch.inout.prefetch import ImagePrefetcher

        rng = np.random.default_rng(0)
        paths = []
        for i in range(10):
            p = tmp_path / f"{i:03d}.png"
            Image.fromarray(rng.integers(0, 256, size=(8, 10, 3)).astype(np.uint8)).save(p)
            paths.append(str(p))
        stage = [paths[a:b] for a, b in make_chunk_indices(10, 4, 1)]  # [0,4) [3,7) [6,10)
        pf = ImagePrefetcher(paths, lookahead=8, workers=2, stage_chunks=stage, stage_ahead=2)
        try:
            first = pf.get_batch(stage[0])  # not staged ahead: stacked on demand
            assert isinstance(first, np.ndarray) and pf._stage_pos == 1
            assert pf.stage_next() and pf.stage_next()  # chunks 1 and 2
            assert not pf.stage_next() and len(pf._staged) == 2  # stage_ahead reached
            for chunk in stage[1:]:
                got = pf.get_batch(chunk)
                np.testing.assert_array_equal(got, np.stack([decode_image(p) for p in chunk]))
            np.testing.assert_array_equal(first, np.stack([decode_image(p) for p in stage[0]]))
            assert not pf.stage_next() and not pf._staged  # partition exhausted
            np.testing.assert_array_equal(pf.get_batch(paths[1:3]),
                                          np.stack([decode_image(p) for p in paths[1:3]]))
        finally:
            pf.close()
        off = ImagePrefetcher(paths, workers=1)
        try:
            assert not off.stage_next()
        finally:
            off.close()


def make_frames(n=11, h=56, w=70, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, size=(h, w, 3))
    frames = [np.roll(base, shift=i * 2, axis=1) + rng.integers(0, 20, size=(h, w, 3))
              for i in range(n)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


class TestWholeSlice:
    def test_both_clis_agree(self, tmp_path, monkeypatch):
        """main_slam of both packages over one PNG directory with the same
        tiny weights: 11 frames in chunks of 4 (two steady chunks after the
        first and a re-anchored tail), closed-form Umeyama alignment (ICP on
        random-init depth is chaotic), process_res 70 (no resampling)."""
        from PIL import Image

        from da3slam_tpu.cli import main_slam as j_main
        from da3slam_tpu_torch.cli import main_slam as t_main

        frames_dir = tmp_path / "frames"
        frames_dir.mkdir()
        for i, f in enumerate(make_frames()):
            Image.fromarray(f).save(frames_dir / f"{i:06d}.png")
        cfg = tmp_path / "slam.yaml"
        cfg.write_text("Weights: {DA3: tiny}\n"
                       "Model: {chunk_size: 4, overlap_size: 1, keyframe_interval: 1}\n"
                       "Align: {method: umeyama}\n")

        jparams = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jget_preset("tiny")))
        net = DA3Net(get_preset("tiny"))
        net.load_state_dict(convert(jparams), strict=True)
        monkeypatch.setattr(TDA3, "from_pretrained", classmethod(
            lambda cls, preset, seed=0, device="cuda": cls(get_preset("tiny"), net.to(device))))
        for cls in (JDA3, TDA3):
            orig = cls.inference
            monkeypatch.setattr(cls, "inference", functools.partialmethod(orig, process_res=70))

        common = ["--image_dir", str(frames_dir), "--config", str(cfg), "--headless"]
        j_main.main(common + ["--output_dir", str(tmp_path / "jax")])
        t_main.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
        jp = np.loadtxt(tmp_path / "jax" / "camera_poses.txt")
        tp = np.loadtxt(tmp_path / "port" / "camera_poses.txt")
        assert tp.shape == (11, 16) and np.isfinite(tp).all()
        np.testing.assert_allclose(tp, jp, atol=1e-4)
        np.testing.assert_allclose(np.loadtxt(tmp_path / "port" / "intrinsic.txt"),
                                   np.loadtxt(tmp_path / "jax" / "intrinsic.txt"), atol=1e-3)

    @pytest.mark.parametrize("method", ["icp", "irls", "umeyama"])
    def test_main_align_matches_jax_cli(self, tmp_path, monkeypatch, capsys, method):
        """main_align of both packages over one PNG directory with the same
        tiny weights and ray poses: 9 frames in chunks of 4 (one steady chunk
        and the re-anchored tail).  The printed depth scale, fitness and rmse
        per chunk agree to 1e-3 (the chunk scales are inexact in f32: the
        ICP note in the module docstring), the fused clouds to 1e-3.  ICP's
        fitness is a count over the ~320 strided source points: on the
        random-weight model's rough depth a point within rounding of the 0.1
        gate falls on either side, each moving fitness by 3e-3, so it is held
        to 2e-2."""
        from PIL import Image

        from da3slam_tpu.cli import main_align as j_main
        from da3slam_tpu.inout.ply import read_ply
        from da3slam_tpu_torch.cli import main_align as t_main

        frames_dir = tmp_path / "frames"
        frames_dir.mkdir()
        for i, f in enumerate(make_frames(9)):
            Image.fromarray(f).save(frames_dir / f"{i:06d}.png")
        jparams = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jget_preset("tiny")))
        net = DA3Net(get_preset("tiny"))
        net.load_state_dict(convert(jparams), strict=True)
        monkeypatch.setattr(TDA3, "from_pretrained", classmethod(
            lambda cls, preset, seed=0, device="cuda": cls(get_preset("tiny"), net.to(device))))

        common = ["--image_dir", str(frames_dir), "--model", "tiny", "--method", method,
                  "--process_res", "70", "--headless"]
        j_main.main(common + ["--output_ply", str(tmp_path / "jax.ply")])
        j_out = capsys.readouterr().out
        t_main.main(common + ["--output_ply", str(tmp_path / "port.ply"), "--device", "cpu"])
        t_out = capsys.readouterr().out

        def stats(text):
            rows = [ln.replace("=", " ").split() for ln in text.splitlines()
                    if ln.startswith("chunk ")]
            return np.array([[float(r[3]), float(r[5]), float(r[7])] for r in rows])

        assert stats(t_out).shape == (2, 3) and np.isfinite(stats(t_out)).all()
        np.testing.assert_allclose(stats(t_out)[:, [0, 2]], stats(j_out)[:, [0, 2]], atol=1e-3)
        np.testing.assert_allclose(stats(t_out)[:, 1], stats(j_out)[:, 1],
                                   atol=2e-2 if method == "icp" else 1e-3)
        (tp, tc), (jp, jc) = read_ply(tmp_path / "port.ply"), read_ply(tmp_path / "jax.ply")
        assert tp.shape == jp.shape and len(tp) > 0
        np.testing.assert_allclose(tp, jp, atol=1e-3)
        np.testing.assert_array_equal(tc, jc)

    def test_main_align_refuses_what_is_not_ported(self, tmp_path):
        """Nothing is refused now: without --headless the run reaches the
        same checks (the viewer opens after them, test_torch_viewer.py)."""
        from da3slam_tpu_torch.cli import main_align

        base = ["--image_dir", str(tmp_path), "--device", "cpu"]
        with pytest.raises(SystemExit, match="no images"):
            main_align.main(base + ["--model", "tiny"])
        with pytest.raises(SystemExit, match="no images"):
            main_align.main(base + ["--headless", "--model", "tiny"])
        # --debug_color is ported (tests/test_torch_conf_eval.py holds its
        # colours to the JAX CLI's): the flag now reaches the same check
        with pytest.raises(SystemExit, match="no images"):
            main_align.main(base + ["--headless", "--model", "tiny", "--debug_color"])

    def test_cli_refuses_missing_cuda_and_viewer(self, tmp_path, capsys, monkeypatch):
        """Without --headless the CLI asks for the viewer and, where viser is
        missing, runs headless as the JAX CLI does; without CUDA it refuses."""
        from da3slam_tpu_torch.cli import main_slam

        monkeypatch.setitem(sys.modules, "viser", None)
        cfg = tmp_path / "tiny.yaml"
        cfg.write_text("Weights: {DA3: tiny}\nModel: {chunk_size: 4}\n")
        frames = tmp_path / "empty"
        frames.mkdir()
        solver = main_slam.main(["--image_dir", str(frames), "--config", str(cfg),
                                 "--device", "cpu"])
        assert solver.viewer is None
        assert "running headless" in capsys.readouterr().out
        if torch.cuda.is_available():
            return
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main_slam.main(["--image_dir", str(tmp_path), "--headless"])


def _load_precision_helpers():
    """``tests/test_precision.py``'s world (rotation-walk trajectory, per-chunk
    local frames, the f64 NumPy chain), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_test_precision", Path(__file__).with_name("test_precision.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestLongChainDrift:
    """``tests/test_precision.py``'s 520-chunk chain (3641 frames) through the
    port's ``chain_extrinsics`` and ``orthonormalize_rotation``, with the same
    limits: the f32 carry, projected onto SO(3) each chunk, stays within
    5e-6 of orthonormal and within 1 mm RMS of the f64 chain."""

    @staticmethod
    def torch_chain(chunks, first_global, reortho):
        from da3slam_tpu_torch.core.transforms import orthonormalize_rotation

        carry = T(first_global)
        out, worst_ortho = [], 0.0
        for k, E_local in enumerate(chunks):
            Eg = alignment.chain_extrinsics(T(E_local), carry, 0)
            if reortho:
                Eg = torch.cat([orthonormalize_rotation(Eg[..., :3]), Eg[..., 3:]], dim=-1)
            carry = Eg[-1]
            R = carry[..., :3].double().numpy()
            worst_ortho = max(worst_ortho, float(np.abs(R.T @ R - np.eye(3)).max()))
            E_np = Eg.double().numpy()
            out.append(E_np[1:] if k else E_np)
        return np.concatenate(out), worst_ortho

    def test_f32_carry_drift_vs_f64(self):
        tp = _load_precision_helpers()
        step = tp.FRAMES_PER_CHUNK - 1
        gt = tp._rotation_walk_trajectory(tp.N_CHUNKS * step + 1)
        chunks = tp._chunk_locals(gt, step, tp.FRAMES_PER_CHUNK)
        assert len(chunks) == 520
        first = chunks[0][0]
        ref = tp._np_chain(chunks, first)
        raw, raw_ortho = self.torch_chain(chunks, first, reortho=False)
        fix, fix_ortho = self.torch_chain(chunks, first, reortho=True)
        assert len(fix) == len(ref) == len(gt)
        p_ref = tp._positions(ref)
        ate_raw = float(np.sqrt(((tp._positions(raw) - p_ref) ** 2).sum(-1).mean()))
        ate_fix = float(np.sqrt(((tp._positions(fix) - p_ref) ** 2).sum(-1).mean()))
        print(f"\n520-chunk f32 drift vs f64 (port): raw ATE {ate_raw:.2e} "
              f"(orthonormality {raw_ortho:.2e}) | reortho ATE {ate_fix:.2e} ({fix_ortho:.2e})")
        assert fix_ortho < 5e-6
        assert ate_fix < 1e-3
        assert ate_fix < ate_raw * 1.5 + 1e-6

    @pytest.mark.parametrize("method", ["icp", "irls"])
    def test_aligner_projects_anchor(self, method):
        """The port's aligner re-orthonormalises the carry: a previous pose
        pushed ~1e-3 off SO(3) comes back on it (``tests/test_precision.py``'s
        inputs and its 1e-5)."""
        H = W = 32
        n = 4
        rng = np.random.default_rng(0)
        K_ = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
        depth = 2.0 + rng.random((H, W)).astype(np.float32) * 0.1
        cur_E = np.stack([np.concatenate([np.eye(3), np.zeros((3, 1))], 1)] * n)
        R_bad = np.eye(3, dtype=np.float32) + rng.normal(scale=1e-3, size=(3, 3)).astype(np.float32)
        prev_global = np.concatenate([R_bad, np.zeros((3, 1), np.float32)], 1)
        out = alignment.align_chunk_single_overlap(
            prev_depth=T(depth), prev_conf=torch.ones(H, W), prev_K=T(K_),
            cur_depth=T(np.stack([depth] * n)), cur_conf=torch.ones(n, H, W),
            cur_K=T(np.stack([K_] * n)), cur_extrinsics=T(cur_E),
            prev_overlap_global=T(prev_global),
            config=alignment.AlignmentConfig(method=method))
        R = out.extrinsics_global[0, :, :3].double().numpy()
        assert np.abs(R_bad.T @ R_bad - np.eye(3)).max() > 1e-4
        assert np.abs(R.T @ R - np.eye(3)).max() < 1e-5
