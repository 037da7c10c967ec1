"""The port's two-pass streaming path (``slam/streaming.py``, ``cli/streaming.py``),
its host I/O copies and the ``inference`` export against ``da3slam_tpu``.

Both packages run on the same numpy inputs: the synthetic out-and-back loop
(``utils/synthetic.py``, a closed-form corner room) or the tiny preset with
the JAX package's seed-0 weights carried over by ``convert``.  f32 on the
CPU.  Tolerances: trajectories and point clouds of the synthetic loop to
1e-4 of the scene extent (measured 8e-6 and 2e-5: IRLS and the pose graph in
two libraries); the host I/O copies byte for byte; the model path to 1e-3
(random-weight depth through IRLS, as ``test_torch_slam.py``'s main_align
comparison)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from da3slam_tpu.inout import ply as jply
from da3slam_tpu.inout import trajectory as jtraj
from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import DepthAnything3 as JDA3
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.slam.streaming import DA3Streaming as JStreaming
from da3slam_tpu.utils import synthetic as jsyn
from da3slam_tpu.inout.mesh import read_mesh_ply as jread_mesh_ply
from da3slam_tpu_torch.inout import ply, trajectory
from da3slam_tpu_torch.inout.mesh import read_mesh_ply
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net, DepthAnything3
from da3slam_tpu_torch.slam.evaluate import evaluate_trajectory
from da3slam_tpu_torch.slam.streaming import DA3Streaming
from da3slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

N_FRAMES = 48
HW = (48, 64)


def loop_model(pkg):
    """A fresh model a run (its call count drives the per-chunk scales)."""
    rng = np.random.default_rng(3)
    poses = pkg.make_loop_trajectory(N_FRAMES)
    return pkg.SyntheticDA3(poses, hw=HW, chunk_scales=rng.uniform(0.5, 2.0, size=24),
                            depth_noise=6e-3, textured=True, seed=7)


def loop_config(enable: bool, **model) -> dict:
    """tests/test_loop_integration.py's configuration, with every export on."""
    return {
        "Model": {"chunk_size": 6, "overlap": 2, "delete_temp_files": False,
                  "traj_formats": ["tum", "kitti"], "save_debug_info": True, **model},
        "IRLS": {"delta": 0.1, "max_iters": 5},
        "Pointcloud_Save": {"conf_threshold_coef": 0.9, "sample_ratio": 0.5},
        "Loop": {
            "enable": enable,
            "Retrieval": {"threshold": 0.9, "min_gap": 25, "max_loops": 5},
            "Gate": {"max_rmse": 0.08, "min_n_effective": 200, "max_reciprocal_err": 0.15},
            "SIM3_Optimizer": {"max_iterations": 30, "lambda_init": 1e-6},
        },
    }


def gt_c2w(poses_w2c):
    return np.stack([np.linalg.inv(np.vstack([E, [0, 0, 0, 1]])) for E in poses_w2c])


TRAJECTORY_FILES = ("camera_poses.txt", "camera_poses_tum.txt", "camera_poses_kitti.txt")


class TestStreamingMatchesJax:
    def test_loop_on_and_off(self, tmp_path):
        """The out-and-back loop through both packages, closure off and on:
        the same accepted loop edges; the trajectory files (reference, TUM,
        KITTI), intrinsic.txt, the debug npz and the merged cloud agree; the
        closure lowers ATE; every frame is covered by a chunk."""
        image_dir = jsyn.make_synthetic_image_dir(tmp_path, N_FRAMES)
        gt = gt_c2w(jsyn.make_loop_trajectory(N_FRAMES))
        extent = np.abs(gt[:, :3, 3]).max()
        ate = {}
        for enable in (False, True):
            out, ref = tmp_path / f"port_{enable}", tmp_path / f"jax_{enable}"
            j = JStreaming(image_dir, str(ref), loop_config(enable), model=loop_model(jsyn))
            j.run()
            t = DA3Streaming(image_dir, str(out), loop_config(enable), model=loop_model(tsyn),
                             device="cpu")
            t.run()
            assert [(a, b) for a, b, _ in t.loop_edges] == [(a, b) for a, b, _ in j.loop_edges]
            assert bool(t.loop_edges) == enable and t.n_pose_filled == 0
            for name in TRAJECTORY_FILES:
                a, b = np.loadtxt(out / name), np.loadtxt(ref / name)
                assert a.shape == b.shape and a.shape[0] == N_FRAMES
                np.testing.assert_allclose(a, b, atol=1e-4 * extent)
            assert (out / "intrinsic.txt").read_bytes() == (ref / "intrinsic.txt").read_bytes()
            centers = [np.loadtxt(d / "camera_poses.ply", skiprows=10) for d in (out, ref)]
            np.testing.assert_allclose(*centers, atol=1e-4 * extent)
            za, zb = np.load(out / "sim3_debug.npz"), np.load(ref / "sim3_debug.npz")
            assert za.files == zb.files
            for key in za.files:
                assert za[key].dtype == zb[key].dtype and za[key].shape == zb[key].shape
                np.testing.assert_allclose(za[key], zb[key], atol=1e-4 * extent)
            (tp, tc), (jp, jc) = (ply.read_ply(d / "combined_pcd.ply") for d in (out, ref))
            assert tp.shape == jp.shape and len(tp) > 1000
            np.testing.assert_array_equal(tc, jc)  # the same sampled pixels
            np.testing.assert_allclose(tp, jp, atol=1e-4 * np.abs(jp).max())
            ate[enable] = evaluate_trajectory(trajectory.load_camera_poses(out / "camera_poses.txt"),
                                              gt, device="cpu").ate_rmse
        assert ate[True] < ate[False]

    def test_reanchored_tail_aligns_correct_frames(self, tmp_path):
        """tests/test_streaming.py's 13 frames in chunks of 5, overlap 2: the
        tail chunk (8, 13) shares 3 frames with (6, 11), and the pairing must
        use the actual overlap."""
        poses = jsyn.make_trajectory(13)
        cfg = {"Model": {"chunk_size": 5, "overlap": 2, "process_res": 64},
               "Pointcloud_Save": {"conf_threshold_coef": 0.5, "sample_ratio": 0.5}}
        image_dir = jsyn.make_synthetic_image_dir(tmp_path, 13)
        scales = [1.0, 1.2, 0.9, 1.1]
        t = DA3Streaming(image_dir, str(tmp_path / "t"), cfg,
                         model=tsyn.SyntheticDA3(poses, chunk_scales=scales), device="cpu")
        t.run()
        j = JStreaming(image_dir, str(tmp_path / "j"), cfg,
                       model=jsyn.SyntheticDA3(poses, chunk_scales=scales))
        j.run()
        c2w = trajectory.load_camera_poses(tmp_path / "t" / "camera_poses.txt")
        np.testing.assert_allclose(c2w, jtraj.load_camera_poses(tmp_path / "j" / "camera_poses.txt"),
                                   atol=1e-4)
        assert evaluate_trajectory(c2w, gt_c2w(poses), align="none", device="cpu").ate_rmse < 0.05
        t.close()
        assert not (tmp_path / "t" / "_tmp_results_unaligned").exists()


class TestStreamingMeshExport:
    """``export_mesh``: tests/test_streaming.py's mesh cases on the port, held
    to the JAX package's scene_mesh.ply (9 frames of the corner room in chunks
    of 4, overlap 2, chunk scales 1.4 / 0.8 / 1.1)."""

    SCALES = [1.4, 0.8, 1.1]

    def config(self, sparse: bool) -> dict:
        return {"Model": {"chunk_size": 4, "overlap": 2, "process_res": 64,
                          "export_mesh": True, "mesh_resolution": 64, "mesh_sparse": sparse}}

    def run_both(self, tmp_path, sparse: bool, budget=None):
        poses = jsyn.make_trajectory(9)
        image_dir = jsyn.make_synthetic_image_dir(tmp_path, 9)
        runs = []
        for name, cls, pkg, kw in (("t", DA3Streaming, tsyn, {"device": "cpu"}),
                                   ("j", JStreaming, jsyn, {})):
            s = cls(image_dir, str(tmp_path / name), self.config(sparse),
                    model=pkg.SyntheticDA3(poses, chunk_scales=self.SCALES), **kw)
            s._mesh_block_budget = budget
            s.run()
            runs.append(s)
        return runs

    @pytest.mark.parametrize("mesh_sparse", [True, False])
    def test_mesh_lands_on_room_planes(self, tmp_path, mesh_sparse):
        """scene_mesh.ply beside combined_pcd.ply, on the chunk-0-scaled room
        planes; the JAX package's mesh has the vertex count within 2% and
        the same budget."""
        t, j = self.run_both(tmp_path, mesh_sparse)
        verts, faces, cols = read_mesh_ply(tmp_path / "t" / "scene_mesh.ply", with_colors=True)
        jverts = jread_mesh_ply(tmp_path / "j" / "scene_mesh.ply")[0]
        assert len(verts) > 200 and len(faces) > 200 and cols is not None
        assert abs(len(verts) - len(jverts)) <= 0.02 * len(jverts)
        assert t._mesh_block_budget == j._mesh_block_budget
        assert (t._mesh_block_budget is None) != mesh_sparse
        s0 = self.SCALES[0]
        dists = np.min(np.stack([np.abs(verts @ np.asarray(n) - c * s0) for n, c in tsyn.PLANES]),
                       axis=0)
        assert np.quantile(dists, 0.9) < 0.2 * s0
        t.close()

    def test_sparse_budget_reuse_and_overflow_refuse(self, tmp_path, capsys):
        """A pre-set budget of 128 blocks, below what a chunk needs: the
        chunk is found over budget, re-fused exactly from the grid before it,
        and the budget raised, as in the JAX package; the mesh still lies on
        the planes."""
        t, j = self.run_both(tmp_path, True, budget=128)
        assert "re-fusing with auto-sized budget" in capsys.readouterr().out
        assert t._mesh_block_budget == j._mesh_block_budget > 128
        verts = read_mesh_ply(tmp_path / "t" / "scene_mesh.ply")[0]
        jverts = jread_mesh_ply(tmp_path / "j" / "scene_mesh.ply")[0]
        assert abs(len(verts) - len(jverts)) <= 0.02 * len(jverts)
        s0 = self.SCALES[0]
        dists = np.min(np.stack([np.abs(verts @ np.asarray(n) - c * s0) for n, c in tsyn.PLANES]),
                       axis=0)
        assert np.quantile(dists, 0.9) < 0.2 * s0


class CountingModel:
    """``tsyn.SyntheticDA3`` that counts its calls."""

    def __init__(self, poses):
        self.inner = tsyn.SyntheticDA3(poses, chunk_scales=[1.0, 1.3, 0.8, 1.1])
        self.calls = 0

    def inference(self, image, **kw):
        self.calls += 1
        return self.inner.inference(image, **kw)


class TestStreamingBehaviour:
    CONFIG = {"Model": {"chunk_size": 4, "overlap": 1, "delete_temp_files": False}}

    def test_resume_over_existing_spills(self, tmp_path):
        """A second run with ``resume`` reads every chunk from its spill (the
        model is not called) and writes the same trajectory."""
        poses = jsyn.make_trajectory(10)
        image_dir = jsyn.make_synthetic_image_dir(tmp_path, 10)
        first = CountingModel(poses)
        DA3Streaming(image_dir, str(tmp_path / "o"), self.CONFIG, model=first, device="cpu").run()
        before = (tmp_path / "o" / "camera_poses.txt").read_bytes()
        (tmp_path / "o" / "camera_poses.txt").unlink()
        again = CountingModel(poses)
        cfg = {"Model": {**self.CONFIG["Model"], "resume": True}}
        s = DA3Streaming(image_dir, str(tmp_path / "o"), cfg, model=again, device="cpu")
        s.run()
        assert first.calls == len(s.chunk_ranges) == 3 and again.calls == 0
        assert (tmp_path / "o" / "camera_poses.txt").read_bytes() == before

    def test_empty_dir_raises(self, tmp_path):
        (tmp_path / "none").mkdir()
        s = DA3Streaming(str(tmp_path / "none"), str(tmp_path / "o"), self.CONFIG,
                         model=CountingModel(jsyn.make_trajectory(3)), device="cpu")
        with pytest.raises(ValueError, match="DIR EMPTY"):
            s.run()

    def test_export_mesh_and_bad_formats_refused_at_construction(self, tmp_path):
        """``export_mesh`` is accepted now and writes scene_mesh.ply beside the
        merged cloud; an unknown trajectory format is still refused before
        the run."""
        poses = jsyn.make_trajectory(9)
        model = CountingModel(poses)
        cfg = {"Model": {**self.CONFIG["Model"], "export_mesh": True, "mesh_resolution": 48}}
        s = DA3Streaming(jsyn.make_synthetic_image_dir(tmp_path, 9), str(tmp_path / "o"), cfg,
                         model=model, device="cpu")
        assert s.export_mesh and s.mesh_sparse and not s.mesh_carve
        s.run()
        verts, faces = read_mesh_ply(tmp_path / "o" / "scene_mesh.ply")
        assert len(verts) > 100 and len(faces) > 100 and np.isfinite(verts).all()
        cfg = {"Model": {**self.CONFIG["Model"], "traj_formats": ["tum", "euroc"]}}
        with pytest.raises(ValueError, match="euroc"):
            DA3Streaming(str(tmp_path), str(tmp_path / "o"), cfg, model=model, device="cpu")

    def test_save_depth_conf_result_and_debug_info(self, tmp_path):
        poses = jsyn.make_trajectory(8)
        cfg = {"Model": {**self.CONFIG["Model"], "save_depth_conf_result": True,
                         "save_debug_info": True}}
        s = DA3Streaming(jsyn.make_synthetic_image_dir(tmp_path, 8), str(tmp_path / "o"), cfg,
                         model=CountingModel(poses), device="cpu")
        s.run()
        frames = sorted((tmp_path / "o" / "frames").glob("frame_*.npz"))
        assert len(frames) == 8
        assert set(np.load(frames[0]).keys()) == {"image", "depth", "conf", "intrinsics"}
        z = np.load(tmp_path / "o" / "sim3_debug.npz")
        assert z["relative_s"].shape == (len(s.chunk_ranges) - 1,)
        assert z["accumulated_R"].shape == (len(s.chunk_ranges), 3, 3)
        assert int(z["n_loop_edges"]) == 0

    @pytest.mark.parametrize("first_kind", ["thumbnail", "learned"])
    def test_feed_detector_keeps_one_kind(self, first_kind):
        """tests/test_streaming.py's resume cases: spills without
        descriptors then chunks with them stay on thumbnails; learned
        descriptors then chunks without them enroll zero placeholders that
        never pair up."""
        from da3slam_tpu_torch.slam.loop import LoopDetector

        s = DA3Streaming.__new__(DA3Streaming)
        s.loop_detector = LoopDetector(threshold=0.5, min_gap=2, device="cpu")
        s.chunk_size, s.overlap = 3, 1
        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 255, (3, 16, 16, 3), dtype=np.uint8)
        desc = {"images": imgs, "frame_desc": rng.normal(size=(3, 8)).astype(np.float32)}
        plain = {"images": imgs}
        first, later = (plain, desc) if first_kind == "thumbnail" else (desc, plain)
        s._feed_loop_detector(first)
        for _ in range(4):
            s._feed_loop_detector(later)
        assert s.loop_detector.kind == first_kind and len(s.loop_detector._descs) == 10
        if first_kind == "learned":
            assert all(p.frame_a < 3 and p.frame_b < 3 for p in s.loop_detector.detect())


def make_frames(n=10, h=56, w=70, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, size=(h, w, 3))
    frames = [np.roll(base, shift=i * 2, axis=1) + rng.integers(0, 20, size=(h, w, 3))
              for i in range(n)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tiny_weights():
    jparams = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jget_preset("tiny")))
    net = DA3Net(get_preset("tiny"))
    net.load_state_dict(convert(jparams), strict=True)
    return jparams, net.eval()


class TestCli:
    def test_both_clis_agree(self, tmp_path, monkeypatch, tiny_weights):
        """``cli/streaming`` of both packages over one PNG directory with the
        same tiny weights: 10 frames in chunks of 4, overlap 2, process_res
        70, the TUM and KITTI exports, the port with ``--device cpu``."""
        from PIL import Image

        from da3slam_tpu.cli import streaming as j_main
        from da3slam_tpu_torch.cli import streaming as t_main

        frames_dir = tmp_path / "frames"
        frames_dir.mkdir()
        for i, f in enumerate(make_frames()):
            Image.fromarray(f).save(frames_dir / f"{i:06d}.png")
        cfg = tmp_path / "stream.yaml"
        cfg.write_text("Weights: {DA3: tiny}\n"
                       "Model: {chunk_size: 4, overlap: 2, process_res: 70}\n"
                       "IRLS: {delta: 0.1, max_iters: 5}\n")
        _, net = tiny_weights
        monkeypatch.setattr(DepthAnything3, "from_pretrained", classmethod(
            lambda cls, preset, seed=0, device="cuda": cls(get_preset("tiny"), net.to(device))))
        common = ["--image_dir", str(frames_dir), "--config", str(cfg), "--traj_formats", "tum,kitti"]
        j_main.main(common + ["--output_dir", str(tmp_path / "jax")])
        t_main.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
        for name in TRAJECTORY_FILES:
            tp, jp = np.loadtxt(tmp_path / "port" / name), np.loadtxt(tmp_path / "jax" / name)
            assert tp.shape == jp.shape and tp.shape[0] == 10 and np.isfinite(tp).all()
            np.testing.assert_allclose(tp, jp, atol=1e-3)
        (tp, tc), (jp, jc) = (ply.read_ply(tmp_path / d / "combined_pcd.ply") for d in ("port", "jax"))
        assert tp.shape == jp.shape and len(tp) > 0 and np.isfinite(tp).all()
        np.testing.assert_allclose(tp, jp, atol=1e-3 * max(1.0, np.abs(jp).max()))
        assert not (tmp_path / "port" / "_tmp_results_unaligned").exists()

    def test_cli_refuses_mesh_and_missing_cuda(self, tmp_path, monkeypatch):
        """``--mesh`` now writes scene_mesh.ply (the synthetic model standing
        in for the preset); without a card the default device is refused."""
        from da3slam_tpu_torch.cli import streaming

        poses = jsyn.make_trajectory(9)
        model = CountingModel(poses)
        monkeypatch.setattr(DepthAnything3, "from_pretrained",
                            classmethod(lambda cls, *a, **k: model))
        cfg = tmp_path / "c.yaml"
        cfg.write_text("Weights: {DA3: tiny}\n"
                       "Model: {chunk_size: 4, overlap: 1, mesh_resolution: 48}\n")
        run = streaming.main(["--image_dir", jsyn.make_synthetic_image_dir(tmp_path, 9),
                              "--config", str(cfg), "--mesh", "--output_dir",
                              str(tmp_path / "o"), "--device", "cpu"])
        assert run.export_mesh and model.calls == len(run.chunk_ranges)
        verts, faces, cols = read_mesh_ply(tmp_path / "o" / "scene_mesh.ply", with_colors=True)
        assert len(verts) > 100 and cols is not None
        assert not (tmp_path / "o" / "_tmp_results_unaligned").exists()
        if torch.cuda.is_available():
            return
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            streaming.main(["--image_dir", str(tmp_path)])


class TestInferenceExport:
    def test_mini_npz_matches_jax(self, tmp_path, tiny_weights):
        jparams, net = tiny_weights
        imgs = np.random.default_rng(8).integers(0, 256, size=(3, 56, 70, 3)).astype(np.uint8)
        kw = dict(image=imgs, process_res=70)
        JDA3(jget_preset("tiny"), jparams).inference(**kw, export_dir=str(tmp_path / "j"))
        pred = DepthAnything3(get_preset("tiny"), net).inference(**kw, export_dir=tmp_path / "t")
        zt, zj = np.load(tmp_path / "t" / "prediction.npz"), np.load(tmp_path / "j" / "prediction.npz")
        assert zt.files == zj.files == ["depth", "conf", "extrinsics", "intrinsics"]
        for key in zt.files:
            assert zt[key].dtype == zj[key].dtype == np.float32
            np.testing.assert_array_equal(zt[key], getattr(pred, key))
            # tests/test_torch_model.py's bounds for the tiny model's outputs
            np.testing.assert_allclose(zt[key], zj[key], atol=1e-4, rtol=1e-4)

    def test_glb_and_unknown_formats_refused(self, tmp_path, tiny_weights):
        """Unknown formats are refused before the forward; ``glb``, refused
        until the 3DGS half of mapping was ported, now writes ``scene.glb``
        (``tests/test_torch_export3d.py`` holds its bytes to the JAX package)."""
        model = DepthAnything3(get_preset("tiny"), tiny_weights[1])
        imgs = make_frames(2)
        with pytest.raises(ValueError, match="export_format"):
            model.inference(imgs, process_res=70, export_dir=tmp_path, export_format="ply")
        assert not any(tmp_path.iterdir())
        model.inference(imgs, process_res=70, export_dir=tmp_path, export_format="glb")
        assert [p.name for p in tmp_path.iterdir()] == ["scene.glb"]


class TestHostIO:
    """The port's numpy copies against the JAX package's originals."""

    @pytest.mark.parametrize("binary", [True, False])
    @pytest.mark.parametrize("colors", [True, False])
    def test_read_ply_matches_jax(self, tmp_path, binary, colors):
        rng = np.random.default_rng(0)
        pts = rng.normal(size=(57, 3)).astype(np.float32)
        cols = rng.integers(0, 256, size=(57, 3)).astype(np.uint8) if colors else None
        jply.write_ply(tmp_path / "a.ply", pts, cols, binary=binary)
        (tp, tc), (jp, jc) = ply.read_ply(tmp_path / "a.ply"), jply.read_ply(tmp_path / "a.ply")
        np.testing.assert_array_equal(tp, jp)
        assert tp.dtype == jp.dtype
        if colors:
            np.testing.assert_array_equal(tc, jc)
        else:
            assert tc is None and jc is None

    def test_merge_ply_files_matches_jax(self, tmp_path):
        rng = np.random.default_rng(1)
        d = tmp_path / "pcd"
        for k in range(3):  # one uncolored file: gray 200
            cols = rng.integers(0, 256, size=(10 + k, 3)).astype(np.uint8) if k != 1 else None
            ply.write_ply(d / f"chunk_{k}.ply", rng.normal(size=(10 + k, 3)), cols)
        assert ply.merge_ply_files(d, tmp_path / "t.ply") == 33
        assert jply.merge_ply_files(d, tmp_path / "j.ply") == 33
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
        assert ply.merge_ply_files(tmp_path / "empty", tmp_path / "e.ply") == 0

    def test_trajectory_files_and_loaders_match_jax(self, tmp_path):
        c2w = gt_c2w(jsyn.make_orbit_trajectory(12))  # every quaternion branch
        intr = np.tile(np.array([[60.0, 0, 32], [0, 60, 24], [0, 0, 1]]), (12, 1, 1))
        trajectory.save_camera_poses(tmp_path / "t", c2w, intr, chunk_indices=np.arange(12) // 4,
                                     extra_formats=("tum", "kitti"))
        jtraj.save_camera_poses(tmp_path / "j", c2w, intr, chunk_indices=np.arange(12) // 4,
                                extra_formats=("tum", "kitti"))
        for name in ("camera_poses.txt", "intrinsic.txt", "camera_poses.ply", *TRAJECTORY_FILES):
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
        for name in TRAJECTORY_FILES:
            got = trajectory.load_trajectory(tmp_path / "t" / name)
            np.testing.assert_array_equal(got, jtraj.load_trajectory(tmp_path / "t" / name))
            np.testing.assert_allclose(got, c2w, atol=1e-7)
        ts, tum = trajectory.load_trajectory_tum(tmp_path / "t" / "camera_poses_tum.txt")
        np.testing.assert_array_equal(ts, np.arange(12))
        kitti = tmp_path / "comma.txt"
        kitti.write_text("\n".join(",".join(map(str, r)) for r in c2w[:, :3].reshape(12, 12)))
        np.testing.assert_array_equal(trajectory.load_trajectory(kitti),
                                      jtraj.load_trajectory(kitti))
        with pytest.raises(ValueError, match="unknown trajectory export format"):
            trajectory.validate_extra_formats(["tum", "euroc"])
        bad = tmp_path / "bad.txt"
        bad.write_text("1 2 3\n")
        with pytest.raises(ValueError, match="unrecognized"):
            trajectory.load_trajectory(bad)

    def test_rotmat_to_quat_matches_jax(self):
        from da3slam_tpu.inout.export3d import _rotmat_to_quat_np

        R = gt_c2w(jsyn.make_orbit_trajectory(40))[:, :3, :3]
        R = np.concatenate([R, R @ np.diag([1.0, -1.0, -1.0])])  # w near 0 too
        np.testing.assert_array_equal(trajectory._rotmat_to_quat_np(R), _rotmat_to_quat_np(R))

    def test_synthetic_generators_match_jax(self, tmp_path):
        for fn in ("make_trajectory", "make_loop_trajectory", "make_orbit_trajectory"):
            np.testing.assert_array_equal(getattr(tsyn, fn)(17), getattr(jsyn, fn)(17))
        K = tsyn.default_intrinsics(HW)
        np.testing.assert_array_equal(K, jsyn.default_intrinsics(HW))
        poses = tsyn.make_loop_trajectory(5)  # facing the corner: every ray hits PLANES
        np.testing.assert_array_equal(tsyn.render_rgb_sequence(poses, K, HW),
                                      jsyn.render_rgb_sequence(poses, K, HW))
        orbit = tsyn.make_orbit_trajectory(5)[3]
        np.testing.assert_array_equal(tsyn.render_depth(orbit, K, HW, tsyn.BOX_PLANES),
                                      jsyn.render_depth(orbit, K, HW, jsyn.BOX_PLANES))
        dirs = [Path(pkg.make_synthetic_image_dir(tmp_path / name, 7))
                for name, pkg in (("t", tsyn), ("j", jsyn))]
        assert [p.name for p in sorted(dirs[0].iterdir())] == [p.name for p in
                                                               sorted(dirs[1].iterdir())]

    @pytest.mark.parametrize("kw", [dict(), dict(textured=True, brightness_drift=0.35),
                                    dict(chunk_scales=[1.0, 1.4], depth_noise=1e-2, seed=3)])
    def test_synthetic_model_matches_jax(self, kw):
        from da3slam_tpu_torch.models.da3 import Prediction

        poses = tsyn.make_loop_trajectory(12)
        t, j = tsyn.SyntheticDA3(poses, **kw), jsyn.SyntheticDA3(poses, **kw)
        for idx in ([0, 1, 2, 3], [3, 4, 5, 11]):
            names = [f"{i:06d}.jpg" for i in idx]
            pt, pj = t.inference(names), j.inference(names)
            assert isinstance(pt, Prediction)
            for f in ("processed_images", "depth", "conf", "extrinsics", "intrinsics"):
                np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
