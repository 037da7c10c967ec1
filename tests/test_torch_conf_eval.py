"""The port's confidence statistics, ``main_conf``, dataset loaders,
``cli/evaluate`` and ``main_align --debug_color`` against the JAX package's.

Both packages read the same generated files: a C3VD-layout sequence (colour
PNGs, 16-bit depth TIFFs, ``pose.txt`` row- or column-major, millimetres) and
a KITTI-layout one (``image_2/``, ``calib.txt``, ``poses.txt``).  Models are
the tiny preset with the JAX package's seed-0 weights in both.  Tolerances:
host code in f64 or on the same files, equal; the evaluation's JSON within
1e-6 (its alignment runs in f32 in both); model outputs as
``tests/test_torch_slam.py`` holds them.
"""

import json
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from da3slam_tpu.inout import datasets as jdatasets
from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import DepthAnything3 as JDA3
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.viz import confidence as jconf
from da3slam_tpu.viz import debug as jdebug
from da3slam_tpu_torch.inout import datasets
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net
from da3slam_tpu_torch.models.da3 import DepthAnything3 as TDA3
from da3slam_tpu_torch.viz import confidence, debug

torch.set_num_threads(2)


def poses_c2w(n, seed=0):
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = 0.05 * i + rng.normal(scale=0.01)
        out[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        out[i, :3, 3] = [2.0 * i, 0.3 * np.sin(i), 1.0 + 0.1 * i]  # millimetres
    return out


def write_c3vd(d, n=5, hw=(40, 50), layout="row", depth=True, seed=0):
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*hw, 3)).astype(np.uint8)).save(
            d / f"{i:04d}_color.png")
        if depth:
            raw = rng.integers(0, 65536, hw).astype(np.uint16)
            raw[0, :3] = 0  # invalid pixels
            Image.fromarray(raw).save(d / f"{i:04d}_depth.tiff")
    T = poses_c2w(n, seed)
    if layout == "col":
        T = np.swapaxes(T, 1, 2)
    (d / "pose.txt").write_text("\n".join(",".join(f"{v:.9f}" for v in m.reshape(-1)) for m in T))
    return d


def write_kitti(d, n=4, seed=0):
    (d / "image_2").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)).save(
            d / "image_2" / f"{i:06d}.png")
    (d / "calib.txt").write_text(
        "P0: 700 0 300 0 0 700 100 0 0 0 1 0\nP2: 718.5 0 607.2 44.9 0 718.5 185.2 0.2 0 0 1 0\n")
    T = poses_c2w(n, seed)
    (d / "poses.txt").write_text("\n".join(" ".join(f"{v:.9e}" for v in m[:3].reshape(-1))
                                           for m in T))
    return d


def assert_same_sequence(a, b):
    assert [str(p) for p in a.image_paths] == [str(p) for p in b.image_paths]
    assert (a.depth_paths is None) == (b.depth_paths is None)
    if a.depth_paths is not None:
        assert [str(p) for p in a.depth_paths] == [str(p) for p in b.depth_paths]
    for x, y in ((a.poses_c2w, b.poses_c2w), (a.intrinsics, b.intrinsics)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


class TestConfStats:
    @pytest.mark.parametrize("case", ["random", "constant", "skewed"])
    def test_equals_jax(self, case, capsys):
        rng = np.random.default_rng(0)
        conf = {"random": rng.uniform(1, 5, (30, 40)),
                "constant": np.full((8, 8), 2.0),
                "skewed": np.exp(rng.normal(size=(16, 16)))}[case].astype(np.float32)
        got, want = confidence.conf_stats(conf, 7), jconf.conf_stats(conf, 7)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        confidence.print_conf_stats(conf, 3)
        ours = capsys.readouterr().out
        jconf.print_conf_stats(conf, 3)
        assert ours == capsys.readouterr().out


@pytest.fixture
def tiny_weights(monkeypatch):
    """Both packages' ``from_pretrained`` give the tiny model with the JAX
    package's seed-0 weights."""
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jget_preset("tiny")))
    net = DA3Net(get_preset("tiny"))
    net.load_state_dict(convert(params), strict=True)
    monkeypatch.setattr(TDA3, "from_pretrained", classmethod(
        lambda cls, preset, seed=0, device="cuda": cls(get_preset("tiny"), net.to(device))))
    monkeypatch.setattr(JDA3, "from_pretrained", classmethod(
        lambda cls, preset, seed=0: cls(jget_preset("tiny"), params, dtype=jax.numpy.float32)))


def frames_dir(tmp_path, n=5):
    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (56, 70 + 4 * n, 3)).astype(np.uint8)
    for i in range(n):
        Image.fromarray(base[:, 4 * i: 4 * i + 70]).save(d / f"{i:06d}.png")
    return d


class TestMainConf:
    def test_stats_equal_jax(self, tmp_path, tiny_weights, monkeypatch):
        """``main_conf --stats_only`` on tiny prints each frame's statistics
        of the same confidence maps as the JAX CLI (which also draws them)."""
        from da3slam_tpu.cli import main_conf as jmain
        from da3slam_tpu_torch.cli import main_conf as tmain

        jconfs = []
        orig = JDA3.inference

        def record(self, *a, **k):
            pred = orig(self, *a, **k)
            jconfs.append(np.asarray(pred.conf))
            return pred

        monkeypatch.setattr(JDA3, "inference", record)
        d = frames_dir(tmp_path)
        common = ["--image_dir", str(d), "--model", "tiny", "--chunk_size", "4",
                  "--process_res", "70"]
        jmain.main(common + ["--output_dir", str(tmp_path / "figs")])
        assert (tmp_path / "figs" / "heatmap_grid.png").exists()
        stats = tmain.main(common + ["--stats_only", "--device", "cpu"])
        assert len(stats) == 4 == len(jconfs[0])
        for s, conf in zip(stats, jconfs[0]):
            want = jconf.conf_stats(conf)
            for k in ("min", "max", "mean", "median", "bins"):
                np.testing.assert_allclose(s[k], want[k], rtol=1e-4, err_msg=k)
            # a pixel within rounding of a bin edge may fall on either side
            assert np.abs(s["counts"] - want["counts"]).sum() <= 2

    def test_refuses_figures_and_missing_cuda(self, tmp_path, monkeypatch):
        """The figures are drawn now: without --stats_only the run reaches the
        image check; without matplotlib it stops first, naming the module,
        and writes nothing; without CUDA it refuses."""
        from da3slam_tpu_torch.cli import main_conf as tmain

        out = tmp_path / "figs"
        with pytest.raises(SystemExit, match="no images"):
            tmain.main(["--image_dir", str(tmp_path), "--device", "cpu", "--output_dir", str(out)])
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "matplotlib", None)
            with pytest.raises(SystemExit, match="matplotlib"):
                tmain.main(["--image_dir", str(tmp_path), "--device", "cpu",
                            "--output_dir", str(out)])
        assert not out.exists()
        with pytest.raises(SystemExit, match="no images"):
            tmain.main(["--image_dir", str(tmp_path), "--device", "cpu", "--stats_only"])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tmain.main(["--image_dir", str(tmp_path), "--stats_only"])


class TestDatasets:
    @pytest.mark.parametrize("layout", ["row", "col", "auto_col", "no_depth"])
    def test_c3vd_equals_jax(self, tmp_path, layout):
        d = write_c3vd(tmp_path / "seq", layout="col" if "col" in layout else "row",
                       depth=layout != "no_depth")
        kw = {"pose_layout": layout} if layout in ("row", "col") else {}
        seq, jseq = datasets.load_c3vd_sequence(d, **kw), jdatasets.load_c3vd_sequence(d, **kw)
        assert_same_sequence(seq, jseq)
        np.testing.assert_allclose(seq.poses_c2w[:, :3, 3], poses_c2w(5)[:, :3, 3] * 1e-3,
                                   atol=1e-12)
        stack, jstack = datasets.load_depth_stack(seq), jdatasets.load_depth_stack(jseq)
        if layout == "no_depth":
            assert stack is None and jstack is None
            return
        assert stack.dtype == np.float32 and stack.shape == (5, 40, 50)
        np.testing.assert_array_equal(stack, jstack)
        assert stack[0, 0, 0] == 0 and stack.max() <= 0.1

    def test_c3vd_errors_equal_jax(self, tmp_path):
        d = write_c3vd(tmp_path / "seq")
        (d / "0004_depth.tiff").unlink()
        for mod in (datasets, jdatasets):
            with pytest.raises(ValueError, match="depth maps"):
                mod.load_c3vd_sequence(d)
        with pytest.raises(FileNotFoundError):
            datasets.load_c3vd_sequence(tmp_path / "empty_dir_absent")

    def test_plain_frame_dir(self, tmp_path):
        d = frames_dir(tmp_path)
        assert_same_sequence(datasets.load_c3vd_sequence(d), jdatasets.load_c3vd_sequence(d))

    def test_kitti_equals_jax(self, tmp_path):
        d = write_kitti(tmp_path / "00")
        seq, jseq = datasets.load_kitti_sequence(d), jdatasets.load_kitti_sequence(d)
        assert_same_sequence(seq, jseq)
        assert seq.intrinsics[0, 0] == 718.5
        for mod in (datasets, jdatasets):
            with pytest.raises(FileNotFoundError, match="poses file not found"):
                mod.load_kitti_sequence(d, poses_file=tmp_path / "absent.txt")


class TestEvaluateCli:
    def run_both(self, args, capsys):
        from da3slam_tpu.cli import evaluate as jeval
        from da3slam_tpu_torch.cli import evaluate as teval

        jeval.main(args)
        want = json.loads(capsys.readouterr().out)
        got = teval.main(args + ["--device", "cpu"])
        assert json.loads(capsys.readouterr().out) == got
        return got, want

    def assert_json_close(self, got, want):
        assert got.keys() == want.keys()
        for section in want:
            assert got[section].keys() == want[section].keys()
            for k, v in want[section].items():
                np.testing.assert_allclose(got[section][k], v, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{section}.{k}")

    @pytest.mark.parametrize("align", ["sim3", "se3", "none"])
    def test_trajectory_equals_jax(self, tmp_path, capsys, align):
        from da3slam_tpu_torch.inout.trajectory import save_trajectory_kitti

        gt = poses_c2w(12, 1)
        rng = np.random.default_rng(2)
        est = gt.copy()
        est[:, :3, 3] = 0.5 * est[:, :3, 3] + rng.normal(scale=0.05, size=(12, 3))
        save_trajectory_kitti(tmp_path / "est.txt", est)
        save_trajectory_kitti(tmp_path / "gt.txt", gt)
        got, want = self.run_both(["--est", str(tmp_path / "est.txt"), "--gt",
                                   str(tmp_path / "gt.txt"), "--align", align,
                                   "--rpe_delta", "2"], capsys)
        self.assert_json_close(got, want)

    def test_depth_and_c3vd_sequence_equal_jax(self, tmp_path, capsys):
        """Trajectory against the sequence's pose.txt and depth against its
        TIFFs, the predictions at another resolution (resampled to the gt
        grid: a downscale, antialiased as ``jax.image.resize`` does)."""
        from da3slam_tpu_torch.inout.trajectory import save_camera_poses

        d = write_c3vd(tmp_path / "seq", n=5, hw=(40, 50))
        gt = datasets.load_c3vd_sequence(d)
        rng = np.random.default_rng(4)
        est = gt.poses_c2w.copy()
        est[:, :3, 3] *= 3.0
        save_camera_poses(tmp_path / "out", est, np.tile(np.eye(3, dtype=np.float32), (5, 1, 1)))
        depth = datasets.load_depth_stack(gt)
        pred = np.stack([np.kron(f, np.ones((2, 2))) for f in depth]) * 7.0
        pred = (pred * rng.uniform(0.9, 1.1, pred.shape)).astype(np.float32)
        np.save(tmp_path / "depth.npy", pred)
        got, want = self.run_both(["--est", str(tmp_path / "out" / "camera_poses.txt"),
                                   "--gt_seq", str(d), "--depth_est", str(tmp_path / "depth.npy"),
                                   "--max_depth", "0.09"], capsys)
        assert set(got) == {"trajectory", "depth"}
        self.assert_json_close(got, want)

    def test_refuses_as_jax(self, tmp_path):
        from da3slam_tpu_torch.cli import evaluate as teval

        with pytest.raises(SystemExit, match="nothing to evaluate"):
            teval.main(["--device", "cpu"])
        from da3slam_tpu_torch.inout.trajectory import save_trajectory_kitti

        save_trajectory_kitti(tmp_path / "est.txt", poses_c2w(3))
        with pytest.raises(SystemExit, match="--est needs"):
            teval.main(["--device", "cpu", "--est", str(tmp_path / "est.txt")])
        with pytest.raises(SystemExit, match="--depth_est needs"):
            teval.main(["--device", "cpu", "--depth_est", str(tmp_path / "d.npy")])


class TestDebugColor:
    @pytest.mark.parametrize("index", [0, 1, 2, 7, 100])
    def test_colors_equal_jax(self, index):
        assert debug.get_distinct_color(index) == jdebug.get_distinct_color(index)
        imgs = np.random.default_rng(index).integers(0, 256, (2, 5, 6, 3)).astype(np.uint8)
        for blend in (0.6, 1.0, 0.0):
            np.testing.assert_array_equal(
                debug.apply_chunk_color_to_images_batch(imgs, index, blend),
                jdebug.apply_chunk_color_to_images_batch(imgs, index, blend))

    def test_main_align_ply_colors_equal_jax(self, tmp_path, tiny_weights):
        """``main_align --debug_color`` of both packages over 9 frames in
        chunks of 4 (Umeyama): the same points (1e-3, as
        ``tests/test_torch_slam.py``) and the same per-chunk tints."""
        from da3slam_tpu.cli import main_align as jmain
        from da3slam_tpu.inout.ply import read_ply
        from da3slam_tpu_torch.cli import main_align as tmain

        d = frames_dir(tmp_path, 9)
        common = ["--image_dir", str(d), "--model", "tiny", "--method", "umeyama",
                  "--process_res", "70", "--headless", "--debug_color"]
        jmain.main(common + ["--output_ply", str(tmp_path / "jax.ply")])
        tmain.main(common + ["--output_ply", str(tmp_path / "port.ply"), "--device", "cpu"])
        (tp, tc), (jp, jc) = read_ply(tmp_path / "port.ply"), read_ply(tmp_path / "jax.ply")
        assert tp.shape == jp.shape and len(tp) > 0
        np.testing.assert_allclose(tp, jp, atol=1e-3)
        np.testing.assert_array_equal(tc, jc)
        tints = {tuple(c) for c in tc}
        assert len(tints) >= 2  # one colour family a chunk
