"""The port's ``cli/main_video.py`` against ``da3slam_tpu.cli.main_video``.

Neither machine has a video codec, so the decode stage is replaced, in both
packages, by ``tests/test_cli.py::TestMainVideo``'s fake decoder (the same
frames each time); crop, brightness and the SLAM stage run for real on the
same tiny weights.  Both packages' trajectories agree within 1e-3, the bound
of ``tests/test_torch_streaming.py::TestCli::test_both_clis_agree`` (the
brightness pass may flip a CLAHE bin between the packages:
``tests/test_torch_preprocess.py``).  The decoder itself is held to the JAX
package's on an animated GIF, which imageio decodes through its pillow
plugin.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import DepthAnything3 as JDA3
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net
from da3slam_tpu_torch.models.da3 import DepthAnything3 as TDA3

torch.set_num_threads(2)
POSE_TOL = 1e-3


def _fake_decoder():
    spec = importlib.util.spec_from_file_location(
        "jax_test_cli", Path(__file__).with_name("test_cli.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.TestMainVideo()._fake_decoder()


@pytest.fixture()
def both(monkeypatch):
    """Both packages' decoders replaced by the fake one and both DA3 on the
    same tiny weights."""
    import da3slam_tpu.preprocess.host as jhost
    import da3slam_tpu_torch.preprocess.host as thost

    monkeypatch.setattr(jhost, "video_to_frames", _fake_decoder())
    monkeypatch.setattr(thost, "video_to_frames", _fake_decoder())
    jparams = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jget_preset("tiny")))
    net = DA3Net(get_preset("tiny"))
    net.load_state_dict(convert(jparams), strict=True)
    monkeypatch.setattr(TDA3, "from_pretrained", classmethod(
        lambda cls, preset, seed=0, device="cuda": cls(get_preset("tiny"), net.to(device))))


STREAMING_CFG = ("Weights:\n  DA3: tiny\n"
                 "Model:\n  chunk_size: 5\n  overlap: 2\n  process_res: 56\n")
SLAM_CFG = ("Weights:\n  DA3: tiny\n"
            "Model:\n  chunk_size: 4\n  overlap_size: 1\n  process_res: 56\n"
            "  keyframe_interval: 1\n  sleep_between_chunk: 0\n"
            "Align:\n  method: umeyama\n")


def run_both(tmp_path, cfg_text, flags):
    from da3slam_tpu.cli import main_video as jmain
    from da3slam_tpu_torch.cli import main_video as tmain

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(cfg_text)
    common = ["--video", "fake.mp4", "--config", str(cfg)] + flags
    jmain.main(common + ["--output_dir", str(tmp_path / "j")])
    ran = tmain.main(common + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    return ran, tmp_path / "t", tmp_path / "j"


def assert_same_tree(t: Path, j: Path) -> None:
    names = sorted(p.relative_to(t).as_posix() for p in t.rglob("*"))
    assert names == sorted(p.relative_to(j).as_posix() for p in j.rglob("*"))


class TestMainVideo:
    def test_full_chain_streaming(self, tmp_path, both):
        """``tests/test_cli.py``'s streaming chain: stride 2, crop 0.9,
        brightness, TUM export."""
        ran, t, j = run_both(tmp_path, STREAMING_CFG,
                             ["--stride", "2", "--crop", "0.9", "--brightness",
                              "--traj_formats", "tum"])
        assert type(ran).__name__ == "DA3Streaming"
        for path in ("frames/000000.jpg", "slam/camera_poses.txt", "slam/camera_poses_tum.txt",
                     "slam/combined_pcd.ply"):
            assert (t / path).exists(), path
        assert (t / "cropped").is_dir() and (t / "normalized").is_dir()
        assert_same_tree(t, j)
        for f in sorted((t / "frames").iterdir()):
            np.testing.assert_array_equal(np.asarray(Image.open(f)),
                                          np.asarray(Image.open(j / "frames" / f.name)))
        for name in ("camera_poses.txt", "camera_poses_tum.txt"):
            tp, jp = np.loadtxt(t / "slam" / name), np.loadtxt(j / "slam" / name)
            assert tp.shape == jp.shape and tp.shape[0] == 5 and np.isfinite(tp).all()
            np.testing.assert_allclose(tp, jp, atol=POSE_TOL)

    def test_slam_mode_headless(self, tmp_path, both, monkeypatch):
        """``--mode slam --headless``: the solver over the crop preset's
        frames, the trajectory exported as in JAX."""
        for cls in (JDA3, TDA3):  # the solver runs at the inference default; cut it
            monkeypatch.setattr(cls, "inference", functools.partialmethod(cls.inference,
                                                                          process_res=70))
        ran, t, j = run_both(tmp_path, SLAM_CFG, ["--mode", "slam", "--headless",
                                                  "--crop", "c3vd2", "--traj_formats", "kitti"])
        assert type(ran).__name__ == "SLAMSolver" and ran.viewer is None
        assert_same_tree(t, j)
        assert (t / "slam" / "camera_poses_kitti.txt").exists()
        tp = np.loadtxt(t / "slam" / "camera_poses.txt")
        jp = np.loadtxt(j / "slam" / "camera_poses.txt")
        assert tp.shape == (10, 16) and np.isfinite(tp).all()
        np.testing.assert_allclose(tp, jp, atol=POSE_TOL)

    @pytest.mark.parametrize("flags,message", [
        (["--crop", "1.5"], "ratio must be in"),
        (["--crop", "nope"], "unknown crop preset"),
        (["--traj_formats", "bad"], "unknown trajectory export format"),
    ])
    def test_errors_as_jax(self, tmp_path, both, flags, message):
        from da3slam_tpu.cli import main_video as jmain
        from da3slam_tpu_torch.cli import main_video as tmain

        errors = []
        for main, extra in ((jmain.main, []), (tmain.main, ["--device", "cpu"])):
            with pytest.raises((SystemExit, ValueError)) as e:
                main(["--video", "v.mp4", "--output_dir", str(tmp_path / str(len(errors)))]
                     + flags + extra)
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1] and message in errors[1][1]

    def test_no_frames_and_missing_cuda(self, tmp_path, monkeypatch):
        import da3slam_tpu_torch.preprocess.host as thost
        from da3slam_tpu_torch.cli import main_video as tmain

        monkeypatch.setattr(thost, "video_to_frames", lambda *a, **k: 0)
        with pytest.raises(SystemExit, match="no frames decoded"):
            tmain.main(["--video", "v.mp4", "--output_dir", str(tmp_path), "--device", "cpu"])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tmain.main(["--video", "v.mp4", "--output_dir", str(tmp_path)])


class TestVideoToFrames:
    @pytest.mark.parametrize("stride", [1, 2, 3])
    def test_gif_frames_bit_equal(self, tmp_path, stride):
        """An animated GIF written with PIL decodes to the same JPEG frames
        in both packages (imageio's pillow plugin; no ffmpeg needed)."""
        from da3slam_tpu.preprocess.host import video_to_frames as jdecode
        from da3slam_tpu_torch.preprocess.host import video_to_frames as tdecode

        rng = np.random.default_rng(stride)
        frames = [Image.fromarray(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
                  for _ in range(5)]
        gif = tmp_path / "clip.gif"
        frames[0].save(gif, save_all=True, append_images=frames[1:], duration=40, loop=0)
        n_t = tdecode(gif, tmp_path / "t", stride=stride)
        n_j = jdecode(gif, tmp_path / "j", stride=stride)
        assert n_t == n_j == len(range(0, 5, stride))
        names = sorted(p.name for p in (tmp_path / "t").iterdir())
        assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
        for name in names:
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()

    def test_undecodable_file_raises_as_jax(self, tmp_path):
        from da3slam_tpu.preprocess.host import video_to_frames as jdecode
        from da3slam_tpu_torch.preprocess.host import video_to_frames as tdecode

        bad = tmp_path / "bad.mp4"
        bad.write_bytes(b"not a video")
        msgs = []
        for decode in (tdecode, jdecode):
            with pytest.raises(RuntimeError, match="video decoding failed") as e:
                decode(bad, tmp_path / "o")
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
