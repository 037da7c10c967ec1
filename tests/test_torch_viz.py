"""The port's ``viz/sky.py``, ``viz/batch_viewer.py`` and confidence figures
(``viz/confidence.py``, ``cli/main_conf.py``) against the JAX package's on
the CPU.

The sky mask is numpy in both packages: bit-equal on
``tests/test_misc.py``'s scenes and on random images.  The figures are drawn
by the same matplotlib code in both: the PNGs decode to pixels within 1 LSB
of each other (the bound allows a renderer's rounding; here they are equal),
and ``main_conf --output_dir`` writes the same files as the JAX CLI.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays
from PIL import Image

import jax

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import Prediction as JPrediction
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.viz import batch_viewer as jbatch
from da3slam_tpu.viz import confidence as jconf
from da3slam_tpu.viz import sky as jsky
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net, init_params
from da3slam_tpu_torch.models.da3 import DepthAnything3 as TDA3
from da3slam_tpu_torch.models.da3 import Prediction
from da3slam_tpu_torch.viz import batch_viewer, confidence, sky

torch.set_num_threads(2)
PNG_LSB = 1


def _misc():
    spec = importlib.util.spec_from_file_location(
        "jax_test_misc", Path(__file__).with_name("test_misc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MISC = _misc()


def scene():
    """``tests/test_misc.py::TestSkyMask.make_scene``: blue sky over brown ground."""
    return MISC.TestSkyMask().make_scene()


def _dark_pixel(img):
    img[5, 30] = [120, 90, 50]


def _tower(img):
    img[0:20, 20:24] = [60, 50, 40]


def _lake(img):
    img[30:36, 10:50] = [110, 160, 230]


def _indoor(img):
    img[:] = np.random.default_rng(0).integers(30, 120, img.shape)


SCENES = {"sky_over_ground": None, "dark_pixel": _dark_pixel, "tower": _tower, "lake": _lake,
          "indoor": _indoor}


class TestSkyMask:
    @pytest.mark.parametrize("name", list(SCENES))
    @pytest.mark.parametrize("horizon", [0.6, 1.0, 0.0])
    def test_scenes_bit_equal(self, name, horizon):
        img = scene()
        if SCENES[name] is not None:
            SCENES[name](img)
        got = sky.sky_mask_heuristic(img, horizon=horizon)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, jsky.sky_mask_heuristic(img, horizon=horizon))

    @settings(max_examples=40, deadline=None)
    @given(img=arrays(np.uint8, st.tuples(st.integers(1, 24), st.integers(1, 24), st.just(3))),
           horizon=st.floats(0.0, 1.0))
    def test_random_images_bit_equal(self, img, horizon):
        np.testing.assert_array_equal(sky.sky_mask_heuristic(img, horizon),
                                      jsky.sky_mask_heuristic(img, horizon))

    @settings(max_examples=20, deadline=None)
    @given(cand=arrays(bool, st.integers(1, 40)), seed=arrays(bool, st.integers(1, 40)))
    def test_flood_row_equal(self, cand, seed):
        n = min(len(cand), len(seed))
        np.testing.assert_array_equal(sky._flood_row(cand[:n], seed[:n]),
                                      jsky._flood_row(cand[:n], seed[:n]))

    @pytest.mark.parametrize("onnx", [None, "/nonexistent.onnx"])
    def test_apply_sky_segmentation(self, onnx, capsys, monkeypatch):
        """The confidence of sky pixels zeroed as in JAX; an ONNX path
        without onnxruntime (or without the file) falls back to the
        heuristic with the JAX message."""
        monkeypatch.setitem(sys.modules, "onnxruntime", None)
        imgs = np.stack([scene(), scene()[:, ::-1].copy()])
        _tower(imgs[1])
        conf = np.random.default_rng(1).uniform(1, 3, (2, 40, 60)).astype(np.float32)
        got = sky.apply_sky_segmentation(conf, imgs, onnx_model_path=onnx)
        tout = capsys.readouterr().out
        want = jsky.apply_sky_segmentation(conf, imgs, onnx_model_path=onnx)
        jout = capsys.readouterr().out
        np.testing.assert_array_equal(got, want)
        assert (got[0, :18] == 0).mean() > 0.9 and (got[0, 22:] == conf[0, 22:]).all()
        assert conf.min() >= 1  # the input is not modified
        assert tout == jout
        assert ("using heuristic" in tout) == (onnx is not None)


def _prediction(cls, n=2, h=8, w=8):
    rng = np.random.default_rng(4)
    return cls(
        processed_images=rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8),
        depth=rng.uniform(0.5, 2, (n, h, w)).astype(np.float32),
        conf=rng.uniform(1, 2, (n, h, w)).astype(np.float32),
        extrinsics=np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1)),
        intrinsics=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
    )


class TestBatchViewer:
    @pytest.mark.parametrize("tensors", [False, True])
    def test_prediction_to_viewer_dict_equal(self, tensors):
        p, jp = _prediction(Prediction), _prediction(JPrediction)
        if tensors:  # a keep_on_device prediction
            p = Prediction(**{k: torch.from_numpy(v) for k, v in vars(p).items()
                              if isinstance(v, np.ndarray)})
        g = jp.extrinsics.astype(np.float64)
        g[:, 0, 3] = 7.0
        for ext in (None, g):
            d, jd = (batch_viewer.prediction_to_viewer_dict(p, ext),
                     jbatch.prediction_to_viewer_dict(jp, ext))
            assert d.keys() == jd.keys() == {"images", "depth", "conf", "extrinsics", "intrinsics"}
            for k in d:
                assert d[k].dtype == jd[k].dtype, k
                np.testing.assert_array_equal(d[k], jd[k], err_msg=k)

    def test_show_prediction_headless(self, capsys, monkeypatch):
        monkeypatch.setitem(sys.modules, "viser", None)
        assert batch_viewer.show_prediction(_prediction(Prediction), device="cpu") is None
        assert "cannot open the viewer" in capsys.readouterr().out

    def test_show_prediction_masks_sky_as_jax(self, monkeypatch):
        """Through the mock viser (``tests/test_torch_viewer.py``'s): the
        sky-masked frames reach both viewers alike (one batch in the port)."""
        tv = _viewer_mock()
        fake = SimpleNamespace(ViserServer=tv._Server)
        monkeypatch.setitem(sys.modules, "viser", fake)
        monkeypatch.delitem(sys.modules, "da3slam_tpu.viz.viewer", raising=False)
        p, jp = _prediction(Prediction, 2, 40, 60), _prediction(JPrediction, 2, 40, 60)
        for pred in (p, jp):
            pred.processed_images[:] = scene()
            pred.intrinsics[:] = [[30, 0, 30], [0, 30, 20], [0, 0, 1]]
        v = batch_viewer.show_prediction(p, block=False, mask_sky=True, point_stride=2,
                                         device="cpu")
        jv = jbatch.show_prediction(jp, block=False, mask_sky=True, point_stride=2)
        t, j = tv.record(v), tv.record(jv)
        tv.assert_same_scene(t, j)
        assert len(t["clouds"]) == 2
        for a, b in zip(v.all_confs, jv.all_confs):
            np.testing.assert_array_equal(a, b)
        assert 0.3 < (v.all_confs[0] == 0).mean() < 0.7  # the sky half is masked
        sys.modules.pop("da3slam_tpu.viz.viewer", None)


def _viewer_mock():
    spec = importlib.util.spec_from_file_location(
        "torch_test_viewer", Path(__file__).with_name("test_torch_viewer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestConfidenceFigures:
    @staticmethod
    def pixels(path):
        return np.asarray(Image.open(path).convert("RGBA")).astype(np.int16)

    @pytest.mark.parametrize("threshold", [None, 1.7])
    def test_comparison_png_within_one_lsb(self, tmp_path, threshold):
        rng = np.random.default_rng(5)
        img = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
        conf = rng.uniform(1, 3, (30, 40)).astype(np.float32)
        confidence.create_confidence_comparison(img, conf, tmp_path / "t" / "c.png", threshold)
        jconf.create_confidence_comparison(img, conf, tmp_path / "j" / "c.png", threshold)
        a, b = self.pixels(tmp_path / "t" / "c.png"), self.pixels(tmp_path / "j" / "c.png")
        assert a.shape == b.shape and a.shape[1] > 600
        assert np.abs(a - b).max() <= PNG_LSB

    @pytest.mark.parametrize("n", [1, 3, 6])
    def test_heatmap_png_within_one_lsb(self, tmp_path, n):
        confs = np.random.default_rng(n).uniform(1, 3, (n, 20, 24)).astype(np.float32)
        confidence.create_overall_heatmap(confs, tmp_path / "t.png")
        jconf.create_overall_heatmap(confs, tmp_path / "j.png")
        a, b = self.pixels(tmp_path / "t.png"), self.pixels(tmp_path / "j.png")
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= PNG_LSB

    def test_statistics_import_no_matplotlib(self):
        import subprocess

        code = ("import sys, numpy as np\n"
                "from da3slam_tpu_torch.viz import confidence as c\n"
                "c.print_conf_stats(np.linspace(1, 2, 100).reshape(10, 10), 0)\n"
                "print('matplotlib' in sys.modules)")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             check=True, cwd=Path(__file__).resolve().parents[1]).stdout
        assert out.splitlines()[-1] == "False"


def _frames_dir(tmp_path, n=4):
    rng = np.random.default_rng(0)
    base = rng.integers(40, 200, (56, 90, 3)).astype(np.uint8)
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(n):
        Image.fromarray(base[:, 4 * i: 4 * i + 70]).save(d / f"{i:06d}.png")
    return d


class TestMainConfFigures:
    def test_output_dir_files_as_jax(self, tmp_path, monkeypatch):
        """Both CLIs over the same frames and tiny weights: the same file
        names in --output_dir, each PNG of the same size."""
        from da3slam_tpu.cli import main_conf as jmain
        from da3slam_tpu_torch.cli import main_conf as tmain

        jparams = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jget_preset("tiny")))
        net = DA3Net(get_preset("tiny"))
        net.load_state_dict(convert(jparams), strict=True)
        monkeypatch.setattr(TDA3, "from_pretrained", classmethod(
            lambda cls, preset, seed=0, device="cuda": cls(get_preset("tiny"), net.to(device))))
        d = _frames_dir(tmp_path)
        common = ["--image_dir", str(d), "--model", "tiny", "--chunk_size", "4",
                  "--process_res", "70"]
        jmain.main(common + ["--output_dir", str(tmp_path / "j")])
        stats = tmain.main(common + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
        names = sorted(p.name for p in (tmp_path / "t").iterdir())
        assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
        assert names == [f"comparison_{i:03d}.png" for i in range(4)] + ["heatmap_grid.png"]
        for name in names:
            assert Image.open(tmp_path / "t" / name).size == Image.open(tmp_path / "j" / name).size
        assert len(stats) == 4

    def test_stats_only_draws_nothing(self, tmp_path, monkeypatch):
        from da3slam_tpu_torch.cli import main_conf as tmain

        monkeypatch.setattr(TDA3, "from_pretrained", classmethod(
            lambda cls, preset, seed=0, device="cuda": cls(get_preset("tiny"),
                                                            init_params(get_preset("tiny")))))
        d = _frames_dir(tmp_path, 2)
        tmain.main(["--image_dir", str(d), "--model", "tiny", "--process_res", "70",
                    "--device", "cpu", "--stats_only", "--output_dir", str(tmp_path / "o")])
        assert not (tmp_path / "o").exists()
