"""The port's parity harness (``utils/parity.py``, ``cli/parity.py``) against
``da3slam_tpu.utils.parity`` and ``da3slam_tpu.cli.parity``.

The metrics are numpy in f64 in both packages: on the same arrays they agree
to 1e-12.  The CLI is run on a tiny checkpoint directory (the JAX package's
seed-0 weights, dot-named) and goldens that the JAX package's model wrote;
its exit codes (0 pass, 1 fail, 2 no data) are the JAX CLI's on the same
inputs, and its metrics are within 1e-4 of the JAX run's (the two models'
outputs differ by f32 rounding), but for ``trans_rel``, an error over the
random-weight model's near-zero trajectory extent.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from da3slam_tpu.cli import parity as jcli
from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import DepthAnything3 as JDA3
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.models.torch_import import export_torch_style
from da3slam_tpu.utils import parity as jparity
from da3slam_tpu_torch.cli import parity as tcli
from da3slam_tpu_torch.models.weights import save_file
from da3slam_tpu_torch.utils import parity

torch.set_num_threads(2)


def arrays(seed=0, n=3, hw=(24, 30)):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 5.0, (n, *hw)).astype(np.float32)
    conf = rng.uniform(1.0, 3.0, (n, *hw)).astype(np.float32)
    ang = rng.normal(scale=0.2, size=(n, 3))
    ext = np.zeros((n, 3, 4), np.float32)
    for i, (a, b, c) in enumerate(ang):
        Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        ext[i, :, :3] = Rz @ Ry
        ext[i, :, 3] = rng.normal(size=3) * (i > 0) + c
    K = np.tile(np.array([[40.0, 0, 15], [0, 41.0, 12], [0, 0, 1]], np.float32), (n, 1, 1))
    images = rng.integers(0, 256, (n, *hw, 3)).astype(np.uint8)
    return {"processed_images": images, "depth": depth, "conf": conf, "extrinsics": ext,
            "intrinsics": K}


@dataclasses.dataclass
class Pred:
    depth: np.ndarray
    conf: np.ndarray
    extrinsics: np.ndarray
    intrinsics: np.ndarray


def perturbed(gold, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return Pred(
        depth=(gold["depth"] * 1.7 * (1 + scale * 0.01 * rng.normal(size=gold["depth"].shape))
               ).astype(np.float32),
        conf=(gold["conf"] + scale * 0.05 * rng.normal(size=gold["conf"].shape)).astype(np.float32),
        extrinsics=(gold["extrinsics"] + scale * 0.01 * rng.normal(size=(3, 3, 4))
                    ).astype(np.float32),
        intrinsics=(gold["intrinsics"] * (1 + scale * 0.005)).astype(np.float32),
    )


class TestMetrics:
    @pytest.mark.parametrize("scale", [0.0, 1.0, 10.0])
    def test_compare_prediction_equals_jax(self, scale):
        gold = arrays()
        pred = perturbed(gold, scale=scale)
        got, want = parity.compare_prediction(pred, gold), jparity.compare_prediction(pred, gold)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12, err_msg=k)
        assert parity.check_thresholds(got) == jparity.check_thresholds(want)

    def test_depth_and_pose_parity_equal_jax(self):
        gold = arrays(2)
        pred = perturbed(gold, seed=3)
        depth = gold["depth"].copy()
        depth[0, 0, :4] = [0.0, np.nan, np.inf, -1.0]  # invalid gt pixels are skipped
        assert parity.depth_parity(pred.depth, depth) == jparity.depth_parity(pred.depth, depth)
        got = parity.pose_parity(pred.extrinsics, gold["extrinsics"])
        want = jparity.pose_parity(pred.extrinsics, gold["extrinsics"])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("thresholds", [None, {"depth_absrel": 1e-9}, {"conf_corr": 1.1},
                                            {"rot_deg": 0.0, "focal_rel": 0.0}])
    def test_check_thresholds_equals_jax(self, thresholds):
        metrics = parity.compare_prediction(perturbed(arrays(), scale=1.0), arrays())
        assert parity.DEFAULT_THRESHOLDS == jparity.DEFAULT_THRESHOLDS
        assert parity.check_thresholds(metrics, thresholds) == \
            jparity.check_thresholds(metrics, thresholds)

    @pytest.mark.parametrize("keys", [
        ("processed_images", "depth", "conf", "extrinsics", "intrinsics"),
        ("images", "depths", "confidence", "poses_w2c", "K"),
        ("image", "depth4d", "conf_map", "extrinsic", "intrinsic"),
    ])
    def test_load_mini_npz_equals_jax(self, tmp_path, keys):
        gold = arrays()
        blob = {}
        for key, (ours, v) in zip(keys, gold.items()):
            if key == "depth4d":
                key, v = "depth", v[..., None]
            blob[key] = v
        np.savez(tmp_path / "g.npz", **blob)
        got, want = parity.load_mini_npz(tmp_path / "g.npz"), jparity.load_mini_npz(
            tmp_path / "g.npz")
        assert list(got) == list(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)
        assert got["depth"].ndim == 3

    def test_load_mini_npz_missing_keys_raises(self, tmp_path):
        np.savez(tmp_path / "g.npz", conf=np.ones((1, 2, 2)))
        for mod in (parity, jparity):
            with pytest.raises(ValueError, match="missing required keys"):
                mod.load_mini_npz(tmp_path / "g.npz")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A dot-named tiny checkpoint directory (the JAX package's seed-0
    weights) and two goldens its JAX model wrote, one per chunk."""
    root = tmp_path_factory.mktemp("parity")
    cfg = jget_preset("tiny")
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), cfg))
    ckpt = root / "checkpoint"
    ckpt.mkdir()
    save_file({k: np.ascontiguousarray(v) for k, v in export_torch_style(params).items()},
              ckpt / "model.safetensors")
    (ckpt / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    jmodel = JDA3(cfg, params, dtype=jax.numpy.float32)
    (root / "golden").mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        imgs = rng.integers(0, 256, (3, 56, 70, 3)).astype(np.uint8)
        jmodel.inference(image=list(imgs), process_res=70,
                         export_dir=str(root / f"export{i}"))
        z = dict(np.load(root / f"export{i}" / "prediction.npz"))
        z["processed_images"] = imgs
        np.savez(root / "golden" / f"golden_{i:03d}.npz", **z)
    return root


class TestCli:
    def test_pass_is_0_as_in_jax(self, checkpoint, capsys):
        args = ["--checkpoint", str(checkpoint / "checkpoint"), "--golden",
                *sorted(str(p) for p in (checkpoint / "golden").glob("*.npz"))]
        assert jcli.main(args) == 0
        capsys.readouterr()
        assert tcli.main(args + ["--device", "cpu"]) == 0
        assert "parity: 2/2 golden files passed" in capsys.readouterr().out

    def test_parity_dir_layout_and_metrics_equal_jax(self, checkpoint, monkeypatch):
        monkeypatch.setenv("DA3_PARITY_DIR", str(checkpoint))
        assert parity.find_parity_dir() == checkpoint == jparity.find_parity_dir()
        goldens = sorted((checkpoint / "golden").glob("*.npz"))
        got, ok = parity.run_parity(checkpoint / "checkpoint", goldens, device="cpu")
        want, jok = jparity.run_parity(checkpoint / "checkpoint", goldens)
        assert ok and jok
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                if k == "trans_rel":
                    # divided by the golden trajectory's extent, which the
                    # random-weight model keeps near 0: held to the bound
                    assert g[k] <= parity.DEFAULT_THRESHOLDS[k]
                    continue
                np.testing.assert_allclose(g[k], w[k], atol=1e-4, err_msg=k)
        assert tcli.main(["--device", "cpu"]) == 0

    def test_fail_is_1_as_in_jax(self, checkpoint, tmp_path):
        z = dict(np.load(checkpoint / "golden" / "golden_000.npz"))
        z["depth"] = z["depth"] * np.random.default_rng(0).uniform(0.5, 1.5, z["depth"].shape)
        np.savez(tmp_path / "bad.npz", **z)
        args = ["--checkpoint", str(checkpoint / "checkpoint"), "--golden", str(tmp_path / "bad.npz")]
        assert jcli.main(args) == 1
        assert tcli.main(args + ["--device", "cpu"]) == 1

    def test_no_data_is_2_as_in_jax(self, tmp_path, monkeypatch):
        monkeypatch.delenv("DA3_PARITY_DIR", raising=False)
        empty = tmp_path / "empty"
        (empty / "golden").mkdir(parents=True)
        for args in (["--parity_dir", str(empty)], ["--parity_dir", str(tmp_path / "absent")]):
            assert jcli.main(args) == 2
            assert tcli.main(args + ["--device", "cpu"]) == 2
        monkeypatch.setenv("DA3_PARITY_DIR", str(tmp_path / "absent"))
        if parity.find_parity_dir() is None:  # no parity_data/ at the repository's root
            assert tcli.main(["--device", "cpu"]) == 2

    def test_cuda_refused_without_cuda(self, tmp_path):
        if torch.cuda.is_available():
            return
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["--parity_dir", str(tmp_path)])
