"""The port's 3-D exporters (``inout/export3d.py``) and
``inference(export_format="glb")`` against the JAX package on the CPU.

The 3DGS PLY and GLB files are byte for byte the JAX package's.  Here both
packages' C++ writers are switched off, as ``tests/test_native.py`` does, so
the numpy paths meet; ``tests/test_torch_native.py`` holds the two C++
writers to each other.
"""

from __future__ import annotations

import contextlib
import json
import struct
from types import SimpleNamespace

import numpy as np
import pytest

import jax

from da3slam_tpu.inout import export3d as jexp
from da3slam_tpu.models import DepthAnything3 as JDA3
from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu_torch.inout import export3d as exp
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net, DepthAnything3


@contextlib.contextmanager
def jax_numpy_path():
    """Both packages' exporters without their native writers (the numpy
    paths)."""
    import da3slam_tpu.native as native
    import da3slam_tpu_torch.native as tnative

    saved = [(m, m._lib, m._load_failed) for m in (native, tnative)]
    for m in (native, tnative):
        m._lib, m._load_failed = None, True
    try:
        yield
    finally:
        for m, lib, failed in saved:
            m._lib, m._load_failed = lib, failed


def prediction(seed: int, images: str = "uint8", N: int = 3, H: int = 40, W: int = 36):
    """A prediction-shaped namespace of ``test_native.py``'s kind: random
    depth (one pixel at 0), confidence around the threshold, two poses."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 3.0, (N, H, W)).astype(np.float32)
    depth[0, 5, 5] = 0.0
    K = np.zeros((N, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 30.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2, H / 2, 1.0
    E = np.tile(np.eye(4, dtype=np.float32)[:3], (N, 1, 1))
    E[1, :3, 3] = [0.3, -0.1, 0.2]
    imgs = (rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8) if images == "uint8"
            else rng.uniform(0.0, 1.0, (N, H, W, 3)).astype(np.float32))
    return SimpleNamespace(depth=depth, conf=rng.uniform(0.5, 2.0, (N, H, W)).astype(np.float32),
                           intrinsics=K, extrinsics=E, processed_images=imgs)


def splat_arrays(seed: int, G: int = 57, anisotropic: bool = True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(G, 4)).astype(np.float32)
    return dict(points=rng.normal(size=(G, 3)).astype(np.float32),
                colors=rng.integers(0, 256, (G, 3)).astype(np.uint8),
                scales=rng.uniform(0.01, 0.1, (G, 3) if anisotropic else G).astype(np.float32),
                opacity=rng.uniform(0, 1, G).astype(np.float32),
                rotations=q if anisotropic else None)


class TestGaussianPly:
    @pytest.mark.parametrize("anisotropic", [True, False])
    @pytest.mark.parametrize("float_colors", [False, True])
    def test_export_bytes_and_read_equal_jax(self, tmp_path, anisotropic, float_colors):
        d = splat_arrays(1, anisotropic=anisotropic)
        if float_colors:
            d["colors"] = d["colors"].astype(np.float32) / 255.0
        exp.export_3dgs_ply(tmp_path / "t.ply", d["points"], d["colors"], d["scales"], d["opacity"],
                            rotations=d["rotations"])
        jexp.export_3dgs_ply(tmp_path / "j.ply", d["points"], d["colors"], d["scales"],
                             d["opacity"], rotations=d["rotations"])
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
        for path in ("t.ply", "j.ply"):
            a, b = exp.read_3dgs_ply(tmp_path / path), jexp.read_3dgs_ply(tmp_path / path)
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)

    def test_read_refuses_ascii_and_normalises(self, tmp_path):
        d = splat_arrays(2)
        exp.export_3dgs_ply(tmp_path / "a.ply", **{k: d[k] for k in ("points", "colors", "scales",
                                                                      "opacity", "rotations")})
        blob = (tmp_path / "a.ply").read_bytes()
        (tmp_path / "b.ply").write_bytes(blob.replace(b"binary_little_endian", b"ascii"))
        with pytest.raises(ValueError, match="unsupported"):
            exp.read_3dgs_ply(tmp_path / "b.ply")
        gs = exp.read_3dgs_ply(tmp_path / "a.ply")
        np.testing.assert_allclose(gs["points"], d["points"], atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(gs["rotations"], axis=-1), 1.0, atol=1e-6)


class TestGlb:
    @pytest.mark.parametrize("colors", [True, False])
    @pytest.mark.parametrize("n", [0, 1, 1001])
    def test_write_glb_pointcloud_bytes_equal_jax(self, tmp_path, colors, n):
        rng = np.random.default_rng(n)
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        cols = rng.integers(0, 256, (n, 3)).astype(np.uint8) if colors else None
        exp.write_glb_pointcloud(tmp_path / "t.glb", pts, cols)
        jexp.write_glb_pointcloud(tmp_path / "j.glb", pts, cols)
        assert (tmp_path / "t.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()

    @pytest.mark.parametrize("stride,threshold", [(2, 1.0), (1, 0.8), (3, 1.5)])
    def test_export_glb_bytes_equal_jax(self, tmp_path, stride, threshold):
        p = prediction(3)
        exp.export_glb(p, tmp_path / "t.glb", stride=stride, conf_threshold=threshold)
        jexp.export_glb(p, tmp_path / "j.glb", stride=stride, conf_threshold=threshold)
        blob = (tmp_path / "t.glb").read_bytes()
        assert blob == (tmp_path / "j.glb").read_bytes() and blob[:4] == b"glTF"


class TestSplatsFromPrediction:
    @pytest.mark.parametrize("images", ["uint8", "float"])
    @pytest.mark.parametrize("anisotropic", [True, False])
    def test_arrays_and_ply_equal_jax_numpy_path(self, tmp_path, images, anisotropic):
        p = prediction(4, images)
        kw = dict(stride=2, conf_threshold=1.0, anisotropic=anisotropic)
        a = exp.splats_from_prediction(p, **kw)
        with jax_numpy_path():
            b = jexp.splats_from_prediction(p, **kw)
            n_j = jexp.prediction_to_3dgs(p, tmp_path / "j.ply", **kw)
            n_t = exp.prediction_to_3dgs(p, tmp_path / "t.ply", **kw)
        assert a.keys() == b.keys()
        for key in a:
            if b[key] is None:
                assert a[key] is None
            else:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert n_t == n_j == len(a["points"]) > 0
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()

    def test_splat_frames_and_backprojection_equal_jax(self):
        p = prediction(5)
        pts = exp._backproject_np(p.depth, p.intrinsics, p.extrinsics, stride=1)
        np.testing.assert_array_equal(pts, jexp._backproject_np(p.depth, p.intrinsics, p.extrinsics))
        for a, b in zip(exp._splat_frames(pts), jexp._splat_frames(pts)):
            np.testing.assert_array_equal(a, b)


def read_glb(path) -> tuple[np.ndarray, np.ndarray | None]:
    """Positions (and colors) of a GLB point cloud as ``write_glb_pointcloud``
    lays it out."""
    blob = open(path, "rb").read()
    n_json = struct.unpack_from("<I", blob, 12)[0]
    gltf = json.loads(blob[20:20 + n_json])
    data = blob[20 + n_json + 8:]
    n = gltf["accessors"][0]["count"]
    pts = np.frombuffer(data, np.float32, count=3 * n).reshape(n, 3)
    cols = (np.frombuffer(data, np.uint8, count=3 * n, offset=12 * n).reshape(n, 3)
            if len(gltf["accessors"]) > 1 else None)
    return pts, cols


@pytest.fixture(scope="module")
def tiny_weights():
    jparams = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jget_preset("tiny")))
    net = DA3Net(get_preset("tiny"))
    net.load_state_dict(convert(jparams), strict=True)
    return jparams, net.eval()


class TestInferenceGlb:
    def test_scene_glb_equals_jax_export(self, tmp_path, tiny_weights):
        """``inference(export_format="glb")`` writes the fused cloud of its own
        prediction as ``scene.glb``, as the JAX package's ``_export`` does:
        the same bytes from the same ``Prediction``; and the JAX package's
        own export of the same weights and frames holds the same points
        (within ``tests/test_torch_model.py``'s 1e-4 on the tiny model's
        outputs, times the depth) and colors."""
        from da3slam_tpu.models import da3 as jda3

        jparams, net = tiny_weights
        imgs = np.random.default_rng(8).integers(0, 256, size=(3, 56, 70, 3)).astype(np.uint8)
        pred = DepthAnything3(get_preset("tiny"), net).inference(
            imgs, process_res=70, export_dir=tmp_path / "t", export_format="glb")
        blob = (tmp_path / "t" / "scene.glb").read_bytes()
        assert blob[:4] == b"glTF" and not (tmp_path / "t" / "prediction.npz").exists()
        jda3._export(pred, str(tmp_path / "j"), "glb")
        assert blob == (tmp_path / "j" / "scene.glb").read_bytes()
        JDA3(jget_preset("tiny"), jparams).inference(
            image=imgs, process_res=70, export_dir=str(tmp_path / "jj"), export_format="glb")
        (pt, ct), (pj, cj) = read_glb(tmp_path / "t" / "scene.glb"), read_glb(tmp_path / "jj" / "scene.glb")
        assert len(pt) == len(pj) > 0
        np.testing.assert_allclose(pt, pj, atol=1e-3)
        assert np.abs(ct.astype(int) - cj.astype(int)).max() <= 1
