"""The port's host C++ point-cloud library (``da3slam_tpu_torch/native/``)
against the JAX package's (``da3slam_tpu/native/``), ``tests/test_native.py``
mirrored.

Both libraries are the same source built with the same flags, so their
outputs are bit-equal: voxel grids, binary PLY bytes, 3DGS PLY bytes.  Each
is also held to its package's numpy path: the PLY bytes exactly, the voxel
grid within 1e-4 (other summation order; the same bound as the JAX test),
the 3DGS records within 5e-6 (the C++ pass contracts multiply-adds; the
JAX test's bound), colours from float images within the uint8 step.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import da3slam_tpu.native as jnative
import da3slam_tpu_torch.native as native
from da3slam_tpu.inout import export3d as jexp
from da3slam_tpu.inout import ply as jply
from da3slam_tpu_torch.inout import export3d as exp
from da3slam_tpu_torch.inout import ply

ROOT = Path(__file__).resolve().parents[1]
GS_TOL = 5e-6


@contextlib.contextmanager
def numpy_path(*mods):
    """The given packages' native modules switched off (their numpy paths)."""
    saved = [(m, m._lib, m._load_failed) for m in mods]
    for m in mods:
        m._lib, m._load_failed = None, True
    try:
        yield
    finally:
        for m, lib, failed in saved:
            m._lib, m._load_failed = lib, failed


def canon(a):
    return a[np.lexsort(a.T)]


def prediction(seed=7, N=3, H=40, W=36, images="uint8"):
    """``tests/test_native.py``'s prediction: random depth (one pixel at 0),
    confidence around the threshold, a moved second camera."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 3.0, (N, H, W)).astype(np.float32)
    depth[0, 5, 5] = 0.0
    K = np.zeros((N, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 30.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2, H / 2, 1.0
    E = np.tile(np.eye(4, dtype=np.float32)[:3], (N, 1, 1))
    E[min(1, N - 1), :3, 3] = [0.3, -0.1, 0.2]
    imgs = (rng.integers(0, 255, (N, H, W, 3), dtype=np.uint8) if images == "uint8"
            else rng.uniform(0.0, 1.0, (N, H, W, 3)).astype(np.float32))
    return SimpleNamespace(depth=depth, conf=rng.uniform(0.5, 2.0, (N, H, W)).astype(np.float32),
                           intrinsics=K, extrinsics=E, processed_images=imgs)


class TestBuild:
    def test_builds_and_loads_under_its_own_name(self):
        assert native.is_available(), "g++ is present: the library must build"
        path = native.library_path()
        assert path.exists() and path.parent == ROOT / "build" / "da3slam_tpu_torch"
        assert path.name.startswith("pointcloud_") and "libda3pc" not in path.name
        assert native.build_command(path)[:5] == ["g++", "-O3", "-march=native", "-shared",
                                                  "-fPIC"]

    def test_source_is_the_jax_packages_below_the_header(self):
        ours = (ROOT / "da3slam_tpu_torch/native/src/pointcloud.cpp").read_text()
        theirs = (ROOT / "da3slam_tpu/native/src/pointcloud.cpp").read_text()
        body = ours[ours.index("#include"):]
        assert body == theirs[theirs.index("#include"):]

    def test_a_fresh_process_maps_the_ports_library_only(self, tmp_path):
        code = ("import numpy as np\n"
                "from da3slam_tpu_torch.inout import export3d, ply\n"
                f"ply.write_ply(r'{tmp_path / 'a.ply'}', np.zeros((4, 3), np.float32))\n"
                f"ply.read_ply(r'{tmp_path / 'a.ply'}')\n"
                "maps = open('/proc/self/maps').read()\n"
                "print('pointcloud_' in maps, 'libda3pc' in maps)")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, check=True, timeout=120).stdout.split()
        assert out == ["True", "False"]


class TestVoxelDownsample:
    def test_equal_to_jax_native_and_numpy(self):
        rng = np.random.default_rng(0)
        pts = rng.uniform(-1, 1, size=(5000, 3)).astype(np.float32)
        cols = rng.integers(0, 255, (5000, 3), dtype=np.uint8)
        a_pts, a_cols = native.voxel_downsample(pts, cols, voxel=0.2)
        b_pts, b_cols = jnative.voxel_downsample(pts, cols, voxel=0.2)
        np.testing.assert_array_equal(a_pts, b_pts)
        np.testing.assert_array_equal(a_cols, b_cols)
        with numpy_path(native, jnative):
            f_pts, f_cols = native.voxel_downsample(pts, cols, voxel=0.2)
            g_pts, g_cols = jnative.voxel_downsample(pts, cols, voxel=0.2)
        np.testing.assert_array_equal(f_pts, g_pts)
        np.testing.assert_array_equal(f_cols, g_cols)
        assert a_pts.shape == f_pts.shape
        np.testing.assert_allclose(canon(a_pts), canon(f_pts), atol=1e-4)

    def test_reduces_count_and_averages(self):
        a = np.full((100, 3), 0.05, np.float32) + np.random.default_rng(1).normal(
            size=(100, 3)).astype(np.float32) * 0.001
        b = a + 5.0
        for path in (contextlib.nullcontext(), numpy_path(native)):
            with path:
                pts, cols = native.voxel_downsample(np.concatenate([a, b]), voxel=1.0)
            assert pts.shape[0] == 2 and cols is None
            centers = pts[np.argsort(pts[:, 0])]
            np.testing.assert_allclose(centers[0], a.mean(0), atol=1e-3)
            np.testing.assert_allclose(centers[1], b.mean(0), atol=1e-3)

    def test_nan_points_dropped(self):
        pts = np.zeros((10, 3), np.float32)
        pts[::2] = np.nan
        for path in (contextlib.nullcontext(), numpy_path(native)):
            with path:
                out, _ = native.voxel_downsample(pts, voxel=0.5)
            assert out.shape[0] == 1 and np.isfinite(out).all()


class TestPly:
    @pytest.mark.parametrize("colors", [True, False])
    def test_write_bytes_equal_jax_native_and_numpy(self, tmp_path, colors):
        rng = np.random.default_rng(2)
        pts = rng.normal(size=(10000, 3)).astype(np.float32)
        cols = rng.integers(0, 255, (10000, 3), dtype=np.uint8) if colors else None
        ply.write_ply(tmp_path / "t.ply", pts, cols)
        jply.write_ply(tmp_path / "j.ply", pts, cols)
        with numpy_path(native):
            ply.write_ply(tmp_path / "n.ply", pts, cols)
        blob = (tmp_path / "t.ply").read_bytes()
        assert blob == (tmp_path / "j.ply").read_bytes() == (tmp_path / "n.ply").read_bytes()

    def test_round_trips_across_readers(self, tmp_path):
        rng = np.random.default_rng(3)
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        cols = rng.integers(0, 255, (100, 3), dtype=np.uint8)
        assert native.write_ply_native(tmp_path / "x.ply", pts, cols)
        for path in (contextlib.nullcontext(), numpy_path(native)):
            with path:
                p2, c2 = ply.read_ply(tmp_path / "x.ply")
            np.testing.assert_array_equal(p2, pts)
            np.testing.assert_array_equal(c2, cols)
        np.testing.assert_array_equal(native.read_ply_native(tmp_path / "x.ply")[0], pts)

    def test_no_color_and_ascii(self, tmp_path):
        pts = np.arange(30, dtype=np.float32).reshape(10, 3)
        ply.write_ply(tmp_path / "m.ply", pts)
        p2, c2 = ply.read_ply(tmp_path / "m.ply")
        np.testing.assert_array_equal(p2, pts)
        assert c2 is None
        ply.write_ply(tmp_path / "a.ply", pts, binary=False)
        assert native.read_ply_native(tmp_path / "a.ply") is None  # the reader falls back
        np.testing.assert_array_equal(ply.read_ply(tmp_path / "a.ply")[0], pts)


class TestSplats:
    @pytest.mark.parametrize("images", ["uint8", "float"])
    def test_3dgs_bytes_equal_jax_native(self, tmp_path, images):
        p = prediction(images=images)
        n_t = exp.prediction_to_3dgs(p, tmp_path / "t.ply", conf_threshold=1.0)
        n_j = jexp.prediction_to_3dgs(p, tmp_path / "j.ply", conf_threshold=1.0)
        assert n_t == n_j > 0
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()

    @pytest.mark.parametrize("images", ["uint8", "float"])
    def test_3dgs_native_matches_numpy_path(self, tmp_path, images):
        p = prediction(seed=11, images=images)
        n_native = exp.prediction_to_3dgs(p, tmp_path / "n.ply", conf_threshold=1.0)
        with numpy_path(native):
            n_py = exp.prediction_to_3dgs(p, tmp_path / "p.ply", conf_threshold=1.0)
        assert n_native == n_py > 0
        a, b = exp.read_3dgs_ply(tmp_path / "n.ply"), exp.read_3dgs_ply(tmp_path / "p.ply")
        assert a["colors"].max() > 0.5
        color_tol = 0.5 / 255 + 1e-6 if images == "float" else GS_TOL
        np.testing.assert_allclose(a["colors"], b["colors"], atol=color_tol)
        for key in ("points", "scales", "opacity", "rotations"):
            np.testing.assert_allclose(a[key], b[key], atol=GS_TOL, err_msg=key)

    def test_isotropic_takes_the_numpy_path(self, tmp_path):
        p = prediction()
        exp.prediction_to_3dgs(p, tmp_path / "t.ply", anisotropic=False)
        with numpy_path(native, jnative):
            jexp.prediction_to_3dgs(p, tmp_path / "j.ply", anisotropic=False)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()

    def test_no_native_fallback_backprojects_once(self, monkeypatch, tmp_path):
        p = prediction(seed=5, N=1, H=16, W=16)
        calls = []
        orig = exp._backproject_np
        monkeypatch.setattr(exp, "_backproject_np",
                            lambda *a, **k: calls.append(1) or orig(*a, **k))
        with numpy_path(native):
            assert exp.prediction_to_3dgs(p, tmp_path / "f.ply", conf_threshold=1.0) > 0
        assert len(calls) == 1
