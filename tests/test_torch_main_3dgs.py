"""The port's ``cli/main_3dgs`` and ``cli/render`` against the JAX package's
CLIs on the CPU (``--device cpu``).

``main_3dgs`` runs over ``utils/synthetic.py``'s model (as
``tests/test_torch_tsdf.py`` runs ``main_mesh``): the chunked alignment of
both packages agrees to ~1e-6, so the plain exports agree in splat count and
field by field within 1e-4.  The optimisation passes start where their
gradients are noise: each splat sits on its own view's depth with its own
pixel's color (zero residuals), and the planes of the synthetic world give
many splats one depth, which ``lax.sort`` orders as it likes.  Adam turns such
noise into whole steps, so ``--refine_iters`` and ``--train_iters`` are held
to the most two Adam runs can part (each step moves a parameter by at most
1.003 × its learning rate, by Cauchy-Schwarz over the bias-corrected
moments: 2.02 × steps × lr, mapped through the stored activation), and
the median splat to ``MEDIAN_TOL``.  ``render``'s frames agree within 1 LSB
on at least 99.9% of their pixels.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from da3slam_tpu.cli import main_3dgs as jmain_3dgs
from da3slam_tpu.cli import render as jrender
from da3slam_tpu.inout import export3d as jexp
from da3slam_tpu.models import DepthAnything3 as JDA3
from da3slam_tpu.utils import synthetic as jsyn
from da3slam_tpu_torch.cli import main_3dgs, render
from da3slam_tpu_torch.inout.export3d import export_3dgs_ply, read_3dgs_ply
from da3slam_tpu_torch.models.da3 import DepthAnything3
from da3slam_tpu_torch.utils import synthetic as syn
from test_torch_export3d import read_glb
from test_torch_rasterize import make_scene

torch.set_num_threads(2)

TOL = {"points": 1e-4, "colors": 1e-4, "scales": 1e-4, "opacity": 1e-4, "rotations": 1e-4}
# the synthetic world: median depth 3.79 (refine's position scale), median
# distance from the centroid 1.39 (train's); sigmoid moves ≤ 1/4 its logit
SCENE_DEPTH, SCENE_SPREAD = 3.8, 1.4


def adam_bound(steps: int, lr: float) -> float:
    return 2.02 * steps * lr


REFINE_TOL = {"points": adam_bound(5, 3e-4 * SCENE_DEPTH), "colors": adam_bound(5, 2e-2),
              "opacity": 0.25 * adam_bound(5, 5e-2), "scales": 1e-4, "rotations": 1e-4}
# scales are compared as logs (Adam steps log σ); quats: a step of each raw
# component, then the normalisation
TRAIN_TOL = {"points": adam_bound(3, 2e-4 * SCENE_SPREAD), "colors": adam_bound(3, 2.5e-2),
             "opacity": 0.25 * adam_bound(3, 5e-2), "scales": adam_bound(3, 5e-3),
             "rotations": 4 * adam_bound(3, 1e-3)}
# colors start at their own pixel, so refine's L1 gradient is sign noise for most
MEDIAN_TOL = {"points": 1e-4, "colors": 1e-4, "scales": 1e-4, "opacity": 1e-4, "rotations": 1e-4}


@pytest.fixture
def synthetic_models(monkeypatch):
    poses = syn.make_trajectory(9)
    fake = syn.SyntheticDA3(poses, textured=True)
    monkeypatch.setattr(DepthAnything3, "from_pretrained", classmethod(lambda cls, *a, **k: fake))
    jfake = jsyn.SyntheticDA3(poses, textured=True)
    monkeypatch.setattr(JDA3, "from_pretrained", classmethod(lambda cls, *a, **k: jfake))


class TestMain3dgsCLI:
    @pytest.mark.parametrize("flags", [
        [],
        ["--glb", "GLB"],
        ["--refine_iters", "5"],
        ["--train_iters", "3", "--densify_every", "2"],
    ], ids=["plain", "glb", "refine", "train_densify"])
    def test_exports_agree_with_jax(self, tmp_path, synthetic_models, flags):
        d = syn.make_synthetic_image_dir(tmp_path, 9)
        flags = [str(tmp_path / "t.glb") if f == "GLB" else f for f in flags]
        common = ["--image_dir", d, "--model", "tiny", "--chunk_size", "4", "--stride", "2"]
        out = main_3dgs.main(common + flags + ["--output", str(tmp_path / "t.ply"),
                                               "--device", "cpu"])
        jflags = [str(tmp_path / "j.glb") if f.endswith("t.glb") else f for f in flags]
        jmain_3dgs.main(common + jflags + ["--output", str(tmp_path / "j.ply")])
        t, j = read_3dgs_ply(tmp_path / "t.ply"), jexp.read_3dgs_ply(tmp_path / "j.ply")
        assert out["n"] == len(t["points"]) == len(j["points"]) > 500
        tol = (TRAIN_TOL if "--train_iters" in flags else
               REFINE_TOL if "--refine_iters" in flags else TOL)
        t["scales"], j["scales"] = np.log(t["scales"]), np.log(j["scales"])
        for key in t:
            assert np.isfinite(t[key]).all()
            np.testing.assert_allclose(t[key], j[key], atol=tol[key], err_msg=key)
            median = 5e-3 if (key == "colors" and "--refine_iters" in flags) else MEDIAN_TOL[key]
            assert np.median(np.abs(t[key] - j[key])) <= median, key
        if "--train_iters" in flags:
            losses = out["train"].numpy()
            assert len(losses) == 3 and np.isfinite(losses).all()
        if "--refine_iters" in flags:
            assert out["refine"].shape == (5,)
        if "--glb" in flags:
            (pt, ct), (pj, cj) = read_glb(tmp_path / "t.glb"), read_glb(tmp_path / "j.glb")
            assert len(pt) == len(pj) > 0
            np.testing.assert_allclose(pt, pj, atol=1e-4)
            np.testing.assert_array_equal(ct, cj)

    def test_missing_cuda_refused(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device runs")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main_3dgs.main(["--image_dir", str(tmp_path)])


def write_scene_and_trajectory(tmp_path):
    """``test_rasterize.py::TestRenderCLI``'s scene (30 splats) as a PLY,
    three c2w poses and the intrinsics file."""
    means, scales, quats, colors, opacity, K, _ = make_scene(10, G=30)
    export_3dgs_ply(tmp_path / "scene.ply", means, colors, scales, opacity, rotations=quats)
    poses = np.stack([np.eye(4)] * 3)
    poses[1, 0, 3] = 0.1
    poses[2, :3, :3] = syn.make_trajectory(3)[2][:3, :3].T
    with open(tmp_path / "camera_poses.txt", "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.8f}" for v in T.reshape(-1)) + "\n")
    (tmp_path / "intrinsic.txt").write_text(f"{K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]}\n")


class TestRenderCLI:
    def test_frames_agree_with_jax(self, tmp_path):
        write_scene_and_trajectory(tmp_path)
        common = ["--splats", str(tmp_path / "scene.ply"), "--poses", str(tmp_path / "camera_poses.txt"),
                  "--intrinsics", str(tmp_path / "intrinsic.txt"), "--height", "64", "--width", "96",
                  "--interp", "2", "--max_per_tile", "64"]
        n = render.main(common + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
        jrender.main(common + ["--output_dir", str(tmp_path / "j")])
        t_files = sorted((tmp_path / "t").glob("*.png"))
        j_files = sorted((tmp_path / "j").glob("*.png"))
        assert n == len(t_files) == len(j_files) == 3 + 2 * 2
        assert [f.name for f in t_files] == [f.name for f in j_files]
        for a, b in zip(t_files, j_files):
            x = np.asarray(Image.open(a)).astype(int)
            y = np.asarray(Image.open(b)).astype(int)
            assert x.shape == y.shape == (64, 96, 3)
            assert (np.abs(x - y) <= 1).mean() >= 0.999
        assert np.asarray(Image.open(t_files[0])).max() > 30

    def test_default_intrinsics_and_stride(self, tmp_path):
        write_scene_and_trajectory(tmp_path)
        common = ["--splats", str(tmp_path / "scene.ply"), "--poses", str(tmp_path / "camera_poses.txt"),
                  "--height", "40", "--width", "56", "--stride", "2", "--bg", "0.2", "0.3", "0.4"]
        assert render.main(common + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"]) == 2
        jrender.main(common + ["--output_dir", str(tmp_path / "j")])
        for name in ("000000.png", "000001.png"):
            x = np.asarray(Image.open(tmp_path / "t" / name)).astype(int)
            y = np.asarray(Image.open(tmp_path / "j" / name)).astype(int)
            assert (np.abs(x - y) <= 1).mean() >= 0.999

    def test_missing_cuda_refused(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device runs")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            render.main(["--splats", "s.ply", "--poses", "p.txt", "--output_dir", str(tmp_path)])
