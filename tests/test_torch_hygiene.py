"""The port stands alone: importing every ``da3slam_tpu_torch`` module (and
``chip_smoke.py``) pulls in neither JAX, nor the JAX package, nor the
``safetensors`` package (the port reads and writes that format itself); no
module reaches the JAX package's native library either (the port's exporters
are its numpy path)."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

IMPORT_ALL = """
import importlib, pkgutil, sys
import da3slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(da3slam_tpu_torch.__path__, "da3slam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "da3slam_tpu", "safetensors")
             or m.startswith(("jax.", "jaxlib", "da3slam_tpu.", "safetensors.")))
print(len(names), bad, ",".join(names))
"""

# the loop-closure and streaming slice: the walk must reach each of its modules
LOOP_SLICE = ("cli.streaming", "ops.posegraph", "slam.evaluate", "slam.loop",
              "slam.online_loop", "slam.streaming", "utils.synthetic")
# the dense-mapping slice: preprocessing and the TSDF mesh
MESH_SLICE = ("cli.main_mesh", "cli.preprocess", "inout.mesh", "ops.tsdf",
              "preprocess.device", "preprocess.host")
# the 3DGS slice: rasterizer, splats, distortion, exporters and their CLIs
GS_SLICE = ("cli.main_3dgs", "cli.render", "core.geometry", "inout.export3d",
            "ops.distortion", "ops.rasterize", "ops.splats")
# the nested tier, the torch-checkpoint import and the parity, confidence and
# evaluation CLIs
NESTED_SLICE = ("cli.evaluate", "cli.main_conf", "cli.parity", "inout.datasets",
                "models.nested", "models.torch_import", "utils.parity", "viz.confidence",
                "viz.debug")
# multi-device SLAM inference: the mesh and launcher, the collectives, ring
# attention, the sp forward, the pp encoder and the pipelines over them
PARALLEL_SLICE = ("parallel.comm", "parallel.mesh", "parallel.pp_forward",
                  "parallel.ring_attention", "parallel.sp_forward", "slam.pipeline")


def test_no_module_imports_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 75  # every module of the port was imported
    assert out[1] == "[]"
    walked = out[2].split(",")
    assert all(f"da3slam_tpu_torch.{m}" in walked
               for m in LOOP_SLICE + MESH_SLICE + GS_SLICE + NESTED_SLICE + PARALLEL_SLICE)


@pytest.mark.parametrize("module", GS_SLICE + NESTED_SLICE + PARALLEL_SLICE)
def test_3dgs_slice_imports_alone(module):
    """Each module of the 3DGS slice, of the nested-tier slice and of the
    multi-device slice, imported by itself in a fresh process, loads neither JAX, nor the JAX package, nor a
    shared library of it."""
    code = (f"import sys, da3slam_tpu_torch.{module}\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'da3slam_tpu') "
            "or m.startswith(('jax.', 'jaxlib', 'da3slam_tpu.')))\n"
            "maps = open('/proc/self/maps').read() if sys.platform == 'linux' else ''\n"
            "print(bad, 'libda3pc' in maps)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split("\n")[0]
    assert out == "[] False"


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in
                                        (ROOT / "da3slam_tpu_torch").rglob("*.py"))
                         + ["chip_smoke.py"])
def test_source_names_no_jax_import(path):
    src = (ROOT / path).read_text()
    for banned in ("import jax", "from jax", "from da3slam_tpu.", "import da3slam_tpu\n",
                   "import safetensors", "from safetensors", "da3slam_tpu.native",
                   "da3slam_tpu import native", "libda3pc"):
        assert banned not in src, f"{path} contains {banned!r}"
