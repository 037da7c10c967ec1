"""The port stands alone: importing every ``da3slam_tpu_torch`` module (and
``chip_smoke.py``) pulls in neither JAX nor the JAX package."""

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
             if m == "jax" or m.startswith(("jax.", "jaxlib", "da3slam_tpu.")) or m == "da3slam_tpu")
print(len(names), bad)
"""


def test_no_module_imports_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 42  # every module of the port was imported
    assert out[1:] == ["[]"]


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in
                                        (ROOT / "da3slam_tpu_torch").rglob("*.py"))
                         + ["chip_smoke.py"])
def test_source_names_no_jax_import(path):
    src = (ROOT / path).read_text()
    for banned in ("import jax", "from jax", "from da3slam_tpu.", "import da3slam_tpu\n"):
        assert banned not in src, f"{path} contains {banned!r}"
