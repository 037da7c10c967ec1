"""The host C++ point-cloud library with ctypes bindings (counterpart of
``da3slam_tpu/native/__init__.py``).

The port keeps its own copy of the source (``src/pointcloud.cpp``).  It is
built with ``g++ -O3 -march=native`` at first use into
``build/da3slam_tpu_torch/pointcloud_<hash>.so``, keyed by the source, the
command and the host CPU (``-march=native`` code may not run on another CPU,
and a checkout may be copied to another machine with its build directory).
It is written under a temporary name and renamed, so processes that build at
once do not read a half-written file.  Every entry point has a numpy path
for a machine without ``g++``; ``is_available()`` reports whether the
library loaded.  Callers: the binary branch of ``inout/ply.py:write_ply``,
``read_ply`` and the anisotropic branch of
``inout/export3d.py:prediction_to_3dgs``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "src" / "pointcloud.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "da3slam_tpu_torch"
_lock = threading.Lock()
_lib = None
_load_failed = False


def _cpu_signature() -> bytes:
    """The host CPU's model and feature flags (Linux), else the machine name."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine().encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def build_command(out: Path) -> list[str]:
    return ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(_SRC), "-o", str(out)]


def library_path() -> Path:
    """Where the library for this source, command and CPU is built."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(build_command(Path("out"))).encode())
    h.update(_cpu_signature())
    return _BUILD_DIR / f"pointcloud_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    try:
        subprocess.run(build_command(tmp), check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.voxel_downsample.restype = ctypes.c_int64
            lib.voxel_downsample.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.write_ply.restype = ctypes.c_int
            lib.write_ply.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ]
            lib.read_ply.restype = ctypes.c_int64
            lib.read_ply.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.write_3dgs_splats.restype = ctypes.c_int64
            lib.write_3dgs_splats.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ]
            _lib = lib
        except Exception:
            _load_failed = True
        return _lib


def is_available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray | None):
    if a is None:
        return ctypes.POINTER(ctypes.c_uint8)()
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def voxel_downsample(
    points: np.ndarray, colors: np.ndarray | None = None, voxel: float = 0.01
) -> tuple[np.ndarray, np.ndarray | None]:
    """Average points (and colors) per occupied voxel; non-finite points are
    dropped.  Native when available, numpy otherwise.  Output order is
    unspecified (hash order natively, sorted voxel keys in numpy)."""
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.uint8).reshape(-1, 3)

    lib = _load()
    if lib is not None and n > 0:
        out_pts = np.empty_like(points)
        out_cols = np.empty_like(colors) if colors is not None else None
        m = lib.voxel_downsample(
            _fptr(points), _u8ptr(colors), n, ctypes.c_float(voxel),
            _fptr(out_pts), _u8ptr(out_cols),
        )
        if m >= 0:
            return out_pts[:m], (out_cols[:m] if out_cols is not None else None)

    finite = np.isfinite(points).all(axis=1)
    pts = points[finite]
    cols = colors[finite] if colors is not None else None
    if pts.size == 0:
        return pts, cols
    keys = np.floor(pts / voxel).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    m = counts.shape[0]
    out_pts = np.zeros((m, 3), np.float64)
    np.add.at(out_pts, inverse, pts)
    out_pts = (out_pts / counts[:, None]).astype(np.float32)
    out_cols = None
    if cols is not None:
        oc = np.zeros((m, 3), np.float64)
        np.add.at(oc, inverse, cols)
        out_cols = np.clip(oc / counts[:, None] + 0.5, 0, 255).astype(np.uint8)
    return out_pts, out_cols


def write_ply_native(path, points: np.ndarray, colors: np.ndarray | None = None) -> bool:
    """Binary PLY through the C++ writer.  False where the library is absent
    (the caller writes with numpy)."""
    lib = _load()
    if lib is None:
        return False
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.uint8).reshape(-1, 3)
    rc = lib.write_ply(str(path).encode(), _fptr(points), _u8ptr(colors), points.shape[0])
    return rc == 0


def write_3dgs_splats_native(
    path,
    points_grid: np.ndarray,  # [V, H, W, 3] world points (strided grid)
    colors_grid: np.ndarray,  # [V, H, W, 3] uint8
    conf_grid: np.ndarray,  # [V, H, W]
    depth_grid: np.ndarray,  # [V, H, W]
    conf_threshold: float,
    opacity_scale: float,
    max_ratio: float = 8.0,
) -> int | None:
    """The anisotropic splat PLY in one C++ pass (tangent frames, quaternions,
    the filter and the records).  Returns the splat count, or None where the
    library is absent or the shapes disagree (the caller takes the numpy
    path)."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points_grid, np.float32)
    cols = np.ascontiguousarray(colors_grid, np.uint8)
    conf = np.ascontiguousarray(conf_grid, np.float32)
    depth = np.ascontiguousarray(depth_grid, np.float32)
    V, H, W = depth.shape
    if pts.shape != (V, H, W, 3) or cols.shape != (V, H, W, 3):
        return None
    n = lib.write_3dgs_splats(
        str(path).encode(), _fptr(pts), _u8ptr(cols), _fptr(conf),
        _fptr(depth), V, H, W,
        ctypes.c_float(conf_threshold), ctypes.c_float(opacity_scale),
        ctypes.c_float(max_ratio),
    )
    return int(n) if n >= 0 else None


def read_ply_native(path) -> tuple[np.ndarray, np.ndarray | None] | None:
    """Binary PLY through the C++ reader; None where the library is absent
    or the format is one it does not read (the caller parses in Python)."""
    lib = _load()
    if lib is None:
        return None
    probe = lib.read_ply(str(path).encode(), None, None)
    if probe < 0:
        return None
    n, has_color = probe // 2, bool(probe % 2)
    pts = np.empty((n, 3), np.float32)
    cols = np.empty((n, 3), np.uint8) if has_color else None
    got = lib.read_ply(str(path).encode(), _fptr(pts), _u8ptr(cols))
    if got != n:
        return None
    return pts, cols
