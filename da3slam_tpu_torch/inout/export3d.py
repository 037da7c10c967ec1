"""3-D scene export: GLB point clouds and 3D-Gaussian-Splatting PLY
(counterpart of ``da3slam_tpu/inout/export3d.py``).

- :func:`export_glb` — a minimal binary glTF 2.0 writer: one POINTS
  primitive with per-vertex colors.
- :func:`export_3dgs_ply` — the standard 3DGS ``.ply`` layout
  (x y z  nx ny nz  f_dc_0..2  opacity  scale_0..2  rot_0..3): each depth
  pixel becomes a gaussian whose scale is its metric pixel footprint and
  whose opacity comes from the confidence map.

Anisotropic splats go through the port's C++ writer (``native/``) where it
builds, as the JAX package's go through its own; the numpy path stays for a
machine without ``g++``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from da3slam_tpu_torch.inout.trajectory import _rotmat_to_quat_np


# ---------------------------------------------------------------------------
# GLB
# ---------------------------------------------------------------------------

def _pad4(data: bytes, pad: bytes = b"\x00") -> bytes:
    return data + pad * (-len(data) % 4)


def write_glb_pointcloud(path: str | Path, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    bounds_min = points.min(0).tolist() if n else [0.0, 0.0, 0.0]
    bounds_max = points.max(0).tolist() if n else [0.0, 0.0, 0.0]
    buffers = [points.tobytes()]
    accessors = [
        {
            "bufferView": 0,
            "componentType": 5126,  # FLOAT
            "count": n,
            "type": "VEC3",
            "min": bounds_min,
            "max": bounds_max,
        }
    ]
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": len(buffers[0])}]
    attributes = {"POSITION": 0}

    if colors is not None:
        colors = np.ascontiguousarray(colors, np.uint8).reshape(-1, 3)
        # pad RGB to RGBA? glTF allows VEC3 UNSIGNED_BYTE normalized
        offset = sum(len(b) for b in buffers)
        pad = (-colors.nbytes) % 4
        buffers.append(colors.tobytes() + b"\x00" * pad)
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": colors.nbytes})
        accessors.append(
            {
                "bufferView": 1,
                "componentType": 5121,  # UNSIGNED_BYTE
                "normalized": True,
                "count": n,
                "type": "VEC3",
            }
        )
        attributes["COLOR_0"] = 1

    bin_blob = _pad4(b"".join(buffers))
    gltf = {
        # the JAX package's generator name: both write the same bytes
        "asset": {"version": "2.0", "generator": "da3slam_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attributes, "mode": 0}]}],  # POINTS
        "buffers": [{"byteLength": len(bin_blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    json_blob = _pad4(json.dumps(gltf).encode(), b" ")

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)
        f.write(struct.pack("<III", 0x46546C67, 2, total))  # magic "glTF"
        f.write(struct.pack("<II", len(json_blob), 0x4E4F534A))  # JSON
        f.write(json_blob)
        f.write(struct.pack("<II", len(bin_blob), 0x004E4942))  # BIN
        f.write(bin_blob)


def export_glb(prediction, path: str | Path, stride: int = 2, conf_threshold: float = 1.0) -> None:
    """Fused world point cloud of a Prediction → GLB (host-side, see
    ``_backproject_np``)."""
    pts = _backproject_np(
        np.asarray(prediction.depth),
        np.asarray(prediction.intrinsics),
        np.asarray(prediction.extrinsics),
        stride=stride,
    ).reshape(-1, 3)
    cols = np.asarray(prediction.processed_images)
    conf = np.asarray(prediction.conf)
    cols = cols[:, ::stride, ::stride].reshape(-1, 3)
    keep = conf[:, ::stride, ::stride].reshape(-1) >= conf_threshold
    keep &= np.isfinite(pts).all(axis=1)
    write_glb_pointcloud(path, pts[keep], cols[keep])


# ---------------------------------------------------------------------------
# 3D Gaussian Splatting
# ---------------------------------------------------------------------------

_3DGS_PROPS = (
    ["x", "y", "z", "nx", "ny", "nz"]
    + [f"f_dc_{i}" for i in range(3)]
    + ["opacity"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
)

_SH_C0 = 0.28209479177387814  # Y_0^0; color = 0.5 + SH_C0 * f_dc


def export_3dgs_ply(
    path: str | Path,
    points: np.ndarray,  # [N, 3] world positions
    colors: np.ndarray,  # [N, 3] uint8 or float
    scales: np.ndarray,  # [N] isotropic radius, or [N, 3] per-axis radii
    opacity: np.ndarray,  # [N] in (0, 1)
    rotations: np.ndarray | None = None,  # [N, 4] unit quats (w,x,y,z)
) -> None:
    """Write gaussians in the standard INRIA 3DGS PLY layout (binary LE).

    ``scales`` may be per-splat isotropic radii ([N]) or per-axis radii
    ([N, 3]) paired with ``rotations`` — the quaternion whose rotation
    matrix columns are the splat's principal axes (INRIA convention:
    covariance = R diag(s²) Rᵀ)."""
    n = points.shape[0]
    colors = np.asarray(colors, np.float32)
    if colors.size and colors.max() > 1.0:
        colors = colors / 255.0
    f_dc = (colors - 0.5) / _SH_C0
    # stored quantities are pre-activation: log scale, logit opacity
    scales = np.asarray(scales, np.float32)
    if scales.ndim == 1:
        scales = scales[:, None] * np.ones((1, 3), np.float32)
    log_scales = np.log(np.maximum(scales, 1e-8))
    op = np.clip(np.asarray(opacity, np.float32), 1e-4, 1 - 1e-4)
    logit_op = np.log(op / (1 - op))

    data = np.zeros((n, len(_3DGS_PROPS)), np.float32)
    data[:, 0:3] = points
    data[:, 6:9] = f_dc
    data[:, 9] = logit_op
    data[:, 10:13] = log_scales
    if rotations is None:
        data[:, 13] = 1.0  # identity rotation quaternion (w,x,y,z)
    else:
        q = np.asarray(rotations, np.float32)
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        data[:, 13:17] = q

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {p}" for p in _3DGS_PROPS]
    header.append("end_header")

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(data, "<f4").tobytes())


def read_3dgs_ply(path: str | Path) -> dict:
    """Read a 3DGS PLY (ours, or any INRIA-layout file — extra properties
    such as the SH rest coefficients are ignored by name).

    Returns dict(points [N,3], colors [N,3] float in [0,1], scales [N,3],
    opacity [N], rotations [N,4] unit (w,x,y,z)) — activations applied
    (exp / sigmoid / normalize), i.e. ready for ops/rasterize.rasterize.
    """
    blob = Path(path).read_bytes()
    end = blob.index(b"end_header\n") + len(b"end_header\n")
    head = blob[:end].decode("ascii").splitlines()
    fmt = next(l.split()[1] for l in head if l.startswith("format"))
    if fmt != "binary_little_endian":
        raise ValueError(f"{path}: unsupported 3DGS PLY format {fmt!r}")
    n = int(next(l.split()[2] for l in head if l.startswith("element vertex")))
    names = [l.split()[2] for l in head if l.startswith("property")]
    data = np.frombuffer(blob[end:], "<f4", count=n * len(names)).reshape(
        n, len(names))
    col = {name: i for i, name in enumerate(names)}

    def take(*props):
        return np.stack([data[:, col[p]] for p in props], axis=-1)

    points = take("x", "y", "z")
    f_dc = take("f_dc_0", "f_dc_1", "f_dc_2")
    colors = np.clip(0.5 + _SH_C0 * f_dc, 0.0, 1.0)
    scales = np.exp(take("scale_0", "scale_1", "scale_2"))
    opacity = 1.0 / (1.0 + np.exp(-data[:, col["opacity"]]))
    q = take("rot_0", "rot_1", "rot_2", "rot_3")
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return {"points": points, "colors": colors, "scales": scales,
            "opacity": opacity, "rotations": q}


def _splat_frames(
    pts: np.ndarray, max_ratio: float = 8.0
) -> tuple[np.ndarray, np.ndarray]:
    """Surface-aligned splat frames from the world point grid
    ``[..., H, W, 3]`` (optional leading view axis — gradients never cross
    views).

    Tangents are the pixel-space gradients of the world points, so each
    splat's disk lies in the local surface plane (slanted walls get slanted,
    stretched splats instead of view-facing discs); the third axis is the
    surface normal, flattened to a thin pancake.  Anisotropy is capped at
    ``max_ratio`` so depth-discontinuity pixels don't become spears.

    Returns ``(scales [..., H, W, 3], quats [..., H, W, 4] wxyz)``.
    """
    t_v, t_u = np.gradient(pts, axis=(-3, -2))  # [..., H, W, 3] each
    len_u = np.linalg.norm(t_u, axis=-1)
    len_v = np.linalg.norm(t_v, axis=-1)

    e1 = t_u / np.maximum(len_u[..., None], 1e-12)
    n = np.cross(t_u, t_v)
    n_len = np.linalg.norm(n, axis=-1, keepdims=True)
    e3 = n / np.maximum(n_len, 1e-12)
    e2 = np.cross(e3, e1)

    # cap elongation relative to the smaller tangent footprint
    base = np.minimum(len_u, len_v)
    s1 = np.minimum(len_u, max_ratio * np.maximum(base, 1e-12))
    s2 = np.minimum(len_v, max_ratio * np.maximum(base, 1e-12))
    s3 = 0.1 * base  # pancake thickness along the normal
    scales = np.stack([s1, s2, s3], axis=-1)

    R = np.stack([e1, e2, e3], axis=-1)  # columns = principal axes
    # degenerate frames (zero-length tangent / normal) → identity
    ok = (len_u > 1e-12) & (len_v > 1e-12) & (n_len[..., 0] > 1e-12)
    R = np.where(ok[..., None, None], R, np.eye(3, dtype=R.dtype))
    quats = _rotmat_to_quat_np(R)
    return scales.astype(np.float32), quats.astype(np.float32)


def _backproject_np(
    depth: np.ndarray, K: np.ndarray, E: np.ndarray, stride: int = 1
) -> np.ndarray:
    """Host backprojection: ``[N,H,W] depth, [N,3,3] K, [N,3,4] w2c`` →
    world points (mirrors core.geometry.backproject_depth).

    ``stride`` subsamples the pixel grid BEFORE the geometry (the export
    paths only keep every stride-th point; computing then slicing wasted
    stride² of the work).  f32 throughout: this is a leaf export path and
    f32 matches the device math within the tests' 1e-4 (the old f64 pass
    dominated the 3DGS export's wall time)."""
    depth = depth[:, ::stride, ::stride]
    N, H, W = depth.shape
    v, u = np.meshgrid(np.arange(H, dtype=np.float32) * stride,
                       np.arange(W, dtype=np.float32) * stride, indexing="ij")
    fx, fy = K[:, 0, 0], K[:, 1, 1]
    cx, cy = K[:, 0, 2], K[:, 1, 2]
    depth = depth.astype(np.float32, copy=False)
    x = (u[None] - cx[:, None, None].astype(np.float32)) / fx[:, None, None]
    y = (v[None] - cy[:, None, None].astype(np.float32)) / fy[:, None, None]
    cam = np.stack([x * depth, y * depth, depth], axis=-1).astype(np.float32)
    R = E[:, :3, :3].astype(np.float32)
    t = E[:, :3, 3].astype(np.float32)
    # c2w: p_w = Rᵀ (p_c - t), as a batched BLAS matmul — np.einsum's
    # c_einsum path is ~50x slower on this broadcast pattern
    flat = (cam.reshape(N, H * W, 3) - t[:, None, :]) @ R
    return flat.reshape(N, H, W, 3)


def splats_from_prediction(
    prediction,
    stride: int = 2,
    conf_threshold: float = 1.0,
    opacity_scale: float = 0.5,
    anisotropic: bool = True,
) -> dict[str, np.ndarray]:
    """Depth+conf prediction → gaussian attribute arrays (no file IO).

    Returns dict(points [G,3], colors [G,3] uint8, scales [G] or [G,3],
    opacity [G], rotations [G,4] or None) — feed to ``export_3dgs_ply``
    directly or through ``ops.splats.refine_splats`` first."""
    d = _prediction_to_3dgs_arrays(
        prediction, stride, conf_threshold, opacity_scale, anisotropic
    )
    return d


def prediction_to_3dgs(
    prediction,
    path: str | Path,
    stride: int = 2,
    conf_threshold: float = 1.0,
    opacity_scale: float = 0.5,
    anisotropic: bool = True,
) -> int:
    """Depth+conf prediction → 3DGS PLY.

    ``anisotropic=True`` (default) aligns each splat with the local surface
    from depth gradients (tangent-plane disks, thin along the normal);
    ``False`` restores isotropic balls of the metric pixel footprint
    ``stride * z / fx``.  Opacity comes from normalised confidence.
    Returns the number of gaussians written.

    Backprojection runs on the host in numpy (the math of
    ``core.geometry.backproject_depth``): export is an offline host path.
    The anisotropic path goes through the port's C++ writer where it builds
    (``native/src/pointcloud.cpp:write_3dgs_splats``, one pass over the
    grid), else through numpy; float images are quantized to uint8 for the
    C++ layout (at most 0.5/255 in colour from the numpy path)."""
    from da3slam_tpu_torch import native

    if anisotropic and native.is_available():
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        depth = np.asarray(prediction.depth)
        pts_g = _backproject_np(depth, np.asarray(prediction.intrinsics),
                                np.asarray(prediction.extrinsics), stride=stride)
        cols = np.asarray(prediction.processed_images)[:, ::stride, ::stride]
        if cols.dtype != np.uint8:
            # export_3dgs_ply's convention: floats in [0, 1] scale to 0-255,
            # floats already in 0-255 just quantize
            colsf = cols.astype(np.float32)
            if colsf.size and colsf.max() <= 1.0:
                colsf = colsf * 255.0
            cols = np.clip(np.round(colsf), 0, 255).astype(np.uint8)
        conf = np.asarray(prediction.conf)[:, ::stride, ::stride]
        n = native.write_3dgs_splats_native(path, pts_g, cols, conf,
                                            depth[:, ::stride, ::stride], conf_threshold,
                                            opacity_scale)
        if n is not None:
            return n
    d = _prediction_to_3dgs_arrays(
        prediction, stride, conf_threshold, opacity_scale, anisotropic
    )
    export_3dgs_ply(path, d["points"], d["colors"], d["scales"], d["opacity"],
                    rotations=d["rotations"])
    return int(d["points"].shape[0])


def _prediction_to_3dgs_arrays(
    prediction, stride, conf_threshold, opacity_scale, anisotropic
) -> dict[str, np.ndarray]:
    depth = np.asarray(prediction.depth)
    conf = np.asarray(prediction.conf)
    K = np.asarray(prediction.intrinsics)
    # stride inside the backprojection: only 1/stride² of the grid is kept
    pts_g = _backproject_np(depth, K, np.asarray(prediction.extrinsics),
                            stride=stride)
    cols = np.asarray(prediction.processed_images)

    pts_s = pts_g.reshape(-1, 3)
    cols_s = cols[:, ::stride, ::stride].reshape(-1, 3)
    conf_s = conf[:, ::stride, ::stride].reshape(-1)
    d_s = depth[:, ::stride, ::stride].reshape(-1)

    keep = (conf_s >= conf_threshold) & (d_s > 1e-6) & np.isfinite(pts_s).all(axis=1)
    c = conf_s[keep]
    # map confidence to opacity: 1.0 (contract floor) → ~0.27, high conf → ~1
    op = 1.0 - np.exp(-opacity_scale * np.maximum(c - 1.0 + 0.6, 0.0))

    if anisotropic:
        scales, quats = _splat_frames(pts_g)  # batched over views
        scales = scales.reshape(-1, 3)[keep]
        quats = quats.reshape(-1, 4)[keep]
    else:
        fx = K[:, 0, 0][:, None, None]
        radius = stride * depth / fx  # metric footprint of a (strided) pixel
        scales = radius[:, ::stride, ::stride].reshape(-1)[keep]
        quats = None
    return {
        "points": pts_s[keep],
        "colors": cols_s[keep],
        "scales": scales,
        "opacity": op,
        "rotations": quats,
    }
