"""Triangle-mesh extraction from a TSDF grid + mesh PLY export (a numpy
copy of ``da3slam_tpu/inout/mesh.py``; ``tsdf_to_mesh`` and
``tsdf_vertex_normals`` take the port's ``ops/tsdf.py:TSDFGrid`` and move it
to the host).

Marching TETRAHEDRA rather than marching cubes: splitting each cube into
six tetrahedra (Freudenthal split around the main diagonal) reduces the
case analysis to "how many of 4 vertices are inside" — 1-vs-3 emits one
triangle, 2-vs-2 emits two — with no 256-entry connectivity tables to get
wrong, at the cost of a somewhat denser triangulation.  Active cubes
(sign change + all corners observed) are filtered first, so the extractor
touches ~1% of a typical grid.

Triangle orientation is normalised against the SDF gradient (outward =
toward positive SDF), so viewers get consistent normals.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# Freudenthal split: 6 tets per cube, every tet contains the main diagonal
# (corner bit-codes: bit0=x, bit1=y, bit2=z).  Built by walking the three
# axes in each of the 6 orders — the tets tile the cube exactly.
_AXIS_BIT = {0: 1, 1: 2, 2: 4}


def _tet_corner_codes() -> np.ndarray:
    import itertools

    tets = []
    for order in itertools.permutations((0, 1, 2)):
        c = [0]
        acc = 0
        for ax in order:
            acc |= _AXIS_BIT[ax]
            c.append(acc)
        tets.append(c)  # [0, a, a|b, 7]
    return np.asarray(tets, np.int32)  # [6, 4]


_TETS = _tet_corner_codes()
_CORNER_OFFSETS = np.stack(
    [np.array([b & 1, (b >> 1) & 1, (b >> 2) & 1], np.float32) for b in range(8)]
)  # [8, 3] in (x, y, z)


def marching_tetrahedra(
    sdf: np.ndarray,
    origin=(0.0, 0.0, 0.0),
    voxel: float = 1.0,
    level: float = 0.0,
    mask: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Extract the ``level`` iso-surface of ``sdf [X, Y, Z]``.

    ``mask`` (optional, same shape, bool) marks OBSERVED voxels; cubes
    touching unobserved voxels are skipped (no phantom walls at the
    truncation boundary of unseen space).

    Returns ``(vertices [V, 3] world, faces [F, 3] int)`` with deduplicated
    vertices and outward (positive-SDF-side) winding.
    """
    sdf = np.asarray(sdf, np.float32)
    X, Y, Z = sdf.shape
    s = sdf - np.float32(level)

    # --- active-cube filter ------------------------------------------------
    def corners(a):
        return np.stack([
            a[:-1, :-1, :-1], a[1:, :-1, :-1], a[:-1, 1:, :-1], a[1:, 1:, :-1],
            a[:-1, :-1, 1:], a[1:, :-1, 1:], a[:-1, 1:, 1:], a[1:, 1:, 1:],
        ])  # [8, X-1, Y-1, Z-1]  (index = bit code)

    cs = corners(s)
    active = (cs.min(0) < 0.0) & (cs.max(0) >= 0.0)
    if mask is not None:
        active &= corners(np.asarray(mask, bool)).all(0)
    cx, cy, cz = np.nonzero(active)
    if cx.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    base = np.stack([cx, cy, cz], axis=-1).astype(np.float32)  # [A, 3]
    csd = cs[:, cx, cy, cz]  # [8, A] corner sdf of active cubes

    tris = []
    for tet in _TETS:  # 6 tet types, vectorised over active cubes
        sv = csd[tet]  # [4, A]
        pv = base[None] + _CORNER_OFFSETS[tet][:, None, :]  # [4, A, 3] voxel coords
        inside = sv < 0.0  # [4, A]
        n_in = inside.sum(0)

        def edge_point(i, j, sel):
            # zero crossing along edge (i, j): t = s_i / (s_i - s_j)
            a, b = sv[i][sel], sv[j][sel]
            t = a / np.where(np.abs(a - b) < 1e-12, 1e-12, a - b)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return pv[i][sel] * (1 - t) + pv[j][sel] * t

        # -- one vertex on its own side (inside or outside): one triangle --
        for lone_inside in (True, False):
            want = 1 if lone_inside else 3
            for k in range(4):
                lone = inside[k] if lone_inside else ~inside[k]
                sel = (n_in == want) & lone
                if not sel.any():
                    continue
                others = [m for m in range(4) if m != k]
                p = [edge_point(k, m, sel) for m in others]
                tris.append(np.stack(p, axis=1))  # [n, 3, 3]

        # -- two vs two: a quad over four edges → two triangles -------------
        for a in range(4):
            for b in range(a + 1, 4):
                cd = [m for m in range(4) if m not in (a, b)]
                sel = (n_in == 2) & inside[a] & inside[b]
                if not sel.any():
                    continue
                c, d = cd
                pac = edge_point(a, c, sel)
                pad = edge_point(a, d, sel)
                pbc = edge_point(b, c, sel)
                pbd = edge_point(b, d, sel)
                tris.append(np.stack([pac, pad, pbd], axis=1))
                tris.append(np.stack([pac, pbd, pbc], axis=1))

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tri = np.concatenate(tris)  # [T, 3, 3] voxel coords

    # --- consistent outward winding (normal toward positive sdf) ----------
    # sample the sdf gradient at each triangle centroid via central
    # differences on the grid (nearest-voxel; adequate for orientation)
    cen = tri.mean(axis=1)
    grad = _sdf_gradient_at(s, cen)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.sum(nrm * grad, axis=-1) < 0.0
    tri[flip] = tri[flip][:, ::-1]

    # --- dedup vertices ----------------------------------------------------
    flat = tri.reshape(-1, 3)
    key = np.round(flat * 1024.0).astype(np.int64)  # 1/1024-voxel quantum
    _, uniq_idx, inv = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    verts = flat[uniq_idx]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces collapsed by the dedup
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[good]

    verts = verts * np.float32(voxel) + np.asarray(origin, np.float32)
    return verts.astype(np.float32), faces.astype(np.int64)


def _sdf_gradient_at(s: np.ndarray, pos_voxel: np.ndarray) -> np.ndarray:
    """SDF gradient at voxel-space positions via nearest-voxel differences
    with CLAMPED (one-sided at borders) neighbors — ``clip(i, 1, dim-2)``
    would wrap to -1 on 2-voxel-thin grids (numpy's clip returns a_max when
    a_min > a_max) and read unrelated far-side voxels."""
    X, Y, Z = s.shape
    ci = np.round(pos_voxel).astype(np.int64)
    ci = np.clip(ci, 0, np.array([X, Y, Z]) - 1)

    def d(axis, dim):
        ip = np.minimum(ci[:, axis] + 1, dim - 1)
        im = np.maximum(ci[:, axis] - 1, 0)
        hi = list(ci.T)
        lo = list(ci.T)
        hi[axis] = ip
        lo[axis] = im
        return s[tuple(hi)] - s[tuple(lo)]

    return np.stack([d(0, X), d(1, Y), d(2, Z)], axis=-1)


def tsdf_to_mesh(grid, min_weight: float = 1e-6) -> tuple[np.ndarray, np.ndarray]:
    """Extract the zero iso-surface of an ops.tsdf.TSDFGrid."""
    sdf = grid.sdf.cpu().numpy()
    mask = grid.weight.cpu().numpy() > min_weight
    return marching_tetrahedra(
        sdf, origin=grid.origin.cpu().numpy(), voxel=float(grid.voxel), mask=mask
    )


def tsdf_vertex_normals(grid, verts_world: np.ndarray) -> np.ndarray:
    """Unit vertex normals from the SDF gradient (smoother than face
    normals — the standard TSDF practice).  Nearest-voxel central
    differences; sign points outward (toward positive SDF)."""
    s = grid.sdf.cpu().numpy()
    pos = (np.asarray(verts_world) - grid.origin.cpu().numpy()) / float(grid.voxel)
    n = _sdf_gradient_at(s, pos)
    return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            ).astype(np.float32)


def write_mesh_ply(
    path: str | Path,
    vertices: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None = None,
    normals: np.ndarray | None = None,
) -> None:
    """Binary little-endian PLY with a face element (loads in MeshLab /
    Open3D / Blender)."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    n, f = len(vertices), len(faces)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    fields = [("p", "<f4", 3)]
    if normals is not None:
        header += ["property float nx", "property float ny",
                   "property float nz"]
        fields.append(("nrm", "<f4", 3))
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        fields.append(("c", "u1", 3))
    header += [f"element face {f}",
               "property list uchar int vertex_indices", "end_header"]

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        rec = np.zeros(n, dtype=fields)
        rec["p"] = vertices
        if normals is not None:
            rec["nrm"] = np.ascontiguousarray(normals, np.float32)
        if colors is not None:
            rec["c"] = np.ascontiguousarray(colors, np.uint8)
        fh.write(rec.tobytes())
        rec_f = np.zeros(f, dtype=[("n", "u1"), ("i", "<i4", 3)])
        rec_f["n"] = 3
        rec_f["i"] = faces
        fh.write(rec_f.tobytes())


def read_mesh_ply(
    path: str | Path, with_colors: bool = False
) -> tuple[np.ndarray, ...]:
    """Read back a mesh written by :func:`write_mesh_ply`.

    Returns ``(vertices, faces)`` or, with ``with_colors=True``,
    ``(vertices, faces, colors-or-None)``."""
    blob = Path(path).read_bytes()
    end = blob.index(b"end_header\n") + len(b"end_header\n")
    head = blob[:end].decode("ascii").splitlines()
    n = int(next(l.split()[2] for l in head if l.startswith("element vertex")))
    f = int(next(l.split()[2] for l in head if l.startswith("element face")))
    has_color = any("uchar red" in l for l in head)
    has_normals = any("float nx" in l for l in head)
    body = blob[end:]
    fields = [("p", "<f4", 3)]
    if has_normals:
        fields.append(("nrm", "<f4", 3))
    if has_color:
        fields.append(("c", "u1", 3))
    vdt = np.dtype(fields)
    verts = np.frombuffer(body, vdt, count=n)
    fdt = np.dtype([("n", "u1"), ("i", "<i4", 3)])
    faces = np.frombuffer(body[n * vdt.itemsize:], fdt, count=f)
    out = (verts["p"].copy(), faces["i"].astype(np.int64))
    if with_colors:
        out += (verts["c"].copy() if has_color else None,)
    return out
