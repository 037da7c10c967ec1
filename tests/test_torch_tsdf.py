"""The port's TSDF fusion (``ops/tsdf.py``), mesh I/O (``inout/mesh.py``) and
``cli/main_mesh.py`` against the JAX package, and every case of
``tests/test_tsdf.py`` on the port, on the CPU.

Tolerances: sdf and weight within 1e-5, colour within 1e-3 (f32 sums of
0..255 values), bounds within 1e-5.  A voxel reads the pixel ``round(u)``,
and the JAX package may contract ``x/z·fx + cx`` into one rounding where the
port makes two: a voxel whose center projects within ``EDGE`` pixels of a
half-pixel boundary (in f64) can read a neighbouring pixel.  A voxel
outside the tolerance must be such an edge voxel, and those voxels are
counted: at most ``EDGE_SHARE`` of the grid.  The sparse grid is held bit
for bit to the port's own dense ``band_only`` grid.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from da3slam_tpu.cli import main_mesh as jmain_mesh
from da3slam_tpu.inout import mesh as jmesh
from da3slam_tpu.models import DepthAnything3 as JDA3
from da3slam_tpu.ops import tsdf as jtsdf
from da3slam_tpu.utils import synthetic as jsyn
from da3slam_tpu_torch.cli import main_mesh
from da3slam_tpu_torch.inout.mesh import (
    marching_tetrahedra,
    read_mesh_ply,
    tsdf_to_mesh,
    tsdf_vertex_normals,
    write_mesh_ply,
)
from da3slam_tpu_torch.models.da3 import DepthAnything3
from da3slam_tpu_torch.ops import tsdf
from da3slam_tpu_torch.ops.tsdf import (
    estimate_bounds,
    fuse_frames,
    fuse_pipeline_output,
    grid_from_bounds,
    integrate,
    integrate_frames,
    integrate_frames_sparse,
    make_grid,
    vertex_colors,
)
from da3slam_tpu_torch.utils import synthetic as syn

torch.set_num_threads(2)

TOL = 1e-5
COLOR_TOL = 1e-3
EDGE = 1e-4
EDGE_SHARE = 0.01


def T(*arrays):
    out = tuple(torch.as_tensor(np.asarray(a)) for a in arrays)
    return out if len(out) > 1 else out[0]


def grid_np(g) -> dict:
    """A grid of either package as numpy arrays."""
    conv = (lambda a: a.cpu().numpy()) if isinstance(g.sdf, torch.Tensor) else np.asarray
    out = {f: conv(getattr(g, f)) for f in ("sdf", "weight", "origin", "voxel", "trunc")}
    if g.color is not None:
        out["color"] = conv(g.color)
    return out


def edge_voxels(grid, K, E) -> np.ndarray:
    """Voxels whose center projects (in f64) within EDGE pixels of a
    half-pixel boundary in any frame: where a nearest pixel can round
    differently in two libraries."""
    g = grid_np(grid)
    X, Y, Z = g["sdf"].shape
    idx = np.stack(np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij"), -1)
    pts = (idx.reshape(-1, 3).astype(np.float32) * g["voxel"] + g["origin"]).astype(np.float64)
    near = np.zeros(len(pts), bool)
    for k, e in zip(np.asarray(K, np.float64), np.asarray(E, np.float64)):
        cam = pts @ e[:3, :3].T + e[:3, 3]
        z = np.maximum(cam[:, 2], 1e-9)
        for a, f, c in ((cam[:, 0], k[0, 0], k[0, 2]), (cam[:, 1], k[1, 1], k[1, 2])):
            p = a / z * f + c
            near |= np.abs(p - np.floor(p) - 0.5) < EDGE
    return near.reshape(X, Y, Z)


def assert_grids_close(got, ref, near: np.ndarray):
    """sdf/weight within TOL and colour within COLOR_TOL, apart from edge
    voxels, of which at most EDGE_SHARE of the grid break it.  Returns the
    count of voxels that do."""
    a, b = grid_np(got), grid_np(ref)
    for f in ("origin", "voxel", "trunc"):
        np.testing.assert_array_equal(a[f], b[f])
    bad = np.zeros(near.shape, bool)
    for f, tol in (("sdf", TOL), ("weight", TOL), ("color", COLOR_TOL)):
        if f not in b:
            assert f not in a
            continue
        assert a[f].shape == b[f].shape
        diff = np.abs(a[f] - b[f])
        bad_f = diff > tol if diff.ndim == 3 else (diff > tol).any(-1)
        assert not (bad_f & ~near).any(), (f, diff[~near].max())
        bad |= bad_f
    assert bad.mean() <= EDGE_SHARE, bad.mean()
    return int(bad.sum())


def orbit_scene(n=8, hw=(48, 64), seed=7, colors=True):
    K = syn.default_intrinsics(hw)
    poses = syn.make_orbit_trajectory(n).astype(np.float32)
    depth = np.stack([syn.render_depth(E, K, hw, planes=syn.BOX_PLANES) for E in poses])
    rng = np.random.default_rng(seed)
    conf = (1.0 + rng.random(depth.shape)).astype(np.float32)
    Ks = np.repeat(K[None], n, 0).astype(np.float32)
    imgs = rng.integers(0, 256, (n, *hw, 3)).astype(np.float32) if colors else None
    return depth.astype(np.float32), conf, Ks, poses, imgs


BOX = ((-2.1, -2.1, -2.1), (2.1, 2.1, 4.1))


def sphere_sdf(n=40, R=None):
    R = n / 3 if R is None else R
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1).astype(np.float32)
    c = np.array([n / 2] * 3, np.float32)
    return np.linalg.norm(g - c, axis=-1) - R, c, R


def plane_dists(verts, planes, scale=1.0):
    return np.min(np.stack([np.abs(verts @ np.asarray(n) - c * scale) for n, c in planes]), axis=0)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

class TestDenseMatchesJax:
    @pytest.mark.parametrize("colors", [False, True])
    def test_integrate_frames(self, colors):
        """The same explicit grid (bounds passed in) through both packages."""
        depth, conf, Ks, E, imgs = orbit_scene(colors=colors)
        jg = jtsdf.grid_from_bounds(*BOX, 48, with_color=colors)
        tg = grid_from_bounds(*BOX, 48, with_color=colors, device="cpu")
        ref = jtsdf.integrate_frames(jg, depth, conf, Ks, E, images=imgs)
        got = integrate_frames(tg, *T(depth, conf, Ks, E),
                               images=None if imgs is None else T(imgs))
        assert (grid_np(got)["weight"] > 0).mean() > 0.2
        assert_grids_close(got, ref, edge_voxels(tg, Ks, E))

    def test_integrate_band_only_and_max_weight(self):
        depth, conf, Ks, E, _ = orbit_scene(n=3, colors=False)
        jg = jtsdf.grid_from_bounds(*BOX, 32)
        tg = grid_from_bounds(*BOX, 32, device="cpu")
        for i in range(3):
            jg = jtsdf.integrate(jg, depth[i], conf[i], Ks[i], E[i], max_weight=2.5,
                                 band_only=True)
            tg = integrate(tg, *T(depth[i], conf[i], Ks[i], E[i]), max_weight=2.5, band_only=True)
        assert_grids_close(tg, jg, edge_voxels(tg, Ks, E))

    def test_grid_from_bounds_and_estimate_bounds(self):
        depth, _, Ks, E, _ = orbit_scene(colors=False)
        lo, hi = estimate_bounds(*T(depth, Ks, E), resolution=64)
        jlo, jhi = jtsdf.estimate_bounds(depth, Ks, E, resolution=64)
        np.testing.assert_allclose(lo, jlo, atol=TOL, rtol=0)
        np.testing.assert_allclose(hi, jhi, atol=TOL, rtol=0)
        a, b = grid_np(grid_from_bounds(jlo, jhi, 64, device="cpu")), grid_np(
            jtsdf.grid_from_bounds(jlo, jhi, 64))
        assert a["sdf"].shape == b["sdf"].shape
        for f in ("origin", "voxel", "trunc"):
            np.testing.assert_array_equal(a[f], b[f])
        with pytest.raises(ValueError, match="no valid depth"):
            estimate_bounds(*T(np.zeros_like(depth), Ks, E))

    def test_fuse_pipeline_output_dedups_on_the_pipeline(self, tiny_pipeline):
        """The port's run_streaming_slam output (tiny preset, 10 frames,
        windows of 4 sharing one frame): with window_idx, the duplicated
        slots add nothing (the unique frames fused once each on the same
        grid) and the JAX package's fuse_pipeline_output agrees; without it
        the seams double-weight."""
        from da3slam_tpu_torch.slam.pipeline import make_windows

        out, n = tiny_pipeline
        idx, _ = make_windows(n, 4, 1)
        fused = fuse_pipeline_output(out, resolution=24, window_idx=idx)
        assert fused.sdf.device.type == "cpu"
        flat = {f: getattr(out, f).reshape(-1, *getattr(out, f).shape[2:])
                for f in ("depth", "conf", "intrinsics", "extrinsics_global")}
        first = np.unique(idx.reshape(-1), return_index=True)[1]
        lo, hi = estimate_bounds(flat["depth"], flat["intrinsics"], flat["extrinsics_global"],
                                 resolution=24)
        oracle = integrate_frames(grid_from_bounds(lo, hi, 24, device="cpu"),
                                  flat["depth"][first], (flat["conf"][first] - 1.0).clamp_min(0),
                                  flat["intrinsics"][first], flat["extrinsics_global"][first])
        a, b = grid_np(fused), grid_np(oracle)
        assert (b["weight"] > 0).any()
        np.testing.assert_allclose(a["sdf"], b["sdf"], atol=TOL)
        np.testing.assert_allclose(a["weight"], b["weight"], atol=TOL)
        jout = SimpleNamespace(**{f: getattr(out, f).numpy() for f in
                                  ("depth", "conf", "intrinsics", "extrinsics_global")})
        ref = jtsdf.fuse_pipeline_output(jout, resolution=24, window_idx=idx)
        assert_grids_close(fused, ref, edge_voxels(fused, flat["intrinsics"][first],
                                                   flat["extrinsics_global"][first]))
        doubled = grid_np(fuse_pipeline_output(out, resolution=24))
        assert not np.allclose(doubled["weight"], b["weight"], atol=TOL)


@pytest.fixture(scope="module")
def tiny_pipeline():
    """run_streaming_slam over 10 frames, tiny preset, the JAX package's
    seed-0 weights, f32 on the CPU."""
    from da3slam_tpu.models.config import get_preset as jget_preset
    from da3slam_tpu.models.da3 import init_params
    from da3slam_tpu_torch.models.config import get_preset
    from da3slam_tpu_torch.models.convert import convert
    from da3slam_tpu_torch.models.da3 import DA3Net
    from da3slam_tpu_torch.slam.pipeline import run_streaming_slam

    jparams = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jget_preset("tiny")))
    net = DA3Net(get_preset("tiny"))
    net.load_state_dict(convert(jparams), strict=True)
    rng = np.random.default_rng(0)
    base = rng.integers(40, 200, size=(56, 70, 3))
    frames = np.clip(np.stack([np.roll(base, 2 * i, axis=1) + rng.integers(0, 20, (56, 70, 3))
                               for i in range(10)]), 0, 255).astype(np.uint8)
    out = run_streaming_slam(net.eval(), frames, get_preset("tiny"), chunk_size=4, overlap=1,
                             process_hw=(56, 70), dtype=torch.float32)
    return out, 10


class TestSparseMatchesJax:
    @pytest.mark.parametrize("batch", [1, 8])
    @pytest.mark.parametrize("carve", [False, True])
    def test_counts_and_grids(self, batch, carve):
        depth, conf, Ks, E, imgs = orbit_scene()
        jg = jtsdf.grid_from_bounds(*BOX, 48, with_color=True)
        tg = grid_from_bounds(*BOX, 48, with_color=True, device="cpu")
        ref, jc = jtsdf.integrate_frames_sparse(jg, depth, conf, Ks, E, images=imgs,
                                                batch=batch, carve=carve)
        got, tc = integrate_frames_sparse(tg, *T(depth, conf, Ks, E), images=T(imgs),
                                          batch=batch, carve=carve)
        np.testing.assert_array_equal(tc, jc)
        assert tc.shape == (8,) and (tc > 0).all()
        assert_grids_close(got, ref, edge_voxels(tg, Ks, E))

    def test_over_budget_keeps_lowest_block_indices(self):
        """An explicit budget below the active count: the counts are the
        true ones, the grid is the JAX package's, and for one frame the
        blocks written are the lowest-indexed active ones, each equal to the
        dense band-only oracle there."""
        depth, conf, Ks, E, _ = orbit_scene(colors=False)
        jg = jtsdf.grid_from_bounds(*BOX, 48)
        tg = grid_from_bounds(*BOX, 48, device="cpu")
        ref, jc = jtsdf.integrate_frames_sparse(jg, depth, conf, Ks, E, active_blocks=100)
        got, tc = integrate_frames_sparse(tg, *T(depth, conf, Ks, E), active_blocks=100)
        np.testing.assert_array_equal(tc, jc)
        assert tc.max() > 100
        assert_grids_close(got, ref, edge_voxels(tg, Ks, E))

        one, counts = integrate_frames_sparse(tg, *T(depth[7:], conf[7:], Ks[7:], E[7:]),
                                              active_blocks=100)
        assert counts[0] > 100
        bs = 4
        X, Y, Z = tg.sdf.shape
        bdims = (-(-X // bs), -(-Y // bs), -(-Z // bs))
        centers, half, _ = tsdf._block_meta(bdims, bs, tg.voxel, tg.origin)
        d, c, k, e = T(depth[7:], conf[7:], Ks[7:], E[7:])
        active = tsdf._block_activity(centers, half, depth.shape[1:], k, e,
                                      tsdf._depth_minmax_pyramid(d, c),
                                      tsdf._tiles_hw(depth.shape[1:]), tg.trunc)[0]
        kept = torch.zeros_like(active)
        kept[torch.nonzero(active)[:100, 0]] = True
        oracle = integrate(tg, d[0], c[0], k[0], e[0], band_only=True)
        for f, pad in (("sdf", 1.0), ("weight", 0.0)):
            got_b = tsdf._block_layout(getattr(one, f), bs, pad)[:-1]
            ref_b = tsdf._block_layout(getattr(oracle, f), bs, pad)[:-1]
            assert torch.equal(got_b[kept], ref_b[kept])
            assert (got_b[~kept] == pad).all()  # dropped blocks stay pristine
        assert (tsdf._block_layout(one.weight, bs, 0.0)[:-1][kept] > 0).any()
        assert (tsdf._block_layout(oracle.weight, bs, 0.0)[:-1][~kept] > 0).any()


class TestBlockLayout:
    @pytest.mark.parametrize("trail", [(), (4,)])
    def test_round_trip_and_padding(self, trail):
        a = torch.rand(9, 6, 11, *trail)
        for bs, pad in ((4, 1.0), (3, 0.0)):
            b = tsdf._block_layout(a, bs, pad)
            nb = 3 * 2 * 3 if bs == 4 else 3 * 2 * 4
            assert b.shape == (nb + 1, bs**3, *trail)
            assert (b[-1] == pad).all()  # the sentinel's dummy row
            assert torch.equal(tsdf._unblock(b, (9, 6, 11), bs), a)
            full = torch.full((-(-9 // bs) * bs, -(-6 // bs) * bs, -(-11 // bs) * bs, *trail), pad)
            full[:9, :6, :11] = a
            # padding voxels carry the pad value
            assert b[:-1].sum() == pytest.approx(float(full.sum()), rel=1e-6)

    def test_matches_jax_layout(self):
        a = np.random.default_rng(0).random((9, 6, 11, 4)).astype(np.float32)
        np.testing.assert_array_equal(tsdf._block_layout(T(a), 4, 0.0).numpy(),
                                      np.asarray(jtsdf._block_layout(a, 4, 0.0)))
        rng = np.random.default_rng(1)
        depth = np.where(rng.random((37, 150)) < 0.2, 0.0, rng.random((37, 150)) * 5).astype(
            np.float32)
        conf = rng.random((37, 150)).astype(np.float32) - 0.1
        pyr, tiles = jtsdf._depth_minmax_pyramid(depth, conf)
        assert tsdf._tiles_hw(depth.shape) == tiles
        np.testing.assert_array_equal(tsdf._depth_minmax_pyramid(*T(depth[None], conf[None]))[0]
                                      .numpy(), np.asarray(pyr))


# ---------------------------------------------------------------------------
# mesh I/O: the numpy copy against the original
# ---------------------------------------------------------------------------

class TestMeshHostIO:
    @pytest.mark.parametrize("extras", ["none", "colors", "normals", "both"])
    def test_ply_byte_identical(self, tmp_path, extras):
        sdf, _, _ = sphere_sdf(24)
        mask = np.ones(sdf.shape, bool)
        mask[:3] = False
        tg = make_grid((0.5, -1.0, 2.0), sdf.shape, 0.25, device="cpu")._replace(
            sdf=torch.from_numpy(sdf), weight=torch.from_numpy(mask.astype(np.float32)))
        jg = jtsdf.make_grid((0.5, -1.0, 2.0), sdf.shape, 0.25)._replace(
            sdf=jax.numpy.asarray(sdf), weight=jax.numpy.asarray(mask.astype(np.float32)))
        verts, faces = tsdf_to_mesh(tg)
        jverts, jfaces = jmesh.tsdf_to_mesh(jg)
        np.testing.assert_array_equal(verts, jverts)
        np.testing.assert_array_equal(faces, jfaces)
        rng = np.random.default_rng(1)
        cols = rng.integers(0, 256, (len(verts), 3)).astype(np.uint8) \
            if extras in ("colors", "both") else None
        nrm = tsdf_vertex_normals(tg, verts) if extras in ("normals", "both") else None
        if nrm is not None:
            np.testing.assert_array_equal(nrm, jmesh.tsdf_vertex_normals(jg, verts))
        write_mesh_ply(tmp_path / "t.ply", verts, faces, colors=cols, normals=nrm)
        jmesh.write_mesh_ply(tmp_path / "j.ply", jverts, jfaces, colors=cols, normals=nrm)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
        for with_colors in (False, True):
            for a, b in zip(read_mesh_ply(tmp_path / "t.ply", with_colors=with_colors),
                            jmesh.read_mesh_ply(tmp_path / "t.ply", with_colors=with_colors)):
                if b is None:
                    assert a is None
                else:
                    np.testing.assert_array_equal(a, b)

    def test_vertex_colors_match_jax(self):
        depth, conf, Ks, E, imgs = orbit_scene(n=4)
        tg = integrate_frames(grid_from_bounds(*BOX, 32, with_color=True, device="cpu"),
                              *T(depth, conf, Ks, E), images=T(imgs))
        verts, _ = tsdf_to_mesh(tg)
        jg = jtsdf.make_grid(grid_np(tg)["origin"], tg.sdf.shape, float(tg.voxel),
                             with_color=True)._replace(color=jax.numpy.asarray(tg.color.numpy()))
        np.testing.assert_array_equal(vertex_colors(tg, verts), jtsdf.vertex_colors(jg, verts))


# ---------------------------------------------------------------------------
# tests/test_tsdf.py's cases on the port
# ---------------------------------------------------------------------------

class TestMarchingTetrahedra:
    def test_sphere_surface_accuracy(self):
        sdf, c, R = sphere_sdf(40)
        verts, faces = marching_tetrahedra(sdf)
        assert len(verts) > 500 and len(faces) > 1000
        r = np.linalg.norm(verts - c, axis=-1)
        assert np.abs(r - R).max() < 0.3 and np.abs(r - R).mean() < 0.05

    def test_watertight_and_oriented(self):
        sdf, c, R = sphere_sdf(40)
        verts, faces = marching_tetrahedra(sdf)
        v = verts[faces] - c
        vol = np.sum(np.einsum("ij,ij->i", v[:, 0], np.cross(v[:, 1], v[:, 2]))) / 6.0
        assert 0.95 < vol / (4 / 3 * np.pi * R**3) < 1.05

    def test_origin_and_voxel_scaling(self):
        sdf, c, R = sphere_sdf(32)
        verts, _ = marching_tetrahedra(sdf, origin=(1.0, 2.0, 3.0), voxel=0.5)
        r = np.linalg.norm(verts - (c * 0.5 + [1, 2, 3]), axis=-1)
        np.testing.assert_allclose(r, R * 0.5, atol=0.2)

    def test_mask_and_empty(self):
        sdf, c, R = sphere_sdf(32)
        mask = np.zeros(sdf.shape, bool)
        mask[: sdf.shape[0] // 2] = True
        verts, _ = marching_tetrahedra(sdf, mask=mask)
        assert len(verts) > 0 and verts[:, 0].max() <= sdf.shape[0] // 2
        verts, faces = marching_tetrahedra(np.ones((8, 8, 8), np.float32))
        assert len(verts) == 0 and len(faces) == 0


class TestTSDFIntegrate:
    def _plane_frame(self, d=2.0, hw=(32, 40)):
        H, W = hw
        depth = np.full((H, W), d, np.float32)
        conf = np.ones((H, W), np.float32)
        K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
        E = np.eye(4, dtype=np.float32)[:3]
        return depth, conf, K, E

    def test_zero_crossing_at_plane(self):
        depth, conf, K, E = self._plane_frame(d=2.0)
        grid = make_grid((-0.2, -0.2, 1.5), (8, 8, 24), voxel=0.05, device="cpu")
        g = grid_np(integrate(grid, *T(depth, conf, K, E)))
        zs = g["origin"][2] + np.arange(24) * 0.05
        col = g["sdf"][4, 4, :]
        assert (g["weight"][4, 4, :] > 0).any()
        assert (col[zs < 1.9] > 0).all()
        assert (col[(zs > 2.05) & (zs < 2.0 + 3 * 0.05)] < 0).all()

    def test_occluded_voxels_not_updated(self):
        depth, conf, K, E = self._plane_frame(d=2.0)
        grid = make_grid((-0.1, -0.1, 2.5), (4, 4, 8), voxel=0.1, device="cpu")
        g = grid_np(integrate(grid, *T(depth, conf, K, E)))
        np.testing.assert_array_equal(g["weight"], 0.0)
        np.testing.assert_array_equal(g["sdf"], 1.0)

    def test_weight_accumulates_and_caps(self):
        depth, conf, K, E = self._plane_frame()
        grid = make_grid((-0.2, -0.2, 1.5), (8, 8, 16), voxel=0.05, device="cpu")
        stack = lambda a, n: np.repeat(a[None], n, axis=0)  # noqa: E731
        w = grid_np(integrate_frames(grid, *T(stack(depth, 5), stack(conf, 5), stack(K, 5),
                                              stack(E, 5)), max_weight=3.0))["weight"]
        assert w.max() == pytest.approx(3.0)

    def test_fuse_pipeline_output_dedups_window_overlap(self):
        depth, conf, K, E = self._plane_frame(d=2.0)
        depths = np.repeat(depth[None], 5, 0)
        confs = np.stack([conf * (1.0 + 0.1 * i) for i in range(5)]) + 1.0
        Ks, Es = np.repeat(K[None], 5, 0), np.repeat(E[None], 5, 0)
        window_idx = np.array([[0, 1, 2], [2, 3, 4]])
        w = window_idx.reshape(-1)
        out = SimpleNamespace(
            depth=T(depths[w].reshape(2, 3, *depth.shape)),
            conf=T(confs[w].reshape(2, 3, *conf.shape)),
            intrinsics=T(Ks[w].reshape(2, 3, 3, 3)),
            extrinsics_global=T(Es[w].reshape(2, 3, 3, 4)))
        fused = grid_np(fuse_pipeline_output(out, resolution=24, window_idx=window_idx))
        oracle = grid_np(fuse_frames(depths, confs, Ks, Es, resolution=24, device="cpu"))
        np.testing.assert_allclose(fused["sdf"], oracle["sdf"], atol=TOL)
        np.testing.assert_allclose(fused["weight"], oracle["weight"], atol=TOL)
        doubled = grid_np(fuse_pipeline_output(out, resolution=24))
        assert not np.allclose(doubled["weight"], oracle["weight"], atol=TOL)

    def test_fuse_frames_and_mesh_recovers_plane(self):
        K = np.array([[40.0, 0, 20], [0, 40.0, 16], [0, 0, 1]], np.float32)
        E = np.repeat(np.eye(4, dtype=np.float32)[:3][None], 3, 0)
        E[:, 0, 3] = (-0.1, 0.0, 0.1)
        depth = np.full((3, 32, 40), 2.0, np.float32)
        conf = np.full(depth.shape, 2.0, np.float32)
        grid = fuse_frames(depth, conf, np.repeat(K[None], 3, 0), E, resolution=48,
                           device="cpu")
        verts, _ = tsdf_to_mesh(grid)
        assert len(verts) > 100
        np.testing.assert_allclose(verts[:, 2], 2.0, atol=0.1)

    def test_corner_room_world(self):
        hw = (40, 48)
        K = syn.default_intrinsics(hw)
        poses = syn.make_trajectory(6)
        depth = np.stack([syn.render_depth(E, K, hw) for E in poses])
        conf = np.full(depth.shape, 2.0, np.float32)
        grid = fuse_frames(depth, conf, np.repeat(K[None], 6, 0).astype(np.float32),
                           poses.astype(np.float32), resolution=64, device="cpu")
        verts, _ = tsdf_to_mesh(grid)
        assert len(verts) > 500
        assert np.quantile(plane_dists(verts, syn.PLANES), 0.95) < 1.5 * float(grid.voxel)


class TestSparseFusion:
    def _frames(self, n=4, hw=(32, 40)):
        K = syn.default_intrinsics(hw)
        poses = syn.make_trajectory(n)
        depth = np.stack([syn.render_depth(E, K, hw) for E in poses]).astype(np.float32)
        conf = 1.0 + np.random.default_rng(7).random(depth.shape).astype(np.float32)
        return depth, conf, np.repeat(K[None], n, 0).astype(np.float32), poses.astype(np.float32)

    def test_bit_equal_to_band_only_dense(self):
        """The port's sparse grid IS its dense band-only grid, bit for bit
        (the same roundings in the same order), at batch 1 and 4, with
        colour; and the sparse grid on the JAX package's within TOL."""
        depth, conf, Ks, E = self._frames()
        imgs = np.random.default_rng(2).integers(0, 256, (*depth.shape, 3)).astype(np.float32)
        grid = make_grid((-0.9, -0.9, 0.4), (20, 20, 24), voxel=0.14, with_color=True,
                         device="cpu")
        oracle = grid
        for i in range(len(depth)):
            oracle = integrate(oracle, *T(depth[i], conf[i], Ks[i], E[i]), image=T(imgs[i]),
                               band_only=True)
        for batch in (1, 4):
            fused, counts = integrate_frames_sparse(grid, *T(depth, conf, Ks, E),
                                                    images=T(imgs), batch=batch)
            for f in ("sdf", "weight", "color"):
                assert torch.equal(getattr(fused, f), getattr(oracle, f)), (batch, f)
            assert counts.shape == (len(depth),) and (counts > 0).all()

    def test_rounding_margin_at_tile_boundary(self):
        H = W = 64
        depth = np.full((H, W), 10.0, np.float32)
        depth[:, 32:] = 2.0
        conf = np.ones((H, W), np.float32)
        K = np.array([[64.0, 0, 32.0], [0, 64.0, 32.0], [0, 0, 1]], np.float32)
        E = np.eye(4, dtype=np.float32)[:3]
        grid = make_grid((-0.014, -0.256, 1.9955), (4, 4, 4), voxel=0.003, device="cpu")
        oracle = integrate(grid, *T(depth, conf, K, E), band_only=True)
        assert int((oracle.weight > 0).sum()) > 0
        fused, counts = integrate_frames_sparse(grid, *T(depth[None], conf[None], K[None],
                                                         E[None]))
        assert int(counts[0]) > 0
        assert torch.equal(fused.sdf, oracle.sdf) and torch.equal(fused.weight, oracle.weight)

    def test_empty_frame_stack_is_noop(self):
        grid = make_grid((0, 0, 0), (8, 8, 8), voxel=0.1, device="cpu")
        z = np.zeros
        fused, counts = integrate_frames_sparse(grid, *T(z((0, 16, 16), np.float32),
                                                         z((0, 16, 16), np.float32),
                                                         z((0, 3, 3), np.float32),
                                                         z((0, 3, 4), np.float32)))
        assert counts.shape == (0,)
        assert torch.equal(fused.sdf, grid.sdf) and torch.equal(fused.weight, grid.weight)

    def test_band_only_skips_far_free_space(self):
        depth = np.full((24, 32), 3.0, np.float32)
        conf = np.ones((24, 32), np.float32)
        K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
        E = np.eye(4, dtype=np.float32)[:3]
        grid = make_grid((-0.3, -0.3, 0.5), (8, 8, 10), voxel=0.11, device="cpu")
        sp, _ = integrate_frames_sparse(grid, *T(depth[None], conf[None], K[None], E[None]))
        assert (sp.weight == 0).all() and (sp.sdf == 1).all()
        assert (integrate(grid, *T(depth, conf, K, E)).weight > 0).any()

    def test_budget_overflow_warns(self):
        import warnings

        depth, conf, Ks, E = self._frames()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fuse_frames(depth, conf, Ks, E, resolution=24, sparse=True, active_blocks=2,
                        device="cpu")
        assert any("exceed the budget" in str(w.message) for w in rec)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fuse_frames(depth, conf, Ks, E, resolution=24, sparse=True, device="cpu")
        assert not rec

    def test_box_orbit_mesh_on_walls(self):
        hw = (32, 40)
        K = syn.default_intrinsics(hw)
        poses = syn.make_orbit_trajectory(8)
        depth = np.stack([syn.render_depth(E, K, hw, planes=syn.BOX_PLANES) for E in poses])
        conf = np.full(depth.shape, 2.0, np.float32)
        grid = fuse_frames(depth, conf, np.repeat(K[None], 8, 0).astype(np.float32),
                           poses.astype(np.float32), resolution=40, sparse=True, device="cpu")
        verts, _ = tsdf_to_mesh(grid)
        assert len(verts) > 300
        assert np.quantile(plane_dists(verts, syn.BOX_PLANES), 0.95) < 1.5 * float(grid.voxel)


class TestSparseCarving:
    def test_carve_erases_spurious_blob(self):
        n = 6
        K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
        far = np.full((32, 32), 3.0, np.float32)
        blob = far.copy()
        blob[12:20, 12:20] = 1.0
        depth = np.stack([blob] + [far] * (n - 1))
        conf = np.ones(depth.shape, np.float32)
        Ks = np.repeat(K[None], n, 0)
        Es = np.repeat(np.eye(4, dtype=np.float32)[:3][None], n, 0)
        grid = make_grid((-0.25, -0.25, 0.8), (10, 10, 10), voxel=0.05, device="cpu")
        band, _ = integrate_frames_sparse(grid, *T(depth, conf, Ks, Es), batch=1)
        carved, _ = integrate_frames_sparse(grid, *T(depth, conf, Ks, Es), batch=1, carve=True)
        assert band.sdf[band.weight > 0].min() < -0.5
        assert carved.sdf[carved.weight > 0].min() > 0.25
        assert carved.weight.max() > band.weight.max()

    def test_carve_matches_full_dense_on_static_scene(self):
        n = 3
        K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
        depth = np.full((n, 24, 32), 2.0, np.float32)
        conf = 1.0 + np.random.default_rng(3).random(depth.shape).astype(np.float32)
        Ks = np.repeat(K[None], n, 0)
        Es = np.repeat(np.eye(4, dtype=np.float32)[:3][None], n, 0)
        grid = make_grid((-0.4, -0.4, 0.9), (12, 12, 20), voxel=0.07, device="cpu")
        oracle = grid
        for i in range(n):
            oracle = integrate(oracle, *T(depth[i], conf[i], Ks[i], Es[i]))
        for batch in (1, 3):
            fused, counts = integrate_frames_sparse(grid, *T(depth, conf, Ks, Es), batch=batch,
                                                    carve=True)
            w = fused.weight
            np.testing.assert_allclose(fused.sdf.numpy(), oracle.sdf.numpy(), atol=TOL)
            np.testing.assert_allclose(w[w > 0].numpy(), oracle.weight[w > 0].numpy(), atol=TOL)
            assert (fused.sdf[w == 0] == 1.0).all() and (counts > 0).all()

    def test_carve_defaults_off_and_band_unchanged(self):
        n = 4
        K = np.array([[30.0, 0, 12], [0, 30.0, 12], [0, 0, 1]], np.float32)
        far = np.full((24, 24), 3.0, np.float32)
        blob = far.copy()
        blob[4:20, 4:20] = 1.2
        depth = np.stack([blob] + [far] * (n - 1))
        conf = np.ones(depth.shape, np.float32)
        Ks = np.repeat(K[None], n, 0)
        Es = np.repeat(np.eye(4, dtype=np.float32)[:3][None], n, 0)
        kw = dict(resolution=32, sparse=True, conf_floor=0.0, batch=1, device="cpu")
        g_band = fuse_frames(depth, conf, Ks, Es, **kw)
        g_carve = fuse_frames(depth, conf, Ks, Es, carve=True, **kw)
        sb = g_band.sdf[g_band.weight > 0]
        sc = g_carve.sdf[g_carve.weight > 0]
        assert sb.min() < 0.0 and sc.min() > sb.min()


class TestGridFromBounds:
    def test_longest_axis_resolution(self):
        g = grid_from_bounds((0, 0, 0), (2.0, 1.0, 0.5), resolution=100, device="cpu")
        assert tuple(g.sdf.shape[:2]) == (100, 50)
        assert abs(float(g.voxel) - 0.02) < 1e-6


class TestColorFusion:
    def test_colored_plane(self):
        hw = (32, 40)
        K = np.array([[40.0, 0, 20], [0, 40.0, 16], [0, 0, 1]], np.float32)
        E = np.eye(4, dtype=np.float32)[:3]
        depth = np.full(hw, 2.0, np.float32)
        conf = np.full(hw, 2.0, np.float32)
        img = np.zeros((*hw, 3), np.float32)
        img[:, :20, 0] = 200.0
        img[:, 20:, 1] = 200.0
        grid = fuse_frames(depth[None], conf[None], K[None], E[None], resolution=48,
                           images=img[None], device="cpu")
        verts, _ = tsdf_to_mesh(grid)
        assert len(verts) > 50
        cols = vertex_colors(grid, verts)
        assert (cols[verts[:, 0] < -0.05, 0] > 120).mean() > 0.9
        assert (cols[verts[:, 0] > 0.05, 1] > 120).mean() > 0.9


class TestVertexNormals:
    def test_sphere_normals_radial(self, tmp_path):
        sdf, c, R = sphere_sdf(40)
        verts, faces = marching_tetrahedra(sdf)
        grid = make_grid((0, 0, 0), sdf.shape, voxel=1.0, device="cpu")._replace(
            sdf=torch.from_numpy(sdf))
        normals = tsdf_vertex_normals(grid, verts)
        np.testing.assert_allclose(np.linalg.norm(normals, axis=-1), 1.0, atol=1e-5)
        radial = (verts - c) / np.linalg.norm(verts - c, axis=-1, keepdims=True)
        assert np.quantile(np.sum(normals * radial, axis=-1), 0.05) > 0.95
        write_mesh_ply(tmp_path / "m.ply", verts, faces,
                       colors=np.full((len(verts), 3), 99, np.uint8), normals=normals)
        v2, _, c2 = read_mesh_ply(tmp_path / "m.ply", with_colors=True)
        np.testing.assert_allclose(v2, verts, atol=1e-6)
        np.testing.assert_array_equal(c2, 99)


# ---------------------------------------------------------------------------
# cli/main_mesh
# ---------------------------------------------------------------------------

class TestMainMeshCLI:
    @pytest.mark.parametrize("flags", [[], ["--color"], ["--sparse"], ["--sparse", "--carve"]])
    def test_end_to_end_on_the_room_planes(self, tmp_path, monkeypatch, flags):
        """The tiny preset's name with the port's synthetic model standing in
        (random weights have no surface), --device cpu: the mesh lies on the
        chunk-0-scaled room planes; the JAX package's CLI on the same model
        agrees on the vertex count within 2%."""
        poses = syn.make_trajectory(9)
        scales = [1.3, 0.8, 1.1]
        fake = syn.SyntheticDA3(poses, chunk_scales=scales, textured="--color" in flags)
        monkeypatch.setattr(DepthAnything3, "from_pretrained",
                            classmethod(lambda cls, *a, **k: fake))
        jfake = jsyn.SyntheticDA3(poses, chunk_scales=scales, textured="--color" in flags)
        monkeypatch.setattr(JDA3, "from_pretrained", classmethod(lambda cls, *a, **k: jfake))
        d = syn.make_synthetic_image_dir(tmp_path, 9)
        common = ["--image_dir", d, "--model", "tiny", "--chunk_size", "4", "--resolution",
                  "64", "--conf_floor", "1.0"] + flags
        main_mesh.main(common + ["--output", str(tmp_path / "t.ply"), "--device", "cpu"])
        jmain_mesh.main(common + ["--output", str(tmp_path / "j.ply")])
        verts, faces, cols = read_mesh_ply(tmp_path / "t.ply", with_colors=True)
        jverts = jmesh.read_mesh_ply(tmp_path / "j.ply")[0]
        assert len(verts) > 200 and len(faces) > 200 and np.isfinite(verts).all()
        assert faces.max() < len(verts)
        assert abs(len(verts) - len(jverts)) <= 0.02 * len(jverts)
        assert np.quantile(plane_dists(verts, syn.PLANES, scales[0]), 0.9) < 0.15
        if "--color" in flags:
            assert cols is not None and cols.shape == (len(verts), 3) and cols.std() > 1.0
        else:
            assert cols is None

    def test_missing_cuda_refused(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device runs")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main_mesh.main(["--image_dir", str(tmp_path)])
