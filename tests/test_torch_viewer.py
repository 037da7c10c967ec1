"""The port's ``SLAMViewer`` (``da3slam_tpu_torch/viz/viewer.py``) against
``da3slam_tpu.viz.viewer`` through ``tests/test_viewer.py``'s structural mock
``viser`` module (neither machine has viser).

Each case of ``tests/test_viewer.py`` runs the same frames through both
viewers, and everything they send is compared: every ``add_point_cloud``
call (names, colours and point sizes exactly; points within 1e-5: both
backproject in f32, in other summation orders, at depths below 3), the
frusta (wxyz and position within 1e-5, fov and aspect within 1e-6, the
thumbnail exactly), the meshes, the GUI handles and the camera poses a
connected client is flown to.  The solvers of both packages then drive
their viewers over the same tiny weights, and both CLIs fall back to
headless with the same message where viser is missing.
"""

from __future__ import annotations

import functools
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import DepthAnything3 as JDA3
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net
from da3slam_tpu_torch.models.da3 import DepthAnything3 as TDA3
from da3slam_tpu_torch.viz import viewer as tviewer

torch.set_num_threads(2)

POINT_TOL = 1e-5
POSE_TOL = 1e-5
ANGLE_TOL = 1e-6
# through the solvers and main_align the points also carry the global poses,
# which agree to 1e-4 (tests/test_torch_slam.py::TestWholeSlice::
# test_both_clis_agree); the points differ by at most 3.5e-5 there
SOLVER_POINT_TOL = 1e-4


def _load_mock():
    spec = importlib.util.spec_from_file_location(
        "jax_test_viewer", Path(__file__).with_name("test_viewer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MOCK = _load_mock()
frame_inputs = MOCK.frame_inputs


class _Camera:
    def __init__(self, log):
        object.__setattr__(self, "log", log)

    def __setattr__(self, name, value):
        self.log.append((name, np.array(value, np.float64)))


class _Client:
    """A connected browser: records every camera pose it is given."""

    def __init__(self):
        self.log = []
        self.camera = _Camera(self.log)

    def atomic(self):
        import contextlib

        return contextlib.nullcontext()


class _Server(MOCK._Server):
    def __init__(self, host, port):
        super().__init__(host, port)
        self.client = _Client()

    def get_clients(self):
        return {0: self.client}


@pytest.fixture()
def viewers():
    """(JAX SLAMViewer, the port's) over the mock viser."""
    fake = types.ModuleType("viser")
    fake.ViserServer = _Server
    sys.modules["viser"] = fake
    sys.modules.pop("da3slam_tpu.viz.viewer", None)
    try:
        from da3slam_tpu.viz.viewer import SLAMViewer

        yield SLAMViewer, functools.partial(tviewer.SLAMViewer, device="cpu")
    finally:
        sys.modules.pop("viser", None)
        sys.modules.pop("da3slam_tpu.viz.viewer", None)


def record(v) -> dict:
    sc = v.server.scene
    return {
        "clouds": [(c.name, c.points, c.colors, c.point_size, c.removed) for c in sc.clouds],
        "frusta": [(f.name, f.fov, f.aspect, f.wxyz, f.position, f.image) for f in sc.frusta],
        "meshes": [{k: val for k, val in m.__dict__.items()} for m in sc.meshes],
        "gui": {k: (h.value, list(h.options)) for k, h in v.server.gui.handles.items()},
        "stride": v._display_stride,
        "kept": [len(p) for p in v.all_points],
        "client": v.server.client.log,
    }


def assert_same_scene(t: dict, j: dict) -> None:
    assert len(t["clouds"]) == len(j["clouds"]) > 0 or not j["clouds"]
    for (tn, tp, tc, ts, tr), (jn, jp, jc, js, jr) in zip(t["clouds"], j["clouds"]):
        assert tn == jn and ts == js and tr == jr
        assert tp.dtype == jp.dtype == np.float32 and tc.dtype == jc.dtype == np.uint8
        assert tp.shape == jp.shape
        np.testing.assert_allclose(tp, jp, atol=POINT_TOL, rtol=0, err_msg=tn)
        np.testing.assert_array_equal(tc, jc, err_msg=tn)
    assert len(t["frusta"]) == len(j["frusta"])
    for (tn, tf, ta, tq, tpos, ti), (jn, jf, ja, jq, jpos, ji) in zip(t["frusta"], j["frusta"]):
        assert tn == jn
        np.testing.assert_allclose([tf, ta], [jf, ja], atol=ANGLE_TOL, rtol=0)
        np.testing.assert_allclose(np.asarray(tq), np.asarray(jq), atol=POSE_TOL, rtol=0)
        np.testing.assert_allclose(np.asarray(tpos), np.asarray(jpos), atol=POSE_TOL, rtol=0)
        np.testing.assert_array_equal(ti, ji)
    assert len(t["meshes"]) == len(j["meshes"])
    for tm, jm in zip(t["meshes"], j["meshes"]):
        assert tm.keys() == jm.keys()
        for k in tm:
            np.testing.assert_array_equal(np.asarray(tm[k]), np.asarray(jm[k]), err_msg=k)
    assert t["gui"] == j["gui"] and t["stride"] == j["stride"] and t["kept"] == j["kept"]
    assert [n for n, _ in t["client"]] == [n for n, _ in j["client"]]
    for (_, a), (_, b) in zip(t["client"], j["client"]):
        np.testing.assert_allclose(a, b, atol=POSE_TOL, rtol=0)


# -- the cases of tests/test_viewer.py, each as a drive of one viewer -------

def _one_frame(v):
    v.add_frame(*frame_inputs())


def _invalid_half(v):
    img, depth, conf, E, K = frame_inputs()
    depth[:12] = 0.0
    v.add_frame(img, depth, conf, E, K)


def _percentile(v):
    v.add_frame(*frame_inputs())
    v.gui_conf_percentile.value = 50
    v.gui_conf_percentile.trigger()


def _frame_filter(v):
    for i in range(3):
        v.add_frame(*frame_inputs(seed=i))
    v.gui_frame_filter.value = "1"
    v.gui_frame_filter.trigger()


def _incremental(v):
    for i in range(4):
        v.add_frame(*frame_inputs(seed=i))


def _budget(v):
    for _ in range(2):
        v.add_frame(*frame_inputs())


def _flythrough(v):
    for i in range(2):
        img, depth, conf, E, K = frame_inputs(seed=i)
        E = E.copy()
        E[0, 3] = float(i)
        v.add_frame(img, depth, conf, E, K)
    v.run_demo_flythrough(interval_s=0.0, steps_per_edge=2)


def _chw_float(v):
    img, depth, conf, E, K = frame_inputs()
    v.add_frame(img.transpose(2, 0, 1) / 255.0, depth, conf, E, K)


MESH = (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32), np.array([[0, 1, 2]], np.int64))


def _mesh_replace(v):
    cols = np.stack([[200, 0, 0], [0, 200, 0], [0, 0, 200]]).astype(np.uint8)
    v.set_mesh(*MESH, colors=cols)
    v.set_mesh(MESH[0] * 2, MESH[1])


def _mesh_simple(v):
    scene_cls = type(v.server.scene)
    saved = scene_cls.add_mesh
    del scene_cls.add_mesh  # an older viser: one colour a mesh
    try:
        v.set_mesh(*MESH, colors=np.full((3, 3), 200, np.uint8))
    finally:
        scene_cls.add_mesh = saved


_N_PER_FRAME = 24 * 32
CASES = {
    "add_frame_builds_cloud_and_frustum": (dict(port=9999, point_stride=2), _one_frame),
    "depth_validity_filter": (dict(port=9999, point_stride=1, min_depth=0.1, max_depth=50),
                              _invalid_half),
    "conf_percentile_slider": (dict(port=9999, point_stride=1), _percentile),
    "frame_filter": (dict(port=9999, point_stride=2), _frame_filter),
    "incremental_sends": (dict(port=9999, point_stride=2), _incremental),
    "point_budget_display_stride": (dict(port=9999, point_stride=1,
                                         max_points=int(_N_PER_FRAME * 1.5)), _budget),
    "flythrough_interpolates_poses": (dict(port=9999, point_stride=4), _flythrough),
    "chw_float_image_accepted": (dict(port=9999), _chw_float),
    "set_mesh_replaces_handle": (dict(port=0), _mesh_replace),
    "set_mesh_falls_back_without_vertex_color_api": (dict(port=0), _mesh_simple),
}


class TestViewerParity:
    @pytest.mark.parametrize("case", list(CASES))
    def test_same_scene_as_jax(self, viewers, case):
        jcls, tcls = viewers
        kw, drive = CASES[case]
        j, t = jcls(**kw), tcls(**kw)
        drive(j)
        drive(t)
        assert_same_scene(record(t), record(j))

    def test_point_size_slider_and_frustum_click(self, viewers):
        """The point-size callback re-sends every frame at the new size; a
        click on a frustum flies the client to that camera."""
        scenes = []
        for cls in viewers:
            v = cls(port=0, point_stride=2)
            for i in range(2):
                img, depth, conf, E, K = frame_inputs(seed=i)
                E = E.copy()
                E[:, 3] = [0.5 * i, -0.2, 0.1]
                v.add_frame(img, depth, conf, E, K)
            v.gui_point_size.value = 0.01
            v.gui_point_size.trigger()
            v.server.scene.frusta[1]._cb(None)
            scenes.append(record(v))
        t, j = scenes[1], scenes[0]
        assert [c[3] for c in t["clouds"][-2:]] == [0.01, 0.01]
        assert [n for n, _ in t["client"]] == ["wxyz", "position"]
        assert_same_scene(t, j)

    def test_batch_equals_frame_by_frame(self, viewers):
        """``add_frames`` (one transfer a batch, as the solver sends a chunk)
        sends what ``add_frame`` a frame at a time sends, tensors or arrays."""
        _, tcls = viewers
        frames = [frame_inputs(seed=i) for i in range(3)]
        one, batch = tcls(port=0, point_stride=2), tcls(port=0, point_stride=2)
        for f in frames:
            one.add_frame(*f)
        batch.add_frames(*(torch.from_numpy(np.stack(x)) for x in zip(*frames)))
        a, b = record(batch), record(one)
        for (_, pa, ca, *_), (_, pb, cb, *_) in zip(a["clouds"], b["clouds"]):
            np.testing.assert_array_equal(pa, pb)
            np.testing.assert_array_equal(ca, cb)
        assert_same_scene(a, b)

    def test_batch_is_one_fetch(self, viewers, monkeypatch):
        _, tcls = viewers
        calls = []
        fetch = tviewer.fetch_packed
        monkeypatch.setattr(tviewer, "fetch_packed", lambda ts: (calls.append(len(ts)),
                                                                fetch(ts))[1])
        frames = [frame_inputs(seed=i) for i in range(4)]
        tcls(port=0).add_frames(*(np.stack(x) for x in zip(*frames)))
        assert calls == [9]

    def test_slerp_equals_jax(self, viewers):
        from da3slam_tpu.viz.viewer import _slerp as jslerp

        rng = np.random.default_rng(3)
        for _ in range(20):
            q0, q1 = (q / np.linalg.norm(q) for q in rng.normal(size=(2, 4)))
            for t in (0.0, 0.3, 1.0):
                np.testing.assert_allclose(tviewer._slerp(q0, q1, t), jslerp(q0, q1, t),
                                           atol=1e-12)
        q = np.array([1.0, 0, 0, 0])
        np.testing.assert_allclose(tviewer._slerp(q, q, 0.5), q)

    def test_flythrough_sleeps_as_jax(self, viewers, monkeypatch):
        """With a real interval, the sleeps (patched to record) are the JAX
        viewer's, and so are the poses."""
        scenes, sleeps = [], []
        for cls, mod in zip(viewers, (sys.modules["da3slam_tpu.viz.viewer"], tviewer)):
            slept = []
            monkeypatch.setattr(mod, "time", types.SimpleNamespace(sleep=slept.append))
            v = cls(port=0, point_stride=4)
            for i in range(3):
                img, depth, conf, E, K = frame_inputs(seed=i)
                E = E.copy()
                E[:, 3] = [float(i), 0.5 * i, 0.0]
                v.add_frame(img, depth, conf, E, K)
            v.run_demo_flythrough(interval_s=0.5, steps_per_edge=3)
            scenes.append(record(v))
            sleeps.append(slept)
        assert sleeps[0] == sleeps[1] == [0.5 / 3] * 6
        assert len(scenes[1]["client"]) == 12
        assert_same_scene(scenes[1], scenes[0])

    def test_keep_alive_loops_until_interrupted(self, viewers, monkeypatch):
        _, tcls = viewers
        calls = []

        def sleep(s):
            calls.append(s)
            if len(calls) == 3:
                raise KeyboardInterrupt

        monkeypatch.setattr(tviewer, "time", types.SimpleNamespace(sleep=sleep))
        with pytest.raises(KeyboardInterrupt):
            tcls(port=0).keep_alive()
        assert calls == [1.0] * 3

    def test_without_viser_the_constructor_raises(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "viser", None)
        with pytest.raises(ImportError):
            tviewer.SLAMViewer(device="cpu")


def make_frames(n=9, h=56, w=70, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, size=(h, w, 3))
    frames = [np.roll(base, shift=i * 2, axis=1) + rng.integers(0, 20, size=(h, w, 3))
              for i in range(n)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


@pytest.fixture()
def tiny_both(tmp_path, monkeypatch):
    """A frame directory, and both packages' DA3 on the same tiny weights at
    process_res 70."""
    from PIL import Image

    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(make_frames()):
        Image.fromarray(f).save(frames_dir / f"{i:06d}.png")
    jparams = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jget_preset("tiny")))
    net = DA3Net(get_preset("tiny"))
    net.load_state_dict(convert(jparams), strict=True)
    monkeypatch.setattr(TDA3, "from_pretrained", classmethod(
        lambda cls, preset, seed=0, device="cuda": cls(get_preset("tiny"), net.to(device))))
    for cls in (JDA3, TDA3):
        monkeypatch.setattr(cls, "inference", functools.partialmethod(cls.inference,
                                                                      process_res=70))
    return frames_dir


SOLVER_CONFIG = {"Weights": {"DA3": "tiny"},
                 "Model": {"chunk_size": 4, "overlap_size": 1, "keyframe_interval": 1},
                 "Align": {"method": "umeyama"}}


class TestSolverViewer:
    @pytest.mark.parametrize("device_resident", [False, True])
    def test_solvers_send_the_same_points(self, viewers, tiny_both, device_resident):
        """9 frames in chunks of 4 (two steady chunks and a re-anchored tail):
        every frame reaches the viewer once, with its global pose, in order;
        points within SOLVER_POINT_TOL of the JAX solver's, colours and
        counts exactly; frusta at the trajectory's camera centres."""
        from da3slam_tpu.slam.solver import SLAMSolver as JSolver
        from da3slam_tpu_torch.slam.solver import SLAMSolver

        jcls, tcls = viewers
        jv, tv = jcls(port=0, point_stride=2), tcls(port=0, point_stride=2)
        js = JSolver(str(tiny_both), SOLVER_CONFIG, viewer=jv)
        js.run()
        cfg = {k: dict(v) for k, v in SOLVER_CONFIG.items()}
        cfg["Model"]["device_resident"] = device_resident
        ts = SLAMSolver(str(tiny_both), cfg, viewer=tv, device="cpu")
        ts.run()
        t, j = record(tv), record(jv)
        assert len(t["clouds"]) == len(t["frusta"]) == 9
        assert [c[0] for c in t["clouds"]] == [f"/map/frame_{i}" for i in range(9)]
        assert t["kept"] == j["kept"]
        for (_, tp, tc, *_), (_, jp, jc, *_) in zip(t["clouds"], j["clouds"]):
            np.testing.assert_allclose(tp, jp, atol=SOLVER_POINT_TOL, rtol=0)
            np.testing.assert_array_equal(tc, jc)
        c2w, _ = ts.trajectory()
        np.testing.assert_allclose(np.stack([f[4] for f in t["frusta"]]), c2w[:, :3, 3],
                                   atol=POSE_TOL, rtol=0)
        np.testing.assert_allclose(np.stack([f[4] for f in t["frusta"]]),
                                   np.stack([f[4] for f in j["frusta"]]), atol=1e-4, rtol=0)
        assert ts.timer.counts["viewer"] == js.timer.counts["viewer"] == 3

    def test_local_extrinsics_fallback(self, viewers, capsys):
        """A chunk without global poses goes to the viewer with its local
        ones, with the JAX solver's warning; frames before ``start`` are
        skipped."""
        from da3slam_tpu.slam.solver import SLAMSolver as JSolver
        from da3slam_tpu_torch.slam.solver import SLAMSolver

        rng = np.random.default_rng(0)
        n = 3
        chunk = {"image_paths": ["a", "b", "c"],
                 "processed_images": rng.integers(0, 256, (n, 24, 32, 3), dtype=np.uint8),
                 "depth": rng.uniform(0.5, 3.0, (n, 24, 32)).astype(np.float32),
                 "conf": rng.uniform(1.0, 3.0, (n, 24, 32)).astype(np.float32),
                 "extrinsics": np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1)),
                 "intrinsics": np.tile(frame_inputs()[4], (n, 1, 1))}
        scenes, outs = [], []
        for cls, solver_cls in zip(viewers, (JSolver, SLAMSolver)):
            v = cls(port=0, point_stride=2)
            solver = solver_cls.__new__(solver_cls)
            solver.viewer = v
            solver.update_viewer(chunk, start=1)
            scenes.append(record(v))
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] == "warn: no extrinsics_global; falling back to local extrinsics\n"
        assert len(scenes[1]["clouds"]) == 2
        assert_same_scene(scenes[1], scenes[0])


class TestCLIs:
    def test_main_slam_falls_back_to_headless_as_jax(self, tiny_both, tmp_path, capsys,
                                                     monkeypatch):
        from da3slam_tpu.cli import main_slam as jmain
        from da3slam_tpu_torch.cli import main_slam as tmain

        monkeypatch.setitem(sys.modules, "viser", None)
        cfg = tmp_path / "slam.yaml"
        cfg.write_text("Weights: {DA3: tiny}\nModel: {chunk_size: 4, overlap_size: 1}\n"
                       "Align: {method: umeyama}\n")
        common = ["--image_dir", str(tiny_both), "--config", str(cfg)]
        jmain.main(common + ["--output_dir", str(tmp_path / "j")])
        jout = capsys.readouterr().out
        solver = tmain.main(common + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
        tout = capsys.readouterr().out
        line = "Viewer unavailable (import of viser halted; None in sys.modules); running headless"
        assert line in tout.splitlines() and line in jout.splitlines()
        assert solver.viewer is None and "viewer still running" not in tout
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / "camera_poses.txt"),
                                   np.loadtxt(tmp_path / "j" / "camera_poses.txt"), atol=1e-4)

    def test_main_slam_stays_alive_with_the_viewer(self, viewers, tiny_both, tmp_path, capsys,
                                                   monkeypatch):
        """With a viewer the CLI sends every frame and then waits, as the JAX
        CLI does, until interrupted."""
        from da3slam_tpu_torch.cli import main_slam as tmain

        cfg = tmp_path / "slam.yaml"
        cfg.write_text("Weights: {DA3: tiny}\nModel: {chunk_size: 4, overlap_size: 1}\n"
                       "Align: {method: umeyama}\n")
        waits = []

        def sleep(s):
            waits.append(s)
            raise KeyboardInterrupt

        monkeypatch.setattr(tmain, "time", types.SimpleNamespace(sleep=sleep))
        solver = tmain.main(["--image_dir", str(tiny_both), "--config", str(cfg),
                             "--device", "cpu"])
        assert waits == [1]
        assert len(solver.viewer.server.scene.clouds) == 9
        assert "SLAM finished; viewer still running (ctrl-c to exit)" in capsys.readouterr().out

    def test_main_align_sends_chunk_ends_as_jax(self, viewers, tiny_both, tmp_path,
                                                monkeypatch):
        """main_align without --headless: the first and last frame of each
        chunk (3 chunks: 6 frames) reach the viewer, as in the JAX CLI, then
        it keeps alive."""
        from da3slam_tpu.cli import main_align as jmain
        from da3slam_tpu_torch.cli import main_align as tmain

        servers = []

        class Recording(_Server):
            def __init__(self, host, port):
                super().__init__(host, port)
                servers.append(self)

        sys.modules["viser"].ViserServer = Recording
        def interrupt(_s):
            raise KeyboardInterrupt

        for mod in (sys.modules["da3slam_tpu.viz.viewer"], tviewer):
            monkeypatch.setattr(mod, "time", types.SimpleNamespace(sleep=interrupt))
        common = ["--image_dir", str(tiny_both), "--model", "tiny", "--method", "umeyama",
                  "--process_res", "70"]
        for main, extra in ((jmain.main, []), (tmain.main, ["--device", "cpu"])):
            with pytest.raises(KeyboardInterrupt):
                main(common + extra)
        j, t = servers
        names = [c.name for c in t.scene.clouds]
        assert names == [c.name for c in j.scene.clouds] == [f"/map/frame_{i}" for i in range(6)]
        for tc, jc in zip(t.scene.clouds, j.scene.clouds):
            np.testing.assert_allclose(tc.points, jc.points, atol=SOLVER_POINT_TOL, rtol=0)
            np.testing.assert_array_equal(tc.colors, jc.colors)

    def test_main_align_falls_back_to_headless_as_jax(self, tiny_both, tmp_path, capsys,
                                                      monkeypatch):
        from da3slam_tpu.cli import main_align as jmain
        from da3slam_tpu_torch.cli import main_align as tmain

        monkeypatch.setitem(sys.modules, "viser", None)
        common = ["--image_dir", str(tiny_both), "--model", "tiny", "--method", "umeyama",
                  "--process_res", "70"]
        jmain.main(common)
        jout = capsys.readouterr().out
        tmain.main(common + ["--device", "cpu"])
        tout = capsys.readouterr().out
        assert "viser unavailable; headless" in jout.splitlines()
        assert "viser unavailable; headless" in tout.splitlines()
