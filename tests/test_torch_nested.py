"""The port's nested tier (``da3slam_tpu_torch/models/nested.py``) against
``da3slam_tpu.models.nested``.

Weights go from the JAX package to the port through its
``export_torch_style_nested`` and the port's split and import; images are made
from a seed with numpy.  f32 on the CPU.  Tolerances: the dense maps and poses
within 1e-4 of their largest value (``tests/test_torch_weights.py``'s bound on
the same tiny model), the metric scale within 1e-5 relative (a median of f32
ratios of those maps), ``metric_scale_from_mono`` on the same arrays within
1e-6 relative (the same f32 operations, sums in no other order).
"""

import dataclasses
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from da3slam_tpu.models.config import resolve_nested_preset as jresolve
from da3slam_tpu.models.da3 import DepthAnything3 as JDA3
from da3slam_tpu.models.nested import DepthAnything3Nested as JNested
from da3slam_tpu.models.nested import _config_from_state_dict as jconfig_from_sd
from da3slam_tpu.models.nested import export_torch_style_nested as jexport_nested
from da3slam_tpu.models.nested import metric_scale_from_mono as jmetric_scale
from da3slam_tpu.models.torch_import import split_nested_state_dict as jsplit
from da3slam_tpu_torch.models import config as tconfig
from da3slam_tpu_torch.models.config import get_preset, resolve_nested_preset
from da3slam_tpu_torch.models.da3 import DepthAnything3
from da3slam_tpu_torch.models.nested import (
    DepthAnything3Nested,
    _config_from_state_dict,
    export_torch_style_nested,
    metric_scale_from_mono,
)
from da3slam_tpu_torch.models.torch_import import split_nested_state_dict
from da3slam_tpu_torch.models.weights import save_file
from da3slam_tpu_torch.utils import profiling as prof
from test_torch_nested_cuda import assert_equals_old_order, old_order

torch.set_num_threads(2)
FIXTURES = Path(__file__).parent / "fixtures"
IMGS = np.random.default_rng(0).integers(0, 256, size=(3, 56, 70, 3)).astype(np.uint8)


def _generator():
    spec = importlib.util.spec_from_file_location("gen_torch_schema",
                                                  FIXTURES / "gen_torch_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shape_only(keys: dict) -> dict:
    """Arrays with the right shapes and no memory (the nested giant manifest
    would be ~6 GB materialised; split and config inference read shapes)."""
    return {k: np.broadcast_to(np.float32(0), tuple(s)) for k, s in keys.items()}


def assert_close_to_max(a, b, rel=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), np.abs(a - b).max()


@pytest.fixture(scope="module")
def pair():
    """The JAX package's nested-tiny (seed 3) and the port's, from its
    exported state dict through the port's split and import."""
    jn = JNested.from_pretrained("nested-tiny", seed=3)
    sd = jexport_nested(jn)
    split = split_nested_state_dict(sd)
    assert split[2] == ("model.", "metric_model.")
    return jn, DepthAnything3Nested.from_split_state_dicts(*split[:2], device="cpu")


class TestPresets:
    @pytest.mark.parametrize("name", ["DA3NESTED-GIANT-LARGE-1.1", "/ckpts/DA3NESTED-GIANT-LARGE-1.1",
                                      "da3nested-giant-large", "nested-giant-large",
                                      "nested-tiny", "small", "giant", "DA3-LARGE-1.1"])
    def test_resolve_equals_jax(self, name):
        assert resolve_nested_preset(name) == jresolve(name)

    def test_nested_name_is_not_the_giant_alone(self):
        """``get_preset`` keeps its alias of the nested name to giant, as the
        JAX package does; ``from_pretrained`` checks the nested name first."""
        assert resolve_nested_preset("DA3NESTED-GIANT-LARGE-1.1") == ("giant", "large")
        assert get_preset("DA3NESTED-GIANT-LARGE-1.1") == get_preset("giant")

    @pytest.mark.parametrize("name", ["DA3NESTED-GIANT-LARGE-1.1",
                                      "/ckpts/DA3NESTED-GIANT-LARGE-1.1"])
    def test_from_pretrained_returns_nested(self, name, monkeypatch):
        """The production name gives the nested class (built with tiny
        stand-ins for giant and large: no giant init on the CPU)."""
        monkeypatch.setitem(tconfig.NESTED_PRESETS, "nested-giant-large", ("tiny", "small"))
        m = DepthAnything3.from_pretrained(name, seed=4, device="cpu")
        assert isinstance(m, DepthAnything3Nested)
        assert m.cfg == get_preset("tiny") and m.metric.cfg == get_preset("small")
        assert m.net is m.anyview.net and m.device == torch.device("cpu")
        assert m.dtype == torch.float32
        # the metric model's weights come from seed + 1
        ref = DepthAnything3.from_pretrained("small", seed=5, device="cpu").net.state_dict()
        got = m.metric.net.state_dict()
        assert all(torch.equal(ref[k], got[k]) for k in ref)

    def test_unknown_nested_preset_raises(self):
        with pytest.raises(KeyError, match="unknown nested preset"):
            DepthAnything3Nested.from_pretrained("small", device="cpu")


class TestMetricScale:
    @staticmethod
    def cases():
        rng = np.random.default_rng(0)
        a = rng.uniform(0.5, 4.0, (32, 32)).astype(np.float32)
        conf = rng.uniform(1.0, 3.0, (32, 32)).astype(np.float32)
        m = (3.7 * a * rng.uniform(0.9, 1.1, a.shape)).astype(np.float32)
        even = rng.uniform(0.5, 4.0, (4, 6)).astype(np.float32)  # an even count
        nan_depth = a.copy()
        nan_depth[3, 4] = np.nan
        nan_conf = conf.copy()
        nan_conf[0, 0] = np.nan
        zero = np.zeros((8, 8), np.float32)
        return {
            "known_scale": (a, np.full_like(a, 2.0), 3.7 * a, np.full_like(a, 2.0)),
            "random": (a, conf, m, conf[::-1].copy()),
            "even_count": (even, np.ones_like(even), 2.5 * even * even, np.ones_like(even)),
            "all_invalid": (zero, np.ones_like(zero), zero, np.ones_like(zero)),
            "nan_depth": (nan_depth, conf, m, conf),
            "nan_conf": (a, nan_conf, m, conf),
            "negative_metric": (a, conf, -m, conf),
        }

    @pytest.mark.parametrize("case", ["known_scale", "random", "even_count", "all_invalid",
                                      "nan_depth", "nan_conf", "negative_metric"])
    def test_equals_jax(self, case):
        args = self.cases()[case]
        s = metric_scale_from_mono(*[torch.from_numpy(x) for x in args])
        js = float(jmetric_scale(*[jnp.asarray(x) for x in args]))
        assert s.ndim == 0 and s.dtype == torch.float32
        assert abs(float(s) - js) <= 1e-6 * abs(js), (float(s), js)
        if case in ("all_invalid", "nan_conf", "negative_metric"):
            assert float(s) == 1.0  # the fallback fires
        if case == "known_scale":
            assert abs(float(s) - 3.7) < 1e-5

    def test_numpy_inputs_and_even_median(self):
        """Numpy inputs work too; an even count of valid ratios takes the
        mean of the two middle ones (``torch.nanmedian`` takes the lower)."""
        a = np.ones((1, 4), np.float32)
        m = np.array([[1.0, 2.0, 3.0, 4.0]], np.float32)
        c = np.ones((1, 4), np.float32)
        assert float(metric_scale_from_mono(a, c, m, c)) == 2.5 == float(jmetric_scale(a, c, m, c))


class TestNestedInference:
    def test_matches_jax(self, pair):
        jn, tn = pair
        jp = jn.inference(image=list(IMGS), process_res=70)
        tp = tn.inference(image=list(IMGS), process_res=70)
        for f in ("depth", "conf", "extrinsics", "intrinsics"):
            assert_close_to_max(getattr(tp, f), getattr(jp, f))
        assert isinstance(tp.metric_scale, float)
        assert abs(tp.metric_scale - jp.metric_scale) <= 1e-5 * abs(jp.metric_scale)
        assert tp.metric_scale != 1.0  # the scale was recovered, not the fallback

    def test_rescale_semantics(self, pair):
        """Depth and translations scale by ``metric_scale``; rotations and
        intrinsics are the any-view model's."""
        _, tn = pair
        pred = tn.inference(image=list(IMGS), process_res=70)
        base = tn.anyview.inference(image=list(IMGS), process_res=70)
        s = np.float32(pred.metric_scale)
        np.testing.assert_array_equal(pred.depth, base.depth * s)
        np.testing.assert_array_equal(pred.extrinsics[:, :, 3], base.extrinsics[:, :, 3] * s)
        np.testing.assert_array_equal(pred.extrinsics[:, :, :3], base.extrinsics[:, :, :3])
        np.testing.assert_array_equal(pred.intrinsics, base.intrinsics)

    def test_keep_on_device_and_staged_tensor(self, pair):
        """A staged tensor batch with ``keep_on_device`` gives the numpy
        path's values, the scale a 0-d tensor."""
        _, tn = pair
        a = tn.inference(image=list(IMGS), process_res=70)
        b = tn.inference(image=torch.from_numpy(IMGS), process_res=70, keep_on_device=True)
        assert isinstance(b.metric_scale, torch.Tensor) and b.metric_scale.ndim == 0
        assert float(b.metric_scale) == a.metric_scale
        np.testing.assert_array_equal(b.depth.numpy(), a.depth)
        np.testing.assert_array_equal(b.extrinsics.numpy(), a.extrinsics)

    @pytest.mark.parametrize("staged", [False, True], ids=["list", "staged"])
    def test_default_call_equals_the_old_order(self, pair, staged):
        """One fetch at the end gives, bit for bit, what fetching each branch
        and rescaling on the host gave (``test_torch_nested_cuda.py``: the
        same on the card)."""
        _, tn = pair
        image = torch.from_numpy(IMGS) if staged else list(IMGS)
        assert_equals_old_order(tn.inference(image, process_res=70), old_order(tn, image, 70))

    @pytest.mark.parametrize("keep", [False, True], ids=["fetched", "kept"])
    def test_the_chunk_is_fetched_once_after_both_branches(self, pair, keep):
        _, tn = pair
        t0 = time.perf_counter()
        tn.inference(list(IMGS), process_res=70, keep_on_device=keep)
        recs = prof.records(since=t0)
        (top,) = [r for r in recs if r.name == "model.nested"]
        branches = [r for r in recs if r.name == "model.inference"]
        fetches = [r for r in recs if r.name == "model.fetch"]
        assert len(branches) == 2 and all(r.parent == top.id for r in branches)
        assert top.attrs["fetches"] == len(fetches) == (0 if keep else 1)
        if not keep:
            assert fetches[0].parent == top.id
            assert fetches[0].start >= max(r.end for r in branches)

    @pytest.mark.parametrize("strategy", ["first", "middle"])
    def test_ref_view_strategy_matches_jax(self, pair, strategy):
        jn, tn = pair
        jp = jn.inference(image=list(IMGS), process_res=70, ref_view_strategy=strategy)
        tp = tn.inference(image=list(IMGS), process_res=70, ref_view_strategy=strategy)
        assert abs(tp.metric_scale - jp.metric_scale) <= 1e-5 * abs(jp.metric_scale)
        assert_close_to_max(tp.depth, jp.depth)

    def test_extrinsics_conditioning_skips_the_rescale(self, pair):
        jn, tn = pair
        ext = np.repeat(np.eye(4, dtype=np.float32)[None, :3], 3, axis=0)
        ext[1, 0, 3], ext[2, 1, 3] = 0.5, -0.25
        jp = jn.inference(image=list(IMGS), process_res=70, extrinsics=ext)
        tp = tn.inference(image=list(IMGS), process_res=70, extrinsics=ext)
        assert tp.metric_scale is None and jp.metric_scale is None
        np.testing.assert_allclose(tp.extrinsics, ext, rtol=1e-6)
        assert_close_to_max(tp.depth, jp.depth)

    def test_export_dir_holds_the_depth_before_the_rescale(self, pair, tmp_path):
        """``export_dir`` reaches the any-view inference, so ``prediction.npz``
        holds the depth before the metric rescale, as the JAX package writes
        it (ROADMAP queue 3)."""
        jn, tn = pair
        jn.inference(image=list(IMGS), process_res=70, export_dir=str(tmp_path / "jax"))
        pred = tn.inference(image=list(IMGS), process_res=70, export_dir=tmp_path / "port")
        tz, jz = np.load(tmp_path / "port" / "prediction.npz"), np.load(
            tmp_path / "jax" / "prediction.npz")
        assert set(tz.files) == set(jz.files)
        for k in jz.files:
            assert_close_to_max(tz[k], jz[k])
        np.testing.assert_array_equal(tz["depth"] * np.float32(pred.metric_scale), pred.depth)

    def test_quantize_quantizes_both(self, pair):
        from da3slam_tpu_torch.models.vit import Int8Linear

        _, tn = pair
        q = tn.quantize()
        assert isinstance(q, DepthAnything3Nested)
        for sub in (q.anyview, q.metric):
            assert isinstance(sub.net.blocks[0].attn.qkv, Int8Linear)
        pred = q.inference(image=list(IMGS), process_res=70)
        assert np.isfinite(pred.depth).all() and np.isfinite(pred.metric_scale)


class TestSplit:
    @staticmethod
    def dicts():
        gen = _generator()

        def prefixed(prefix, keys):
            return {f"{prefix}{k}": np.zeros(s, np.float32) for k, s in keys.items()}

        a2, m2 = gen.backbone_keys(32, 2, 128, 1), gen.backbone_keys(16, 2, 64, 1)
        big, small = gen.backbone_keys(32, 1, 128, 1), gen.backbone_keys(16, 1, 64, 1)
        return {
            "not_nested": {"patch_embed.proj.weight": np.zeros((8, 3, 14, 14), np.float32)},
            "named_prefixes": {**prefixed("model.", a2), **prefixed("metric_model.", m2)},
            "metric_name_wins_over_width": {**prefixed("model.", small),
                                            **prefixed("metric_model.", big)},
            "unnamed_rank_by_width": {**prefixed("a.", small), **prefixed("b.", big)},
            "unprefixed_anyview": {**prefixed("", big), **prefixed("metric_model.", small)},
        }

    @pytest.mark.parametrize("case", ["not_nested", "named_prefixes",
                                      "metric_name_wins_over_width", "unnamed_rank_by_width",
                                      "unprefixed_anyview"])
    def test_equals_jax(self, case):
        sd = self.dicts()[case]
        got, want = split_nested_state_dict(sd), jsplit(sd)
        if want is None:
            assert got is None
            return
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            assert list(g) == list(w) and all(g[k] is w[k] for k in w)
        expected_prefixes = {"named_prefixes": ("model.", "metric_model."),
                             "metric_name_wins_over_width": ("model.", "metric_model."),
                             "unnamed_rank_by_width": ("b.", "a."),
                             "unprefixed_anyview": ("", "metric_model.")}
        assert got[2] == expected_prefixes[case]


class TestConfigFromStateDict:
    @pytest.fixture(scope="class")
    def schema(self):
        return json.loads((FIXTURES / "torch_schema_nested_giant.json").read_text())

    def test_schema_manifest_splits_into_giant_and_large(self, schema):
        split = split_nested_state_dict(_shape_only(schema["keys"]))
        sd_any, sd_met, prefixes = split
        assert prefixes == (schema["prefixes"]["anyview"], schema["prefixes"]["metric"])
        assert _config_from_state_dict(sd_any) == get_preset("giant")
        assert _config_from_state_dict(sd_met) == get_preset("large")
        for sub in (sd_any, sd_met):
            assert dataclasses.asdict(_config_from_state_dict(sub)) == \
                dataclasses.asdict(jconfig_from_sd(sub))

    def test_unknown_tier_raises(self):
        sd = _shape_only(_generator().backbone_keys(48, 3, 128, 1))
        with pytest.raises(ValueError, match="no preset matches"):
            _config_from_state_dict(sd)
        with pytest.raises(ValueError, match="no preset matches"):
            jconfig_from_sd(sd)


class TestCheckpointDirectory:
    def write(self, d: Path, sd: dict, cfg_any, cfg_met) -> Path:
        d.mkdir(parents=True)
        save_file(sd, d / "model.safetensors")
        (d / "config.json").write_text(json.dumps({
            "model": dataclasses.asdict(cfg_any), "metric_model": dataclasses.asdict(cfg_met)}))
        return d

    def test_port_round_trip_is_bit_equal(self, pair, tmp_path):
        """export → nested safetensors directory → ``from_pretrained`` finds the
        nested layout → the same tensors and outputs, bit for bit."""
        _, tn = pair
        d = self.write(tmp_path / "DA3NESTED-TINY", export_torch_style_nested(tn),
                       tn.anyview.cfg, tn.metric.cfg)
        loaded = DepthAnything3.from_pretrained(str(d), device="cpu")
        assert isinstance(loaded, DepthAnything3Nested)
        for a, b in ((tn.anyview, loaded.anyview), (tn.metric, loaded.metric)):
            sa, sb = a.net.state_dict(), b.net.state_dict()
            assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
        p, q = tn.inference(image=list(IMGS), process_res=70), loaded.inference(
            image=list(IMGS), process_res=70)
        np.testing.assert_array_equal(p.depth, q.depth)
        assert p.metric_scale == q.metric_scale

    def test_jax_written_directory_matches_jax(self, pair, tmp_path):
        """The directory the JAX package's tests write (its export, a nested
        config.json) loads in both packages to the same outputs."""
        jn, _ = pair
        sd = {k: np.ascontiguousarray(v) for k, v in jexport_nested(jn).items()}
        d = self.write(tmp_path / "nested", sd, jn.anyview.cfg, jn.metric.cfg)
        for f in ("pytorch_model.bin",):  # the pickled form of the same dict
            pk = tmp_path / "pickled"
            pk.mkdir()
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pk / f)
            (pk / "config.json").write_text((d / "config.json").read_text())
        jl = JDA3.from_pretrained(str(d))
        jp = jl.inference(image=list(IMGS), process_res=70)
        for path in (d, pk):
            tl = DepthAnything3.from_pretrained(str(path), device="cpu")
            assert isinstance(tl, DepthAnything3Nested)
            tp = tl.inference(image=list(IMGS), process_res=70)
            assert_close_to_max(tp.depth, jp.depth)
            assert_close_to_max(tp.extrinsics, jp.extrinsics)
            assert abs(tp.metric_scale - jp.metric_scale) <= 1e-5 * abs(jp.metric_scale)

    def test_not_nested_directory_refused_by_the_nested_loader(self, tmp_path):
        m = DepthAnything3.from_pretrained("tiny", device="cpu")
        d = tmp_path / "single"
        d.mkdir()
        save_file(m.net.state_dict(), d / "model.safetensors")
        with pytest.raises(ValueError, match="not nested"):
            DepthAnything3Nested.from_pretrained(str(d), device="cpu")


def _frames_dir(tmp_path: Path, n: int = 9) -> Path:
    from PIL import Image

    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, size=(56, 70 + 4 * n, 3)).astype(np.uint8)
    for i in range(n):
        Image.fromarray(base[:, 4 * i: 4 * i + 70]).save(d / f"{i:06d}.png")
    return d


def test_solver_over_nested_matches_jax(pair, tmp_path, monkeypatch, capsys):
    """``SLAMSolver`` of both packages over nested-tiny (same weights): 9
    frames in chunks of 4 (two steady chunks after the first and the
    re-anchored tail), closed-form Umeyama alignment, process_res 70; the
    port's solver prefetches for the nested model as for the plain one.

    The chunk's random metric scales are inexact, as in
    ``tests/test_torch_slam.py::TestSolver::test_inexact_chunk_scales``, and
    the solver resolves them no better: the test first pins that a 3e-6
    relative change of one chunk's depth (the size of the two packages' f32
    difference in the metric scale) moves the port's own trajectory by more
    than 1e-4.  The port is then held to the JAX package's per-chunk metric
    scales (1e-4 relative: the median pixel of the ratio map may be another
    one when the maps differ at the dense maps' 1e-4; one chunk here is
    1.2e-5 apart) and depth scales (as printed), and to its
    trajectory at that test's 1e-3: rotations absolutely, translations
    relative to the trajectory's extent (they carry the metric scale)."""
    from da3slam_tpu.slam.solver import SLAMSolver as JSolver
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    jn, tn = pair
    scales = {JNested: [], DepthAnything3Nested: []}
    nudge = {"factor": None}
    for cls in (JNested, DepthAnything3Nested):
        def infer(self, *args, _orig=cls.inference, _cls=cls, **kwargs):
            pred = _orig(self, *args, process_res=70, **kwargs)
            scales[_cls].append(float(pred.metric_scale))
            if _cls is DepthAnything3Nested and nudge["factor"] and len(scales[_cls]) == 2:
                pred.depth = pred.depth * np.float32(nudge["factor"])
            return pred
        monkeypatch.setattr(cls, "inference", infer)
    image_dir = str(_frames_dir(tmp_path))
    cfg = {"Model": {"chunk_size": 4, "overlap_size": 1, "keyframe_interval": 1,
                     "sleep_between_chunk": 0, "port": 8080},
           "Align": {"method": "umeyama"}}
    jsolver = JSolver(image_dir, cfg, model=jn, viewer=None)
    jsolver.run()
    tsolver = SLAMSolver(image_dir, cfg, model=tn, device="cpu")
    assert tsolver.prefetch is True
    tsolver.run()
    printed = [ln.split("depth_scale=")[1].split()[0]
               for ln in capsys.readouterr().out.splitlines() if "depth_scale=" in ln]
    c2w, jc2w = tsolver.trajectory()[0], jsolver.trajectory()[0]

    nudge["factor"] = 1 + 3e-6
    scales[DepthAnything3Nested].clear()
    nudged = SLAMSolver(image_dir, cfg, model=tn, device="cpu")
    nudged.run()
    assert np.abs(nudged.trajectory()[0] - c2w).max() > 1e-4

    assert len(scales[JNested]) == 3
    np.testing.assert_allclose(scales[DepthAnything3Nested], scales[JNested], rtol=1e-4)
    assert len(printed) == 4 and printed[:2] == printed[2:]  # JAX's 2 aligned chunks, then ours
    assert c2w.shape == (9, 4, 4) and np.isfinite(c2w).all()
    np.testing.assert_allclose(c2w[:, :3, :3], jc2w[:, :3, :3], atol=1e-3)
    extent = np.abs(jc2w[:, :3, 3]).max()
    np.testing.assert_allclose(c2w[:, :3, 3], jc2w[:, :3, 3], atol=1e-3 * extent)
