"""The port's single-device pipeline against ``da3slam_tpu.slam.pipeline`` and
against the port's own ``SLAMSolver``.

Tiny preset, the JAX package's seed-0 weights carried over by ``convert``, the
same uint8 frames (11 of 56x70 in windows of 4: three steady windows and a
re-anchored tail), f32 on the CPU.  Against JAX the alignment is the
closed-form Umeyama, as in ``tests/test_pipeline.py`` (ICP on a random-init
model's depth amplifies summation-order differences between two
implementations): 1e-4 on poses and dense maps, as for the other whole-slice
comparisons.  Within the port every variant (segments, spill target, frames
given as a tensor, the solver's loop) queues the same operations on the same
inputs, so they are held bit-equal, with ICP; the solver comparison allows
1e-4 because ``SLAMSolver`` fetches each chunk to numpy and back.

The multi-device pipelines (dp, sp, pp) run on gloo ranks on the CPU
(``parallel/mesh.py:run_ranks``; the ranks run
``tests/test_torch_rank_bodies.py:slam_runs``, one spawn per mode and world
size) against the JAX package's on its virtual mesh, at the same bound; a
one-rank mesh is held bit-equal to ``mesh=None``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.parallel import make_mesh as jmake_mesh
from da3slam_tpu.slam.alignment import AlignmentConfig as JAlignmentConfig
from da3slam_tpu.slam.pipeline import make_windows as jmake_windows
from da3slam_tpu.slam.pipeline import run_streaming_slam as jrun_streaming_slam
from da3slam_tpu_torch.core.transforms import se3_inverse, se3_to_4x4
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net, DepthAnything3
from da3slam_tpu_torch.parallel import run_ranks
from da3slam_tpu_torch.slam.alignment import AlignmentConfig
from da3slam_tpu_torch.slam.chunks import make_image_chunks, run_chunked_alignment
from da3slam_tpu_torch.slam.pipeline import (
    PipelineOutput,
    make_windows,
    run_pipeline,
    run_streaming_slam,
)
from da3slam_tpu_torch.slam.solver import SLAMSolver

import test_torch_rank_bodies as bodies

torch.set_num_threads(2)
CFG = get_preset("tiny")
KW = dict(chunk_size=4, overlap=1, process_hw=(56, 70), dtype=torch.float32)


def make_frames(n=11, h=56, w=70, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, size=(h, w, 3))
    frames = [np.roll(base, shift=i * 2, axis=1) + rng.integers(0, 20, size=(h, w, 3))
              for i in range(n)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jparams():
    return jinit(jax.random.PRNGKey(0), jget_preset("tiny"))


@pytest.fixture(scope="module")
def net(jparams):
    n = DA3Net(CFG)
    n.load_state_dict(convert(jax.tree.map(np.asarray, jparams)), strict=True)
    return n.eval()


@pytest.fixture(scope="module")
def whole(net):
    return run_streaming_slam(net, make_frames(), CFG, **KW)


def arrays(out):
    return [np.asarray(t) for t in out]


def assert_outputs_equal(a, b):
    for name, x, y in zip(PipelineOutput._fields, arrays(a), arrays(b)):
        np.testing.assert_array_equal(x, y, err_msg=name)


def dedup_c2w(ext_global, anchors):
    """[C, N, 3, 4] w2c → one c2w [4, 4] per physical frame."""
    keep = [np.asarray(ext_global[k])[(anchors[k] + 1 if k else 0):] for k in range(len(anchors))]
    w2c = torch.from_numpy(np.concatenate(keep)).float()
    return se3_to_4x4(se3_inverse(w2c)).numpy()


class TestWindows:
    @pytest.mark.parametrize("n,c,o", [(10, 4, 1), (11, 4, 1), (12, 5, 2), (13, 5, 2), (3, 4, 1),
                                       (31, 15, 1)])
    def test_equal_jax(self, n, c, o):
        idx, anchors = make_windows(n, c, o)
        jidx, janchors = jmake_windows(n, c, o)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(anchors, janchors)
        assert anchors.dtype == janchors.dtype

    def test_image_chunks(self):
        from da3slam_tpu.slam.chunks import make_image_chunks as jchunks

        items = list("abcdefghijk")
        assert make_image_chunks(items, 4, 1) == jchunks(items, 4, 1)
        assert make_image_chunks(items, 4, 1)[-1] == list("hijk")


class TestAgainstJax:
    def test_whole_run_matches_jax(self, net, jparams):
        frames = make_frames()
        out = run_streaming_slam(net, frames, CFG, align_config=AlignmentConfig(method="umeyama"),
                                 **KW)
        jout = jrun_streaming_slam(
            jparams, frames, jget_preset("tiny"), chunk_size=4, overlap=1, process_hw=(56, 70),
            dtype=jnp.float32, align_config=JAlignmentConfig(method="umeyama"))
        assert isinstance(out.depth, torch.Tensor) and out.depth.shape == (4, 4, 56, 70)
        for name, a, b in zip(PipelineOutput._fields, arrays(out), arrays(jout)):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert np.isfinite(a).all(), name
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=name)
        # the first window defines the global frame and needs no rescale
        np.testing.assert_allclose(out.extrinsics_global[0, 0].numpy(), np.eye(4)[:3], atol=1e-5)
        assert float(out.depth_scale[0]) == 1.0 == float(out.fitness[0])


class TestVariants:
    @pytest.mark.parametrize("segment_windows", [1, 2, 3])
    def test_segmented_host_spill_equals_whole(self, net, whole, segment_windows):
        seg = run_streaming_slam(net, make_frames(), CFG, segment_windows=segment_windows, **KW)
        assert all(isinstance(a, np.ndarray) for a in seg)
        assert_outputs_equal(seg, whole)

    def test_device_spill_and_tensor_frames(self, net, whole):
        frames = torch.from_numpy(make_frames())
        dev = run_streaming_slam(net, frames, CFG, segment_windows=2, segment_spill="device", **KW)
        assert all(isinstance(t, torch.Tensor) for t in dev)
        assert_outputs_equal(dev, whole)
        assert_outputs_equal(run_streaming_slam(net, frames, CFG, **KW), whole)
        # a segment count past the windows is the whole run
        assert_outputs_equal(run_streaming_slam(net, frames, CFG, segment_windows=9, **KW), whole)

    def test_f16_spill(self, net, whole):
        f16 = run_streaming_slam(net, make_frames(), CFG, spill_dtype=torch.float16, **KW)
        assert f16.depth.dtype == torch.float16 and f16.conf.dtype == torch.float16
        d32 = whole.depth.numpy()
        # f16: 10-bit mantissa, relative error <= 2^-11
        np.testing.assert_allclose(f16.depth.float().numpy(), d32, rtol=1e-3,
                                   atol=1e-3 * np.abs(d32).max())
        # poses, intrinsics, scales: bit-identical (the cast is at the emit only)
        for name in ("extrinsics_global", "intrinsics", "depth_scale", "fitness"):
            assert torch.equal(getattr(f16, name), getattr(whole, name)), name
        seg = run_streaming_slam(net, make_frames(), CFG, segment_windows=2,
                                 spill_dtype=torch.float16, **KW)
        assert seg.depth.dtype == np.float16
        np.testing.assert_array_equal(seg.extrinsics_global, whole.extrinsics_global.numpy())
        np.testing.assert_array_equal(seg.depth, f16.depth.numpy())

    def test_carry_threads_run_pipeline(self, net, whole):
        frames = torch.from_numpy(make_frames())
        idx, anchors = make_windows(11, 4, 1)
        first, carry = run_pipeline(net, frames, idx[:2], anchors[:2], CFG, dtype=torch.float32,
                                    process_hw=(56, 70))
        assert [tuple(c.shape) for c in carry] == [(56, 70), (56, 70), (3, 3), (3, 4)]
        assert torch.equal(carry[3], first.extrinsics_global[-1, -1])
        rest, _ = run_pipeline(net, frames, idx[2:], anchors[2:], CFG, dtype=torch.float32,
                               process_hw=(56, 70), carry=carry)
        assert_outputs_equal(PipelineOutput(*(torch.cat(p) for p in zip(first, rest))), whole)
        # without the carry the later windows start a new global frame
        fresh, _ = run_pipeline(net, frames, idx[2:], anchors[2:], CFG, dtype=torch.float32,
                                process_hw=(56, 70))
        assert not torch.equal(fresh.extrinsics_global, rest.extrinsics_global)
        # rows that are no consecutive range are gathered by index
        odd, _ = run_pipeline(net, frames, idx[:1, ::-1].copy(), anchors[:1], CFG,
                              dtype=torch.float32, process_hw=(56, 70))
        assert odd.depth.shape == (1, 4, 56, 70)

    def test_deterministic(self, net, whole):
        assert_outputs_equal(run_streaming_slam(net, make_frames(), CFG, **KW), whole)

    def test_bad_arguments_raise(self, net):
        frames = np.zeros((8, 28, 28, 3), np.uint8)
        with pytest.raises(ValueError, match="parallel"):
            run_streaming_slam(net, frames, CFG, chunk_size=4, overlap=1, parallel="tp")
        with pytest.raises(TypeError, match="DeviceMesh"):
            run_streaming_slam(net, frames, CFG, chunk_size=4, overlap=1, mesh=object())
        with pytest.raises(ValueError, match="segment_spill"):
            run_streaming_slam(net, frames, CFG, chunk_size=4, overlap=1, segment_windows=1,
                               segment_spill="disk", dtype=torch.float32)


class TestAgainstThePortsOwnLoops:
    def frames_dir(self, tmp_path):
        from PIL import Image

        d = tmp_path / "frames"
        d.mkdir()
        for i, f in enumerate(make_frames()):
            Image.fromarray(f).save(d / f"{i:06d}.png")  # lossless
        return d

    def test_matches_slam_solver(self, net, whole, tmp_path, monkeypatch):
        """The pipeline is another way to run the solver's loop, not other
        math: same trajectory, ICP included."""
        import functools

        model = DepthAnything3(CFG, net)
        monkeypatch.setattr(DepthAnything3, "inference", functools.partialmethod(
            DepthAnything3.inference, process_res=70))  # (56, 70): no resampling
        config = {"Model": {"chunk_size": 4, "overlap_size": 1, "keyframe_interval": 1}}
        solver = SLAMSolver(str(self.frames_dir(tmp_path)), config, model=model, device="cpu")
        solver.run()
        c2w, intr = solver.trajectory()
        _, anchors = make_windows(11, 4, 1)
        assert c2w.shape == (11, 4, 4)
        np.testing.assert_allclose(dedup_c2w(whole.extrinsics_global, anchors), c2w, atol=1e-4)
        for k, res in enumerate(solver.results):
            np.testing.assert_allclose(whole.extrinsics_global[k].numpy(),
                                       res["extrinsics_global"], atol=1e-4)

    @pytest.mark.parametrize("dedup", [False, True])
    def test_run_chunked_alignment(self, net, whole, tmp_path, dedup):
        """The offline tools' loop over paths gives the pipeline's arrays,
        concatenated; ``dedup_overlap`` keeps each physical frame once."""
        import functools

        model = DepthAnything3(CFG, net)
        paths = sorted(str(p) for p in self.frames_dir(tmp_path).iterdir())
        fused = run_chunked_alignment(model, paths, chunk_size=4, overlap=1, process_res=70,
                                      collect_images=True, verbose=False, dedup_overlap=dedup)
        idx, anchors = make_windows(11, 4, 1)
        assert fused["ranges"] == [(0, 4), (3, 7), (6, 10), (7, 11)]
        skip = [(anchors[k] + 1 if k and dedup else 0) for k in range(4)]
        n = sum(4 - s for s in skip)
        assert n == (11 if dedup else 16)
        for key, ref in (("depth", whole.depth), ("conf", whole.conf),
                         ("intrinsics", whole.intrinsics),
                         ("extrinsics_global", whole.extrinsics_global)):
            want = np.concatenate([ref[k].numpy()[skip[k]:] for k in range(4)])
            assert fused[key].shape == want.shape == (n, *want.shape[1:])
            np.testing.assert_allclose(fused[key], want, atol=1e-4, rtol=1e-4, err_msg=key)
        assert fused["images"].shape == (n, 56, 70, 3) and fused["images"].dtype == np.uint8


SPAWN_TIMEOUT_S = 120
UMEYAMA = dict(KW, align_config=AlignmentConfig(method="umeyama"))
# the runs of each spawn, by (mode, world size); "no_mesh" is mesh=None
MESH_RUNS = {
    ("dp", 1): {"mesh": KW, "none": dict(KW, no_mesh=True)},
    ("dp", 2): {"whole": UMEYAMA, "segmented": dict(UMEYAMA, segment_windows=2),
                "f16": dict(UMEYAMA, spill_dtype=torch.float16)},
    ("dp", 3): {"whole": UMEYAMA},
    ("dp", 4): {"whole": UMEYAMA},
    ("sp", 2): {"whole": UMEYAMA, "segmented": dict(UMEYAMA, segment_windows=2)},
    ("pp", 2): {"whole": UMEYAMA, "segmented": dict(UMEYAMA, segment_windows=2),
                "share": dict(UMEYAMA, segment_windows=2, pp_share=True)},
}
JAX_KW = {"whole": {}, "segmented": {"segment_windows": 2}, "f16": {"spill_dtype": jnp.float16}}


@pytest.fixture(scope="module")
def spawned(net):
    """``(mode, world)`` → that spawn's results, spawned on first use."""
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    cache = {}

    def get(mode: str, world: int) -> dict:
        if (mode, world) not in cache:
            cache[mode, world] = run_ranks(bodies.slam_runs, world, "gloo", "cpu",
                                           SPAWN_TIMEOUT_S, state, make_frames(), mode,
                                           MESH_RUNS[mode, world])
        return cache[mode, world]

    return get


def jrun_on_mesh(jparams, mode: str, world: int, run: str):
    mesh = jmake_mesh(world, tp=1) if mode == "dp" else \
        Mesh(np.asarray(jax.devices()[:world]), axis_names=(mode,))
    return jrun_streaming_slam(
        jparams, make_frames(), jget_preset("tiny"), chunk_size=4, overlap=1,
        process_hw=(56, 70), dtype=jnp.float32, align_config=JAlignmentConfig(method="umeyama"),
        mesh=mesh, parallel=mode, **JAX_KW[run])


class TestMultiDevice:
    @pytest.mark.parametrize("mode,world,run", [
        ("dp", 2, "whole"), ("dp", 2, "segmented"), ("dp", 2, "f16"), ("dp", 3, "whole"),
        ("dp", 4, "whole"), ("sp", 2, "whole"), ("sp", 2, "segmented"), ("pp", 2, "whole"),
        ("pp", 2, "segmented")])
    def test_matches_jax(self, spawned, jparams, mode, world, run):
        """dp at 3 ranks pads the 4 windows to 6 with repeats of the last."""
        out = spawned(mode, world)["outs"][run]
        jout = arrays(jrun_on_mesh(jparams, mode, world, run))
        for name, a, b in zip(PipelineOutput._fields, out, jout):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert np.isfinite(a).all(), name
            if a.dtype == np.float16:
                # maps within 1e-4 in f32 may round to neighbouring f16 values
                np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                           atol=1e-4, rtol=2.0 ** -10, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=name)

    @pytest.mark.parametrize("mode,world", sorted(MESH_RUNS))
    def test_every_rank_returns_the_whole(self, spawned, mode, world):
        res = spawned(mode, world)
        assert all(len(set(d)) == 1 for d in res["digests"].values())
        assert res["foreign"] == [[]] * world  # no rank imported JAX or the JAX package

    def test_one_rank_equals_no_mesh(self, spawned):
        """A one-rank dp mesh is the one-device loop, bit for bit (ICP)."""
        outs = spawned("dp", 1)["outs"]
        for name, a, b in zip(PipelineOutput._fields, outs["mesh"], outs["none"]):
            np.testing.assert_array_equal(a, b, err_msg=name)

    def test_f16_spill_on_mesh(self, spawned):
        outs = spawned("dp", 2)["outs"]
        assert outs["f16"][0].dtype == np.float16 and outs["f16"][1].dtype == np.float16
        d32 = outs["whole"][0]
        np.testing.assert_allclose(outs["f16"][0].astype(np.float32), d32, rtol=1e-3,
                                   atol=1e-3 * np.abs(d32).max())
        for i in range(2, 6):  # poses, intrinsics, scales: the cast is at the emit only
            np.testing.assert_array_equal(outs["f16"][i], outs["whole"][i])

    def test_pp_share_equals_whole_network(self, spawned):
        """A rank's pre-split share (the other stages' blocks dropped) runs
        the segments as the whole network does."""
        outs = spawned("pp", 2)["outs"]
        for name, a, b in zip(PipelineOutput._fields, outs["share"], outs["whole"]):
            np.testing.assert_array_equal(a, b, err_msg=name)

    def test_pp_share_needs_its_mesh(self, net):
        from torch import nn

        from da3slam_tpu_torch.parallel.pp_forward import EncoderRest
        from da3slam_tpu_torch.slam.pipeline import PPParams

        share = PPParams(nn.ModuleList(), EncoderRest(net), nn.ModuleDict())
        with pytest.raises(ValueError, match="parallel='pp'"):
            run_streaming_slam(share, make_frames(), CFG, **KW)

    @pytest.mark.parametrize("mode", ["dp", "sp", "pp"])
    def test_segmented_equals_whole(self, spawned, mode):
        outs = spawned(mode, 2)["outs"]
        for name, a, b in zip(PipelineOutput._fields, outs["segmented"], outs["whole"]):
            np.testing.assert_array_equal(a, b, err_msg=name)
