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
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.slam.alignment import AlignmentConfig as JAlignmentConfig
from da3slam_tpu.slam.pipeline import make_windows as jmake_windows
from da3slam_tpu.slam.pipeline import run_streaming_slam as jrun_streaming_slam
from da3slam_tpu_torch.core.transforms import se3_inverse, se3_to_4x4
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net, DepthAnything3
from da3slam_tpu_torch.slam.alignment import AlignmentConfig
from da3slam_tpu_torch.slam.chunks import make_image_chunks, run_chunked_alignment
from da3slam_tpu_torch.slam.pipeline import (
    PipelineOutput,
    make_windows,
    run_pipeline,
    run_streaming_slam,
)
from da3slam_tpu_torch.slam.solver import SLAMSolver

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
        with pytest.raises(NotImplementedError, match="queue 1, item 14"):
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
