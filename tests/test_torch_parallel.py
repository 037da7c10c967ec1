"""The port's multi-device modules against ``da3slam_tpu.parallel``: the mesh,
ring attention, the view-sharded forward and the pipelined encoder.

The port runs on gloo ranks on the CPU, started by its own launcher
(``parallel/mesh.py:run_ranks``), one spawn per world size serving every
test of it (``tests/test_torch_rank_bodies.py`` holds what the ranks run:
they import neither JAX nor the JAX package).  The JAX package runs here, on
the conftest's 8 virtual devices.  Inputs are made from a seed with numpy;
the model is the tiny preset with the JAX seed-0 weights carried over by
``convert``, its LayerScale raised to 0.1 so that attention moves the
activations well above f32 rounding (at the preset's 1e-5 a wrong cross-view
attention would still pass).  f32 throughout: the ring against the JAX ring
and against dense attention at 2e-5 (the JAX test's bound), 1e-4 at the
extreme logits (likewise); whole forwards at 1e-4 (summation order differs
between the packages).
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from da3slam_tpu.models import vit as jvit
from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.parallel import make_mesh as jmake_mesh
from da3slam_tpu.parallel.pp_forward import make_pp_encode as jmake_pp_encode
from da3slam_tpu.parallel.pp_forward import split_encoder_params as jsplit_encoder_params
from da3slam_tpu.parallel.ring_attention import make_ring_cross_view_attention as jring
from da3slam_tpu.parallel.sp_forward import make_sharded_forward as jmake_sharded_forward
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net, forward_fn
from da3slam_tpu_torch.ops.flash_attention import flash_attention_stable_reference
from da3slam_tpu_torch.parallel import make_mesh, run_ranks
from da3slam_tpu_torch.parallel.mesh import mesh_shape
from da3slam_tpu_torch.parallel.ring_attention import fold_lse, ring_attention

import test_torch_rank_bodies as bodies

torch.set_num_threads(2)
CFG = get_preset("tiny")
SPAWN_TIMEOUT_S = 120
LAYERSCALE = 0.1
# make_mesh(n_devices, tp) cases at each world size: the defaults, explicit
# tp, a sub-mesh, too many devices and a tp that does not divide
MESH_CASES = [(None, None), (None, 1), (2, None), (2, 1), (None, 2), (5, None), (None, 3)]


def ring_inputs(n: int) -> dict:
    """The JAX ring test's inputs: normal ``[2, 8n, 3, 16]`` and, at 4 ranks,
    extreme logits (q and k scaled 20x, ``[1, 16, 2, 8]``)."""
    rng = np.random.default_rng(0)
    cases = {"normal": tuple(rng.normal(size=(2, 8 * n, 3, 16)).astype(np.float32)
                             for _ in range(3))}
    if n == 4:
        rng = np.random.default_rng(1)
        q, k = (rng.normal(size=(1, 16, 2, 8)) * 20 for _ in range(2))
        v = rng.normal(size=(1, 16, 2, 8))
        cases["extreme"] = tuple(t.astype(np.float32) for t in (q, k, v))
    return cases


def dense(q, k, v) -> np.ndarray:
    return np.asarray(jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v)))


@pytest.fixture(scope="module")
def jparams():
    p = jinit(jax.random.PRNGKey(0), jget_preset("tiny"))
    for blk in p["encoder"]["blocks"]:
        blk["ls1"] = jnp.full_like(blk["ls1"], LAYERSCALE)
        blk["ls2"] = jnp.full_like(blk["ls2"], LAYERSCALE)
    return p


@pytest.fixture(scope="module")
def state(jparams):
    return {k: v.numpy() for k, v in convert(jax.tree.map(np.asarray, jparams)).items()}


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).normal(size=(4, 28, 42, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def images_mb():
    return np.random.default_rng(0).normal(size=(3, 2, 28, 28, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(state, images, images_mb):
    """One spawn per world size: 2 (with the sp forward) and 4."""
    return {n: run_ranks(bodies.parallel_checks, n, "gloo", "cpu", SPAWN_TIMEOUT_S,
                         MESH_CASES, ring_inputs(n), state, images if n == 2 else None,
                         images_mb)
            for n in (2, 4)}


def jmesh_case(world: int, n, tp):
    try:
        m = jmake_mesh(n, tp, devices=jax.devices()[:world])
    except ValueError as e:
        return ("ValueError", str(e))
    return (m.axis_names, m.devices.shape)


class TestMeshShape:
    @pytest.mark.parametrize("n", range(1, 9))
    @pytest.mark.parametrize("tp", [None, 1, 2, 3, 4])
    def test_rules_equal_jax(self, n, tp):
        want = jmesh_case(8, n, tp)
        if want[0] == "ValueError":
            with pytest.raises(ValueError) as e:
                mesh_shape(n, tp)
            assert str(e.value) == want[1]
        else:
            assert mesh_shape(n, tp) == want[1]

    def test_needs_a_process_group(self):
        with pytest.raises(RuntimeError, match="initialised default process group"):
            make_mesh(device="cpu")


class TestMesh:
    @pytest.mark.parametrize("world", [2, 4])
    def test_meshes_equal_jax(self, ranks, world):
        """Axis names, shapes and error messages as JAX's on as many devices;
        each rank sits where JAX's dp-major reshape puts its device."""
        per_rank = ranks[world]["mesh"]
        for i, (n, tp) in enumerate(MESH_CASES):
            want = jmesh_case(world, n, tp)
            for r, got in enumerate(per_rank):
                assert got[i][:2] == want, (n, tp, r)
                if want[0] != "ValueError":
                    dp, tpn = want[1]
                    coord = (r // tpn, r % tpn) if r < dp * tpn else None
                    assert got[i][2] == coord, (n, tp, r)

    def test_default_tp_at_four(self, ranks):
        assert ranks[4]["mesh"][0][0][:2] == (("dp", "tp"), (2, 2))

    @pytest.mark.parametrize("world", [2, 4])
    def test_ranks_import_no_jax(self, ranks, world):
        assert ranks[world]["foreign"] == [[]] * world
        assert ranks[world]["host_bytes"] == [0] * world  # CPU tensors: nothing staged


class TestRingAttention:
    @pytest.mark.parametrize("world", [2, 4])
    @pytest.mark.parametrize("impl", ["plain", "flash"])
    def test_matches_jax_and_dense(self, ranks, world, impl):
        q, k, v = ring_inputs(world)["normal"]
        got = ranks[world]["ring"]["normal"][impl]
        jout = np.asarray(jax.jit(jring(jmake_mesh(world, tp=1), "dp"))(q, k, v))
        np.testing.assert_allclose(got, jout, atol=2e-5)
        np.testing.assert_allclose(got, dense(q, k, v), atol=2e-5)

    def test_extreme_logits(self, ranks):
        """The plain ring (the CPU's) holds logits of norm ~1e3, as JAX's."""
        q, k, v = ring_inputs(4)["extreme"]
        got = ranks[4]["ring"]["extreme"]["plain"]
        jout = np.asarray(jax.jit(jring(jmake_mesh(4, tp=1), "dp"))(q, k, v))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, jout, atol=1e-4)
        np.testing.assert_allclose(got, dense(q, k, v), atol=1e-4)

    @pytest.mark.parametrize("n_blocks", [2, 4])
    def test_lse_fold_extreme_logits(self, n_blocks):
        """The card's fold by base-2 lse, over blocks whose lse differ by
        hundreds: blocks from the online-softmax forward's plain version (the
        bound forward underflows at such logits by design), folded in the
        ring's order, against dense attention."""
        q, k, v = (torch.from_numpy(t) for t in ring_inputs(4)["extreme"])
        s = k.shape[1] // n_blocks
        acc = None
        for i in range(n_blocks):
            o, lse = flash_attention_stable_reference(q, k[:, i * s:(i + 1) * s],
                                                      v[:, i * s:(i + 1) * s])
            acc = (o.float(), lse) if acc is None else fold_lse(*acc, o, lse)
        assert np.isfinite(acc[0].numpy()).all()
        np.testing.assert_allclose(acc[0].numpy(), dense(q, k, v), atol=1e-4)

    def test_ring_of_one(self):
        q, k, v = (torch.from_numpy(t) for t in ring_inputs(2)["normal"])
        np.testing.assert_allclose(ring_attention(q, k, v, None).numpy(), dense(q, k, v),
                                   atol=2e-5)


class TestCrossAttnDispatch:
    @pytest.mark.parametrize("w8a8", [False, True])
    def test_only_cross_view_blocks_take_it(self, state, images, w8a8):
        """``encode(cross_attn_impl=fn)`` sends the cross-view blocks (and
        only those) to ``fn``, in the float and the W8A8 block alike."""
        from da3slam_tpu_torch.models import vit
        from da3slam_tpu_torch.ops.attention import multi_head_attention

        net = DA3Net(CFG)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        if w8a8:
            vit.quantize_encoder(net)
        calls = []

        def recorder(q, k, v):
            calls.append(tuple(q.shape))
            return multi_head_attention(q, k, v)

        x = torch.from_numpy(images[:2])
        with torch.no_grad():
            taps, final, _ = vit.encode(net, x, CFG, cross_attn_impl=recorder)
            ref_taps, ref_final, _ = vit.encode(net, x, CFG)
        S = vit.num_prefix_tokens(CFG) + (28 // CFG.patch_size) * (42 // CFG.patch_size)
        n_cross = sum(i % CFG.cross_view_interval == CFG.cross_view_interval - 1
                      for i in range(CFG.depth))
        heads = CFG.num_heads
        assert calls == [(1, 2 * S, heads, CFG.embed_dim // heads)] * n_cross
        assert torch.equal(final, ref_final)
        assert all(torch.equal(a, b) for a, b in zip(taps, ref_taps))


class TestShardedForward:
    def test_matches_jax(self, ranks, jparams, images):
        got = ranks[2]["sp"]["pred"]
        jout = jmake_sharded_forward(jget_preset("tiny"), jmake_mesh(2, tp=1))(jparams, images)
        for key in ("depth", "conf", "extrinsics", "intrinsics", "rays"):
            np.testing.assert_allclose(got[key], np.asarray(jout[key]), atol=1e-4, rtol=1e-4,
                                       err_msg=key)

    def test_matches_single_device(self, ranks, state, images):
        """Sharding the views is a layout, not other math: the port's own
        forward on one device gives the same prediction."""
        got = ranks[2]["sp"]["pred"]
        net = DA3Net(CFG)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        with torch.no_grad():
            ref = forward_fn(net.eval(), torch.from_numpy(images), CFG)
        for key in ("depth", "conf", "extrinsics", "intrinsics", "rays"):
            np.testing.assert_allclose(got[key], ref[key].numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=key)

    def test_every_rank_returns_the_whole(self, ranks):
        assert len(set(ranks[2]["sp"]["digests"])) == 1

    def test_attention_matters_here(self, ranks, state, images):
        """At LayerScale 0.1 the cross-view attention moves the outputs: the
        same forward with its cross-view blocks made intra-view differs."""
        import dataclasses

        net = DA3Net(CFG)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        with torch.no_grad():
            alt = forward_fn(net.eval(), torch.from_numpy(images),
                             dataclasses.replace(CFG, cross_view_interval=10**6))
        assert np.abs(ranks[2]["sp"]["pred"]["depth"] - alt["depth"].numpy()).max() > 1e-3


class TestPPEncode:
    @pytest.mark.parametrize("world", [2, 4])
    def test_matches_jax(self, ranks, jparams, images_mb, world):
        got = ranks[world]["pp"]
        mesh = Mesh(np.asarray(jax.devices()[:world]), axis_names=("pp",))
        stage_params, rest = jsplit_encoder_params(jparams["encoder"], world, mesh)
        taps, final = jmake_pp_encode(jget_preset("tiny"), mesh, world)(stage_params, rest,
                                                                         images_mb)
        np.testing.assert_allclose(got["final"], np.asarray(final), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["taps"], np.asarray(taps), atol=1e-4, rtol=1e-4)
        # and the sequential encoder's taps, per microbatch
        for m in range(images_mb.shape[0]):
            jt, jf, _ = jvit.encode(jparams["encoder"], images_mb[m], jget_preset("tiny"),
                                    attn_impl="xla")
            np.testing.assert_allclose(got["taps"][m], np.stack(jt), atol=1e-4, rtol=1e-4)
        assert len(set(got["digests"])) == 1

    @pytest.mark.parametrize("world", [2, 4])
    def test_stage_holds_its_share(self, ranks, state, world):
        """Each rank holds its blocks' share of the parameters plus the rest:
        patch embed, tokens, positions and the final norm."""
        blocks = sum(v.size for k, v in state.items() if k.startswith("blocks."))
        rest = sum(v.size for k, v in state.items()
                   if not k.startswith(("blocks.", "depth_head.", "camera_head.")))
        assert ranks[world]["pp"]["params"] == [blocks // world + rest] * world

    def test_stages_must_divide_depth(self):
        from da3slam_tpu_torch.parallel.pp_forward import split_encoder_params

        with pytest.raises(ValueError, match="must divide"):
            split_encoder_params(DA3Net(CFG), 3, 0)


class TestRunRanks:
    def test_failing_rank_fails_the_call(self):
        """Rank 1 raises while rank 0 waits in a collective: the caller gets
        rank 1's traceback at once, not at the time limit."""
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed:(.|\n)*boom on rank 1"):
            run_ranks(bodies.fail_on_rank, 2, "gloo", "cpu", 60, 1)
        assert time.monotonic() - t0 < 45

    def test_dead_rank_fails_the_call(self):
        with pytest.raises(RuntimeError, match="rank 0 died with exit code 3"):
            run_ranks(bodies.exit_on_rank, 2, "gloo", "cpu", 60, 0)

    def test_hung_ranks_time_out(self):
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="did not finish within 8 s"):
            run_ranks(bodies.fail_on_rank, 2, "gloo", "cpu", 8, None)
        assert time.monotonic() - t0 < 30

    def test_returns_rank_zero(self):
        assert run_ranks(bodies.rank_and_world, 3, "gloo", "cpu", 60) == (0, 3)
