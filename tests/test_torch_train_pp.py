"""The port's pipeline-parallel train step (``make_pp_train_step``: GPipe
forward and backward over the stages) against the JAX package's
``make_pp_train_step`` and against the sequential encoder's gradients.

The port runs on 2 gloo ranks on the CPU, one spawn serving every test
(``tests/test_torch_train_bodies.py``); the JAX package runs here on a
2-device ``("pp",)`` mesh of the conftest's virtual devices.  2 stages, M = 3
microbatches of N = 2 views at 28² (``tests/test_pp_forward.py``'s shapes),
f32.  Weights: the JAX seed-0 parameters carried over by ``convert``, with
LayerScale 0.1 (at the preset's 1e-5 the blocks barely move the taps).  The
loss is the depth loss alone on the replicated DPT head, as in JAX; the
camera head is not part of the pp state.  JAX's gradients are its first
AdamW moment after one step, / (1 − β1).

Bounds: the loss at rtol 1e-4 (the second step's too); every gradient
against JAX's pp step and against ``jax.grad`` of the sequential encoder at
``tests/test_pp_forward.py``'s own bound, atol 2e-4 and rtol 2e-3 (the
pipeline reorders f32 sums).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from da3slam_tpu.models import dpt as jdpt
from da3slam_tpu.models import vit as jvit
from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.parallel import train as jtrain
from da3slam_tpu.parallel.pp_forward import split_encoder_params as jsplit
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.parallel import run_ranks

import test_torch_train_bodies as bodies
from test_torch_train_tp import BETA1

torch.set_num_threads(2)
SPAWN_TIMEOUT_S = 120
LAYERSCALE = 0.1
STAGES, M, N, HW = 2, 3, 2, (28, 28)
CFG = get_preset("tiny")
JCFG = jget_preset("tiny")


def jparams() -> dict:
    p = jax.tree.map(np.array, jinit(jax.random.PRNGKey(0), JCFG))
    for blk in p["encoder"]["blocks"]:
        blk["ls1"] = np.full_like(blk["ls1"], LAYERSCALE)
        blk["ls2"] = np.full_like(blk["ls2"], LAYERSCALE)
    return p


def make_batches() -> list[dict]:
    out = []
    for step in range(2):
        rng = np.random.default_rng(step)
        out.append({"images": rng.normal(size=(M, N, *HW, 3)).astype(np.float32),
                    "depth": rng.uniform(0.5, 3.0, size=(M, N, *HW)).astype(np.float32)})
    return out


def port_names(tree: dict) -> dict:
    """A full JAX pytree (camera zeros) in the port's names, without the
    camera head (not in the pp state)."""
    return {k: v.numpy() for k, v in convert(tree).items() if not k.startswith("camera_head.")}


def full_tree(stage, rest, dpt, like: dict) -> dict:
    """(stage-stacked blocks, rest, dpt) back into the full pytree."""
    stage = jax.tree.map(np.asarray, stage)
    per = JCFG.depth // STAGES
    blocks = [jax.tree.map(lambda a, s=s, j=j: a[s, j], stage)
              for s in range(STAGES) for j in range(per)]
    return {"encoder": {**jax.tree.map(np.asarray, rest), "blocks": blocks},
            "dpt": jax.tree.map(np.asarray, dpt),
            "camera": jax.tree.map(np.zeros_like, like["camera"])}


@pytest.fixture(scope="module")
def batches():
    return make_batches()


@pytest.fixture(scope="module")
def ranks(batches):
    whole = {k: v.numpy() for k, v in convert(jparams()).items()}
    return run_ranks(bodies.pp_run, STAGES, "gloo", "cpu", SPAWN_TIMEOUT_S, whole, batches)


@pytest.fixture(scope="module")
def jax_pp(batches):
    """JAX's make_pp_train_step: two steps' losses, the first's gradients."""
    mesh = Mesh(np.asarray(jax.devices()[:STAGES]), axis_names=("pp",))
    init_fn, step_fn, place = jtrain.make_pp_train_step(JCFG, mesh, STAGES)
    state = init_fn(seed=0)
    full = jparams()
    stage, rest = jsplit(full["encoder"], STAGES)
    state = state._replace(params=jax.tree.map(
        lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), state.params,
        (stage, rest, full["dpt"])))
    losses, grads = [], None
    for i, b in enumerate(batches):
        state, loss = step_fn(state, place(b))
        losses.append(float(loss))
        if i == 0:
            mu = jax.tree.map(lambda m: np.asarray(m, np.float64) / (1 - BETA1),
                              state.opt_state[0].mu)
            grads = port_names(full_tree(*mu, like=full))
    return {"losses": losses, "grads": grads}


@pytest.fixture(scope="module")
def jax_sequential(batches):
    """``jax.grad`` of the same loss through the sequential encoder
    (``tests/test_pp_forward.py``'s ``seq_loss``)."""
    images, gt = (jnp.asarray(batches[0][k]) for k in ("images", "depth"))

    def seq_loss(params):
        def per_mb(imgs):
            taps, _, grid = jvit.encode(params["encoder"], imgs, JCFG, attn_impl="xla")
            depth, conf, _ = jdpt.apply_dpt(params["dpt"], taps, grid, HW, JCFG)
            return depth, conf
        depth, conf = jax.vmap(per_mb)(images)
        flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
        return jtrain.depth_loss(flat(depth), flat(conf), flat(gt))

    full = jparams()
    g = jax.jit(jax.grad(seq_loss))(jax.tree.map(jnp.asarray, full))
    return port_names(jax.tree.map(np.asarray, g))


def assert_grads_allclose(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=2e-4, rtol=2e-3, err_msg=name)


class TestAgainstJax:
    def test_loss(self, ranks, jax_pp):
        np.testing.assert_allclose(ranks["losses"][0], jax_pp["losses"][0], rtol=1e-4)

    def test_second_step_loss(self, ranks, jax_pp):
        np.testing.assert_allclose(ranks["losses"][1], jax_pp["losses"][1], rtol=1e-4)

    def test_every_gradient_against_jax_pp(self, ranks, jax_pp):
        assert_grads_allclose(ranks["grads"], jax_pp["grads"])

    def test_every_gradient_against_sequential(self, ranks, jax_sequential):
        assert_grads_allclose(ranks["grads"], jax_sequential)

    def test_gradients_are_not_trivial(self, ranks):
        """The taps' gradients reach every stage's blocks (LayerScale 0.1): a
        stage whose blocks got none, or a head gradient counted twice, would
        show here and above."""
        g = ranks["grads"]
        for i in range(CFG.depth):
            assert np.abs(g[f"blocks.{i}.attn.qkv.weight"]).max() > 1e-6, i


class TestStages:
    def test_stage_blocks_only_on_their_stage(self, ranks):
        """Rank s holds blocks s·depth/S .. and their moments; every rank holds
        the rest of the encoder and the DPT head; no rank the camera head."""
        per = CFG.depth // STAGES
        for s, (names, moments) in enumerate(zip(ranks["names"], ranks["moments"])):
            blocks = {int(n.split(".")[1]) for n in names if n.startswith("blocks.")}
            assert blocks == set(range(s * per, (s + 1) * per))
            assert sorted(names) == moments
            assert not any(n.startswith("camera_head.") for n in names)
            assert any(n.startswith("depth_head.") for n in names)
            assert "patch_embed.proj.weight" in names and "norm.weight" in names

    def test_replicated_parameters_bit_equal(self, ranks):
        """The rest and the DPT head, after 2 steps, the same bits on each rank."""
        assert len(set(ranks["replicated"])) == 1

    def test_ranks_import_no_jax(self, ranks):
        assert ranks["foreign"] == [[], []]
