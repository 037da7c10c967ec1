"""The port's dp×tp train step (``make_train_step(..., mesh=...)``) against
the JAX package's ``make_train_step`` on a ``(dp, tp)`` mesh, and its
checkpoints.

The port runs on gloo ranks on the CPU, one spawn per world size serving
every test of it (``tests/test_torch_train_bodies.py``): meshes (1, 2) on 2
ranks, with the GELU MLP and with SwiGLU (the rule that splits ``w12``), and
(2, 2) on 4.  The JAX package runs here on the conftest's virtual devices,
on ``make_mesh(2, tp=2)`` and ``make_mesh(4, tp=2)``.  Weights: the JAX
seed-0 parameters carried over by ``convert``, conditioned as
``tests/test_torch_train.py`` conditions them: LayerScale 0.5, the camera
output layer x300 and random target poses.  At the preset's LayerScale 1e-5
the blocks barely move the activations and a wrongly sharded block would
still pass.  At 0.1 they move them, but the camera head's bias gradients
are then sums over views that cancel to f32 noise: JAX's own tp step and its
one-device step differ there by 1.7e-4 of max |g| (2.6e-4 at 4 views), so
no implementation can be held to 1e-4; at 0.5 that difference is 3.6e-5.
Inputs from numpy with a seed; f32.

The JAX step returns no gradient; after its first AdamW step from zero
moments the first moment is (1 − β1)·g, so g = mu / (1 − β1) to an f32
rounding.  Bounds: the loss at rtol 1e-4 (JAX's own tp-against-one-device
bound is 2e-4, ``tests/test_parallel.py``), every parameter's gradient put
back together within 1e-4 of its largest |g|, the second step's loss at
rtol 1e-4.  Against the port's own one-device step (the same operations,
the sums split over ranks): the loss at rtol 1e-6, the encoder blocks'
gradients (the tp-split tensors among them) within 1e-5 of their max |g|
(7e-7 measured), the whole gradient at 1e-5 relative L2 (3.4e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.parallel import make_mesh as jmake_mesh
from da3slam_tpu.parallel import train as jtrain
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.parallel import run_ranks
from da3slam_tpu_torch.parallel import train
from da3slam_tpu_torch.parallel.checkpoint import restore_train_state
from da3slam_tpu_torch.parallel.sharding import spec_for

import test_torch_train_bodies as bodies

torch.set_num_threads(2)
SPAWN_TIMEOUT_S = 120
LAYERSCALE = 0.5
SWIGLU = {"mlp_type": "swiglu", "mlp_ratio": 4.0}
# name -> (config overrides, devices, tp)
RUNS = {"gelu_1x2": ({}, 2, 2), "swiglu_1x2": (SWIGLU, 2, 2), "gelu_2x2": ({}, 4, 2)}
HW = (28, 28)
VIEWS = 2
N_STEPS = 4  # the checkpoint run saves after step 2 and resumes for steps 3-4
BETA1 = train.ADAMW_BETAS[0]


def jparams(cfg_kw: dict) -> dict:
    p = jax.tree.map(np.array, jinit(jax.random.PRNGKey(0), jget_preset("tiny").with_overrides(
        **cfg_kw)))
    for blk in p["encoder"]["blocks"]:
        blk["ls1"] = np.full_like(blk["ls1"], LAYERSCALE)
        blk["ls2"] = np.full_like(blk["ls2"], LAYERSCALE)
    p["camera"]["w_out"] = p["camera"]["w_out"] * 300
    return p


def make_batches() -> list[dict]:
    """2 windows x 2 views at 28² a step, random target poses."""
    out = []
    for step in range(N_STEPS):
        b = jtrain.synthetic_batch(jget_preset("tiny"), 2, VIEWS, HW, seed=step)
        b["extrinsics"] = b["extrinsics"] + np.random.default_rng(9 + step).normal(
            scale=0.3, size=b["extrinsics"].shape).astype(np.float32)
        out.append(b)
    return out


def whole_state(params: dict) -> dict:
    return {k: v.numpy() for k, v in convert(params).items()}


def jax_grads_from_moments(mu) -> dict:
    """g = mu / (1 − β1) after one AdamW step from zero moments, carried into
    the port's layout."""
    return {k: v.numpy() for k, v in convert(jax.tree.map(
        lambda m: np.asarray(m, np.float64) / (1 - BETA1), mu)).items()}


def assert_grads_close(got: dict, want: dict, rel: float) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        scale = np.abs(w).max()
        err = np.abs(got[name].astype(np.float64) - w).max()
        if scale == 0.0:  # the cls row of pos_embed, the unused DPT unit
            assert err == 0.0, name
        else:
            assert err <= rel * scale, f"{name}: {err / scale:.2e} of max |g|"


@pytest.fixture(scope="module")
def batches():
    return make_batches()


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_ckpt") / "latest")


@pytest.fixture(scope="module")
def ranks(batches, ckpt_path):
    """One spawn per world size: 2 (GELU and SwiGLU, the GELU run saving a
    checkpoint) and 4."""
    out = {}
    for world in (2, 4):
        runs = {name: (kw, n, tp, whole_state(jparams(kw)), batches,
                       ckpt_path if name == "gelu_1x2" else None)
                for name, (kw, n, tp) in RUNS.items() if n == world}
        out.update(run_ranks(bodies.tp_checks, world, "gloo", "cpu", SPAWN_TIMEOUT_S, runs))
    return out


def jax_run(name: str, batches: list) -> dict:
    """JAX's make_train_step on make_mesh(n, tp=2): two steps' losses and the
    first step's gradients."""
    kw, n, tp = RUNS[name]
    init_fn, step_fn, place = jtrain.make_train_step(
        jget_preset("tiny").with_overrides(**kw), jmake_mesh(n, tp=tp))
    state = init_fn(seed=0)
    state = state._replace(params=jax.tree.map(
        lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), state.params,
        jparams(kw)))
    losses, grads = [], None
    for i in range(2):
        state, loss = step_fn(state, place(batches[i]))
        losses.append(float(loss))
        if i == 0:
            grads = jax_grads_from_moments(state.opt_state[0].mu)
    return {"losses": losses, "grads": grads}


@pytest.fixture(scope="module")
def jax_runs(batches):
    return {name: jax_run(name, batches) for name in RUNS}


def port_single(kw: dict, batches: list, steps: int) -> dict:
    """The port's one-device step from the same weights."""
    cfg = get_preset("tiny").with_overrides(**kw)
    init_fn, step_fn, place = train.make_train_step(cfg, "cpu")
    state = init_fn(seed=0)
    state.net.load_state_dict(convert(jparams(kw)), strict=True)
    losses, grads = [], None
    for i in range(steps):
        state, loss = step_fn(state, place(batches[i]))
        losses.append(loss.item())
        if i == 0:
            grads = {k: p.grad.numpy().copy() for k, p in state.net.named_parameters()}
    return {"losses": losses, "grads": grads}


@pytest.mark.parametrize("name", list(RUNS))
class TestAgainstJax:
    def test_loss(self, ranks, jax_runs, name):
        np.testing.assert_allclose(ranks[name]["losses"][0], jax_runs[name]["losses"][0],
                                   rtol=1e-4)

    def test_every_gradient(self, ranks, jax_runs, name):
        assert_grads_close(ranks[name]["grads"], jax_runs[name]["grads"], 1e-4)

    def test_second_step_loss(self, ranks, jax_runs, name):
        np.testing.assert_allclose(ranks[name]["losses"][1], jax_runs[name]["losses"][1],
                                   rtol=1e-4)


@pytest.mark.parametrize("name", list(RUNS))
class TestShards:
    def test_replicated_parameters_bit_equal(self, ranks, name):
        """After every step (here 4), each rank's replicated parameters are
        the same bits (JAX: ``is_fully_replicated``)."""
        assert len(set(ranks[name]["replicated"])) == 1

    def test_each_rank_holds_its_shard(self, ranks, name):
        """Column-parallel tensors hold out/tp rows, row-parallel ones in/tp
        columns, and the AdamW moments are shaped as their parameters."""
        kw, _, tp = RUNS[name]
        whole = whole_state(jparams(kw))
        for shapes, moments in zip(ranks[name]["shapes"], ranks[name]["moment_shapes"]):
            assert shapes == moments
            for nm, shape in shapes.items():
                want = list(whole[nm].shape)
                if spec_for(nm):
                    want[spec_for(nm).index("tp")] //= tp
                assert list(shape) == want, nm

    def test_ranks_import_no_jax(self, ranks, name):
        assert all(f == [] for f in ranks[name]["foreign"])


def rel_l2(got: dict, want: dict) -> float:
    a, b = (np.concatenate([d[k].ravel() for k in sorted(want)]).astype(np.float64)
            for d in (got, want))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", ["gelu_1x2", "swiglu_1x2"])
def test_matches_own_single_device_step(ranks, batches, name):
    """The mesh is a layout: the port's one-device step from the same weights
    gives the same losses and gradients, tighter than against JAX."""
    single = port_single(RUNS[name][0], batches, 2)
    np.testing.assert_allclose(ranks[name]["losses"][:2], single["losses"], rtol=1e-6)
    blocks = [k for k in single["grads"] if k.startswith("blocks.")]
    assert_grads_close({k: ranks[name]["grads"][k] for k in blocks},
                       {k: single["grads"][k] for k in blocks}, 1e-5)
    assert rel_l2(ranks[name]["grads"], single["grads"]) <= 1e-5


class TestCheckpoint:
    def test_resume_gives_the_same_losses(self, ranks):
        """Saved after step 2 on the (1, 2) mesh, restored into a state made
        from another seed: steps 3-4 give the uninterrupted run's losses."""
        run = ranks["gelu_1x2"]
        assert run["resumed_step"] == 2
        assert run["resumed"] == run["losses"][2:]

    def test_tp2_checkpoint_resumes_at_tp1(self, ranks, batches, ckpt_path):
        """The file holds whole tensors: the one-device step restores it and
        runs step 3 to the (1, 2) run's loss."""
        init_fn, step_fn, place = train.make_train_step(get_preset("tiny"), "cpu")
        state = restore_train_state(ckpt_path, init_fn(seed=1))
        assert state.step == 2
        _, loss = step_fn(state, place(batches[2]))
        np.testing.assert_allclose(loss.item(), ranks["gelu_1x2"]["losses"][2], rtol=1e-5)
