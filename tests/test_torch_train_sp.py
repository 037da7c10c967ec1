"""The port's view-sharded train step (``make_sp_train_step``) and its
differentiable ring against the JAX package's ``make_sp_train_step``.

The port runs on gloo ranks on the CPU, one spawn per world size (2 and 4)
serving every test of it (``tests/test_torch_train_bodies.py``); the JAX
package runs here on ``make_mesh(n, tp=1)`` of the conftest's virtual
devices.  One window of 8 views at 28², f32.  Weights: the JAX seed-0
parameters carried over by ``convert``, conditioned as
``tests/test_torch_train_tp.py`` says (LayerScale 0.5, the camera output
layer x300, random target poses), so that every gradient is a quantity and
the cross-view ring moves the loss.  JAX's gradients are its first AdamW
moment after one step, / (1 − β1).

Bounds: the loss at rtol 1e-4, every gradient within 1e-4 of its max |g|
(or twice JAX's own sp-against-dense distance where that is larger:
``grad_bounds``), the second step's loss at rtol 1e-4; two steps against the port's dense
one-device step on the same window at rtol 1e-3 (``tests/test_parallel.py``'s
bound for JAX's sp against its dp step).  The ring alone: dq, dk and dv by
autograd through the ring (the flash backward's plain versions a hop)
against autograd through dense softmax attention in f64 and through the
port's one-device flash attention (``test_ring_backward_matches_dense``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.parallel import make_mesh as jmake_mesh
from da3slam_tpu.parallel import train as jtrain
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.ops.flash_attention import flash_attention
from da3slam_tpu_torch.parallel import run_ranks
from da3slam_tpu_torch.parallel import train

import test_torch_train_bodies as bodies
from test_torch_parallel import ring_inputs
from test_torch_train import jax_loss
from test_torch_train_tp import assert_grads_close, jax_grads_from_moments, jparams, whole_state

torch.set_num_threads(2)
SPAWN_TIMEOUT_S = 120
VIEWS, HW = 8, (28, 28)
WORLDS = (2, 4)


def make_window() -> dict:
    b = jtrain.synthetic_batch(jget_preset("tiny"), 1, VIEWS, HW, seed=0)
    b["extrinsics"] = b["extrinsics"] + np.random.default_rng(9).normal(
        scale=0.3, size=b["extrinsics"].shape).astype(np.float32)
    return {k: v[0] for k, v in b.items()}


def ring_cases(n: int) -> dict:
    """``(q, k, v, dO)``: ``tests/test_torch_parallel.py:ring_inputs``' normal
    ``[2, 8n, 3, 16]`` and its extreme logits (q and k scaled 20x, ``[1, 16,
    2, 8]``), with a seeded dO."""
    cases = {"normal": ring_inputs(n)["normal"], "extreme": ring_inputs(4)["extreme"]}
    rng = np.random.default_rng(7)
    return {name: (*qkv, rng.normal(size=qkv[0].shape).astype(np.float32))
            for name, qkv in cases.items()}


def dense_grads(q, k, v, do, dtype=torch.float64) -> list[np.ndarray]:
    """O, dq, dk, dv by autograd through softmax attention."""
    q, k, v = (torch.from_numpy(t).to(dtype).requires_grad_() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    o.backward(torch.from_numpy(do).to(dtype))
    return [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]


@pytest.fixture(scope="module")
def window():
    return make_window()


@pytest.fixture(scope="module")
def ranks(window):
    whole = whole_state(jparams({}))
    return {n: run_ranks(bodies.sp_checks, n, "gloo", "cpu", SPAWN_TIMEOUT_S, whole, window,
                         ring_cases(n))
            for n in WORLDS}


@pytest.fixture(scope="module")
def jax_runs(window):
    """JAX's make_sp_train_step on make_mesh(n, tp=1): two steps' losses and
    the first step's gradients."""
    out = {}
    for n in WORLDS:
        init_fn, step_fn, place = jtrain.make_sp_train_step(jget_preset("tiny"),
                                                            jmake_mesh(n, tp=1))
        state = init_fn(seed=0)
        state = state._replace(params=jax.tree.map(
            lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), state.params,
            jparams({})))
        losses, grads = [], None
        for i in range(2):
            state, loss = step_fn(state, place(window))
            losses.append(float(loss))
            if i == 0:
                grads = jax_grads_from_moments(state.opt_state[0].mu)
        out[n] = {"losses": losses, "grads": grads}
    return out


@pytest.fixture(scope="module")
def jax_dense(window):
    """The JAX package's dense one-device gradient on the same window."""
    _, g = jax.jit(jax.value_and_grad(jax_loss))(
        jax.tree.map(jnp.asarray, jparams({})),
        {k: jnp.asarray(v[None]) for k, v in window.items()})
    return {k: v.numpy() for k, v in convert(jax.tree.map(np.asarray, g)).items()}


def grad_bounds(jax_sp: dict, jax_dense: dict) -> dict:
    """Per parameter: 1e-4 of max |g|, or twice the JAX package's own
    distance between its sp and dense steps where that is larger (the camera
    head's biases, sums over views that cancel to f32 noise: 1.1e-4 to
    2.1e-4 of max |g| measured)."""
    out = {}
    for name, w in jax_sp.items():
        scale = np.abs(w).max()
        own = np.abs(w - jax_dense[name]).max() / scale if scale else 0.0
        out[name] = max(1e-4, 2 * own)
    return out


def assert_grads_within(got: dict, want: dict, bounds: dict) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        scale = np.abs(w).max()
        err = np.abs(got[name].astype(np.float64) - w).max()
        if scale == 0.0:
            assert err == 0.0, name
        else:
            assert err <= bounds[name] * scale, f"{name}: {err / scale:.2e} of max |g|"


@pytest.mark.parametrize("world", WORLDS)
class TestAgainstJax:
    def test_loss(self, ranks, jax_runs, world):
        np.testing.assert_allclose(ranks[world]["sp"]["losses"][0], jax_runs[world]["losses"][0],
                                   rtol=1e-4)

    def test_every_gradient(self, ranks, jax_runs, jax_dense, world):
        want = jax_runs[world]["grads"]
        assert_grads_within(ranks[world]["sp"]["grads"], want, grad_bounds(want, jax_dense))

    def test_second_step_loss(self, ranks, jax_runs, world):
        np.testing.assert_allclose(ranks[world]["sp"]["losses"][1], jax_runs[world]["losses"][1],
                                   rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
class TestStep:
    def test_two_steps_match_the_dense_step(self, ranks, window, world):
        """sp is a layout, not other math: the port's dense one-device step on
        the same window gives the same two losses."""
        init_fn, step_fn, place = train.make_train_step(get_preset("tiny"), "cpu")
        state = init_fn(seed=0)
        state.net.load_state_dict(convert(jparams({})), strict=True)
        batch = place({k: v[None] for k, v in window.items()})
        dense = [step_fn(state, batch)[1].item() for _ in range(2)]
        np.testing.assert_allclose(ranks[world]["sp"]["losses"], dense, rtol=1e-3)

    def test_parameters_stay_equal_across_ranks(self, ranks, world):
        assert len(set(ranks[world]["sp"]["params"])) == 1

    def test_remat_step(self, ranks, jax_runs, jax_dense, world):
        """cfg.remat recomputes each block, the ring's hops included, in the
        backward (every rank in the same order): the same loss and gradients."""
        remat, sp = ranks[world]["remat"], ranks[world]["sp"]
        assert remat["losses"][0] == sp["losses"][0]
        assert_grads_close(remat["grads"], sp["grads"], 1e-6)
        want = jax_runs[world]["grads"]
        assert_grads_within(remat["grads"], want, grad_bounds(want, jax_dense))

    def test_ranks_import_no_jax(self, ranks, world):
        assert ranks[world]["foreign"] == [[]] * world
        assert ranks[world]["host_bytes"] == [0] * world  # CPU tensors: nothing staged


def flash_grads(q, k, v, do) -> list[np.ndarray]:
    """O, dq, dk, dv by autograd through the port's one-device flash
    attention (the stable forward and the flash backward, plain versions)."""
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o = flash_attention(q, k, v, stable=True)
    o.backward(torch.from_numpy(do))
    return [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,tol_f64,tol_flash", [("normal", 2e-5, 1e-5),
                                                   ("extreme", 5e-4, 5e-4)])
def test_ring_backward_matches_dense(ranks, world, case, tol_f64, tol_flash):
    """The ring's autograd Function: its output and dq, dk, dv, put back
    together over the ranks, against dense attention's autograd in f64 and
    the port's one-device flash attention (each within its bound of the
    reference's max).  At the extreme logits the flash backward's
    p = exp2(q'·kᵀ − lse) takes exponents of ~1.4e3, whose f32 ulp is 1.2e-4,
    and the ring's lse is a fold of its blocks' (another rounding at that
    magnitude a hop): the one-device flash backward's dk is 1.4e-4 of its max
    from f64 there (dense f32 autograd: 5e-5), the ring's dq up to 3.2e-4
    from f64 and 4.0e-4 from the one-device flash (2 ranks; 4 ranks: 1.2e-4
    and 1.3e-4).  The bound there is 4 such ulps."""
    got = ranks[world]["ring"][case]
    want = dense_grads(*ring_cases(world)[case])
    one = flash_grads(*ring_cases(world)[case])
    for name, g, w, f in zip(("o", "dq", "dk", "dv"), got, want, one):
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= tol_f64, f"{name}: {err:.2e} of max from f64"
        err = np.abs(g - f).max() / np.abs(f).max()
        assert err <= tol_flash, f"{name}: {err:.2e} of max from the one-device flash"
