"""The port's training path against ``da3slam_tpu.parallel.train`` on the
tiny preset.

The JAX package's seed-0 parameters cross over through
``da3slam_tpu_torch.models.convert``, and so do its gradients: ``convert``
maps any pytree shaped like the parameters.  Inputs are made from a seed
with numpy and fed to both packages.  f32 on the CPU; the JAX side runs
XLA's softmax attention and its gradient, the port the plain bound forward
and the plain flash backward.  Tolerances are stated per test.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import forward_fn as jforward
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.parallel import make_mesh
from da3slam_tpu.parallel import train as jtrain
from da3slam_tpu_torch.cli import train as cli
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.parallel import train
from da3slam_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state

torch.set_num_threads(2)
CFG = get_preset("tiny")
JCFG = jget_preset("tiny")
HW = (28, 28)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), JCFG))


def port_state(jparams, cfg=CFG, lr=1e-4, dtype=torch.float32):
    """A port TrainState holding the JAX package's parameters."""
    init_fn, step_fn, place = train.make_train_step(cfg, "cpu", learning_rate=lr, dtype=dtype)
    state = init_fn(seed=0)
    state.net.load_state_dict(convert(jparams), strict=True)
    return state, step_fn, place


def port_grads(state, batch, cfg=CFG, dtype=torch.float32):
    """The step's loss and gradients, without the update."""
    n = batch["images"].shape[0]
    state.optimizer.zero_grad(set_to_none=True)
    total = 0.0
    for w in range(n):
        loss = train.window_loss(state.net, cfg, batch["images"][w], batch["depth"][w],
                                 batch["extrinsics"][w], dtype)
        (loss / n).backward()
        total += loss.item() / n
    train.fill_unused_grads(state.net)
    return total, {k: p.grad.clone() for k, p in state.net.named_parameters()}


def jax_loss(params, batch, dtype=jnp.float32):
    """The JAX package's make_train_step loss: its forward and losses, vmapped
    over windows and averaged."""
    def per_window(images, gt_depth, gt_ext):
        out = jforward(params, images, JCFG, dtype=dtype)
        return (jtrain.depth_loss(out["depth"], out["conf"], gt_depth)
                + jtrain.pose_loss(out["extrinsics"], gt_ext))

    return jnp.mean(jax.vmap(per_window)(batch["images"], batch["depth"], batch["extrinsics"]))


def loss_inputs(seed, n=2, invalid=True):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.1, 4.0, size=(n, 14, 18)).astype(np.float32)
    gt = rng.uniform(0.5, 3.0, size=(n, 14, 18)).astype(np.float32)
    if invalid:
        gt[rng.random(gt.shape) < 0.3] = 0.0  # invalid pixels
    conf = 1.0 + rng.uniform(0.0, 2.0, size=(n, 14, 18)).astype(np.float32)
    return depth, conf, gt


class TestLosses:
    @pytest.mark.parametrize("invalid", [False, True])
    def test_depth_loss(self, invalid):
        """Same sums in another order: 1e-6 relative."""
        depth, conf, gt = loss_inputs(1, invalid=invalid)
        j = float(jtrain.depth_loss(jnp.asarray(depth), jnp.asarray(conf), jnp.asarray(gt)))
        t = train.depth_loss(*(torch.from_numpy(x) for x in (depth, conf, gt))).item()
        np.testing.assert_allclose(t, j, rtol=1e-6)

    def test_invalid_pixels_drop_out(self):
        """Changing the prediction where the ground truth is invalid changes
        neither loss."""
        depth, conf, gt = loss_inputs(2)
        mask = gt == 0.0
        depth2, conf2 = depth.copy(), conf.copy()
        depth2[mask] *= 3.0
        conf2[mask] += 5.0
        a = train.depth_loss(*(torch.from_numpy(x) for x in (depth, conf, gt))).item()
        b = train.depth_loss(*(torch.from_numpy(x) for x in (depth2, conf2, gt))).item()
        assert a == b

    def test_all_invalid_is_zero_not_nan(self):
        depth, conf, gt = loss_inputs(3)
        t = train.depth_loss(torch.from_numpy(depth), torch.from_numpy(conf),
                             torch.zeros_like(torch.from_numpy(gt))).item()
        assert t == 0.0

    def test_pose_loss(self):
        rng = np.random.default_rng(4)
        a, b = (rng.normal(size=(3, 3, 4)).astype(np.float32) for _ in range(2))
        j = float(jtrain.pose_loss(jnp.asarray(a), jnp.asarray(b)))
        t = train.pose_loss(torch.from_numpy(a), torch.from_numpy(b)).item()
        np.testing.assert_allclose(t, j, rtol=1e-6)


def conditioned(jparams):
    """The JAX parameters with LayerScale 0.5 and the camera output layer x300,
    and a batch with random target poses (see test_loss_and_grads_match_jax)."""
    jparams = jax.tree.map(np.copy, jparams)
    for blk in jparams["encoder"]["blocks"]:
        blk["ls1"] = np.full_like(blk["ls1"], 0.5)
        blk["ls2"] = np.full_like(blk["ls2"], 0.5)
    jparams["camera"]["w_out"] = jparams["camera"]["w_out"] * 300
    batch = jtrain.synthetic_batch(JCFG, 2, 2, HW, seed=5)
    batch["extrinsics"] = batch["extrinsics"] + np.random.default_rng(9).normal(
        scale=0.3, size=batch["extrinsics"].shape).astype(np.float32)
    return jparams, batch


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).sum() / (b ** 2).sum()))


class TestBf16Step:
    """``make_train_step(dtype=torch.bfloat16)`` against the JAX package's
    ``make_train_step(dtype=jnp.bfloat16)``: bf16 activations, f32 parameters,
    gradients, loss and AdamW state in both.  The two round at other places
    (XLA's softmax attention against the flash formula, bf16 sums in XLA's
    reductions against f32 ones in torch), so they are held to each other
    through what bf16 itself costs: the JAX package's own f32 step is the
    reference, its bf16 step's distance from it is measured in the test, and
    the port's bf16 step may be no further from the reference than 1.5 times
    that.  Measured on these inputs: loss 5.4e-3 relative (JAX's bf16: 5.7e-3);
    whole gradient 2.8e-2 relative L2 (JAX's: 3.0e-2); per parameter at most
    1.31 times JAX's own error (its worst: 0.70, a bias of the head's last
    conv, summed in bf16)."""

    @pytest.fixture(scope="class")
    def grads(self, jparams):
        jparams, batch = conditioned(jparams)
        out = {}
        for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            loss, g = jax.jit(jax.value_and_grad(
                lambda p, b, dtype=dtype: jax_loss(p, b, dtype)))(
                jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, batch))
            out[name] = (float(loss), {k: v.numpy() for k, v in convert(
                jax.tree.map(lambda x: np.asarray(x, np.float32), g)).items()})
        state, _, place = port_state(jparams, dtype=torch.bfloat16)
        loss_t, grads_t = port_grads(state, place(batch), dtype=torch.bfloat16)
        out["port"] = (loss_t, {k: g.numpy() for k, g in grads_t.items()})
        out["dtypes"] = {g.dtype for g in grads_t.values()}
        return out

    def test_loss(self, grads):
        ref, jax_bf16, port = (grads[k][0] for k in ("f32", "bf16", "port"))
        assert abs(port - ref) <= 1.5 * abs(jax_bf16 - ref)
        assert abs(port - jax_bf16) <= 2.5 * abs(jax_bf16 - ref)  # the triangle's third side

    def test_gradients_are_f32_master_gradients(self, grads):
        assert grads["dtypes"] == {torch.float32}

    def test_whole_gradient(self, grads):
        ref, jax_bf16, port = (grads[k][1] for k in ("f32", "bf16", "port"))
        cat = lambda g: np.concatenate([g[k].ravel() for k in sorted(ref)])  # noqa: E731
        own = rel_l2(cat(jax_bf16), cat(ref))
        assert rel_l2(cat(port), cat(ref)) <= 1.5 * own
        # and the two bf16 steps are nearer each other than JAX's is to f32
        assert rel_l2(cat(port), cat(jax_bf16)) <= own

    def test_every_parameters_gradient(self, grads):
        ref, jax_bf16, port = (grads[k][1] for k in ("f32", "bf16", "port"))
        assert set(port) == set(ref)
        for name, r in ref.items():
            if not np.abs(r).max():
                assert not np.abs(port[name]).max(), name  # the cls row, the unused unit
                continue
            assert rel_l2(port[name], r) <= 1.5 * rel_l2(jax_bf16[name], r), name

    def test_one_adamw_update(self, jparams):
        """One step of both ``step_fn``s from the same parameters.  At step 1
        AdamW moves every element by lr·g/(|g| + eps): ±lr whatever |g|, so an
        element whose gradient changes sign between the two bf16 runs differs
        by 2·lr (0.5% of them do), and no element by more; the mean difference
        is 1.1e-6 measured, held to 5e-6."""
        jparams, batch = conditioned(jparams)
        lr = 1e-4
        init_j, step_j, place_j = jtrain.make_train_step(JCFG, make_mesh(1), learning_rate=lr,
                                                         dtype=jnp.bfloat16)
        state_j = init_j(seed=0)._replace(params=jax.tree.map(jnp.asarray, jparams))
        state_j, loss_j = step_j(state_j, place_j(batch))
        after_j = convert(jax.tree.map(np.asarray, state_j.params))
        state_t, step_t, place_t = port_state(jparams, lr=lr, dtype=torch.bfloat16)
        state_t, loss_t = step_t(state_t, place_t(batch))
        assert loss_t.dtype == torch.float32 and state_t.step == int(state_j.step) == 1
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2e-2)
        total, count = 0.0, 0
        for name, p in state_t.net.named_parameters():
            assert p.dtype == torch.float32, name
            diff = np.abs(p.detach().numpy() - after_j[name].numpy())
            assert diff.max() <= 2.001 * lr, name
            total, count = total + diff.sum(), count + diff.size
        assert total / count <= 5e-6


class TestStep:
    def test_loss_and_grads_match_jax(self, jparams):
        """One step's loss and every parameter's gradient, 2 windows x 2 views
        at 28², against jax.value_and_grad of the JAX forward + losses (its
        gradients carried over by ``convert``).

        The weights are conditioned so that every gradient is a quantity and
        not f32 noise: the poses are relative to view 0, so with the init's
        LayerScale 1e-5 (the views' camera tokens nearly equal) and its 1e-3
        camera output layer (every rotation near the identity) the camera
        head's gradients cancel to ~1e-20.  LayerScale 0.5, the output layer
        x300 and random target poses fix that.  f32, the same function, the
        sums in another order: ≤ 4.2e-5 of each parameter's max |g| measured,
        1e-4 (loss: 1e-6 relative)."""
        jparams = jax.tree.map(np.copy, jparams)
        for blk in jparams["encoder"]["blocks"]:
            blk["ls1"] = np.full_like(blk["ls1"], 0.5)
            blk["ls2"] = np.full_like(blk["ls2"], 0.5)
        jparams["camera"]["w_out"] = jparams["camera"]["w_out"] * 300
        batch = jtrain.synthetic_batch(JCFG, 2, 2, HW, seed=5)
        batch["extrinsics"] = batch["extrinsics"] + np.random.default_rng(9).normal(
            scale=0.3, size=batch["extrinsics"].shape).astype(np.float32)
        loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(
            jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, batch))
        ref = convert(jax.tree.map(np.asarray, grads_j))
        state, _, place = port_state(jparams)
        loss_t, grads_t = port_grads(state, place(batch))
        np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-6)
        assert set(grads_t) == set(ref)
        for name, g in grads_t.items():
            r = ref[name].numpy()
            err = np.abs(g.numpy() - r).max()
            assert err <= 1e-4 * np.abs(r).max(), f"{name}: {err}"
        assert (grads_t["pos_embed"][0, 0] == 0).all()  # the cls row

    def test_adamw_matches_optax(self, jparams):
        """The step's optimizer against optax.adamw (the JAX step's) on the
        same numpy parameters and gradients over 2 steps: optax's defaults,
        weight decay 1e-4 (torch's own default, 1e-2, would move a unit
        LayerNorm scale by 1e-4 more per step at lr 1e-2).  f32: 1e-6."""
        import optax

        lr = 1e-2
        state, _, _ = port_state(jparams, lr=lr)
        params = {k: p.detach().numpy().copy() for k, p in state.net.named_parameters()}
        rng = np.random.default_rng(6)
        grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
                 for _ in range(2)]
        tx = optax.adamw(lr)
        jp = jax.tree.map(jnp.asarray, params)
        opt_state = tx.init(jp)

        @jax.jit
        def update(g, opt_state, jp):
            updates, opt_state = tx.update(g, opt_state, jp)
            return optax.apply_updates(jp, updates), opt_state

        for g in grads:
            jp, opt_state = update(jax.tree.map(jnp.asarray, g), opt_state, jp)
            for k, p in state.net.named_parameters():
                p.grad = torch.from_numpy(g[k])
            state.optimizer.step()
        for k, p in state.net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                       err_msg=k)

    def test_three_step_trajectory_matches_jax(self, jparams):
        """Losses of 3 steps on the synthetic batches against the JAX
        package's own make_train_step on a 1-device mesh, from the same
        parameters: 1e-5 relative."""
        init_j, step_j, place_j = jtrain.make_train_step(JCFG, make_mesh(1))
        state_j = init_j(seed=0)
        state_t, step_t, place_t = port_state(jparams)
        for step in range(3):
            batch = jtrain.synthetic_batch(JCFG, 2, 2, HW, seed=step)
            state_j, loss_j = step_j(state_j, place_j(batch))
            state_t, loss_t = step_t(state_t, place_t(batch))
            np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5,
                                       err_msg=f"step {step}")
        assert state_t.step == int(state_j.step) == 3

    def test_remat_gives_the_same_grads(self, jparams):
        """Recomputing each block in the backward (cfg.remat) runs the same
        arithmetic: the gradients are bit for bit the same."""
        batch = jtrain.synthetic_batch(JCFG, 2, 2, HW, seed=7)
        out = []
        for cfg in (CFG, CFG.with_overrides(remat=True)):
            state, _, place = port_state(jparams, cfg)
            out.append(port_grads(state, place(batch), cfg))
        assert out[0][0] == out[1][0]
        for k, g in out[0][1].items():
            torch.testing.assert_close(out[1][1][k], g, rtol=0, atol=0, msg=k)

    def test_a_parameter_without_gradient_raises(self, jparams):
        """Only the parameters the forward never reads may lack a gradient;
        any other (an attention weight behind a kernel without a grad_fn)
        stops the step instead of being skipped by AdamW."""
        state, _, place = port_state(jparams)
        port_grads(state, place(jtrain.synthetic_batch(JCFG, 1, 2, HW, seed=10)))
        state.net.blocks[0].attn.qkv.weight.grad = None
        with pytest.raises(RuntimeError, match="blocks.0.attn.qkv.weight got no gradient"):
            train.fill_unused_grads(state.net)

    def test_checkpoint_roundtrip(self, jparams, tmp_path):
        state, step_fn, place = port_state(jparams)
        state, _ = step_fn(state, place(jtrain.synthetic_batch(JCFG, 2, 2, HW, seed=8)))
        save_train_state(tmp_path / "latest", state)
        assert [p.name for p in tmp_path.iterdir()] == ["latest"]  # no temp file left
        fresh, _, _ = port_state(jparams)
        restore_train_state(tmp_path / "latest", fresh)
        assert fresh.step == 1
        for (k, a), b in zip(state.net.state_dict().items(), fresh.net.state_dict().values()):
            torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
        sa, sb = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
        for i in sa:
            for key in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(sb[i][key], sa[i][key], rtol=0, atol=0)


def json_lines(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


class TestTrainCLI:
    """Mirrors tests/test_cli.py::TestTrainCLI with ``--device cpu``."""

    def test_dp_train_and_resume(self, tmp_path, capsys):
        ckpt = tmp_path / "run1"
        cli.main(["--preset", "tiny", "--mode", "dp", "--steps", "4", "--batch", "2",
                  "--views", "2", "--hw", "28", "28", "--ckpt_dir", str(ckpt),
                  "--ckpt_every", "2", "--log_every", "1", "--device", "cpu"])
        lines = json_lines(capsys.readouterr().out)
        assert lines[0]["mode"] == "dp" and lines[0]["mesh"] == {"dp": 1, "tp": 1}
        # the zero cls row of pos_embed: embed_dim more than the JAX count
        n_jax = sum(x.size for x in jax.tree.leaves(jinit(jax.random.PRNGKey(0), JCFG)))
        assert lines[0]["params"] == n_jax + CFG.embed_dim
        assert [ln["step"] for ln in lines if "step" in ln] == [1, 2, 3, 4]
        final = lines[-1]
        assert final["final_step"] == 4 and np.isfinite(final["final_loss"])
        assert (ckpt / "latest").exists()

        cli.main(["--preset", "tiny", "--mode", "dp", "--steps", "6", "--batch", "2",
                  "--views", "2", "--hw", "28", "28", "--ckpt_dir", str(ckpt),
                  "--ckpt_every", "100", "--resume", "--log_every", "0", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "resumed step 4" in out
        final = json_lines(out)[-1]
        assert final["final_step"] == 6

    def test_npz_data_shards(self, tmp_path, capsys):
        rng = np.random.default_rng(0)
        for i in range(2):
            np.savez(tmp_path / f"shard_{i}.npz",
                     images=rng.normal(size=(2, 2, 28, 28, 3)).astype("float32"),
                     depth=rng.uniform(0.5, 3.0, size=(2, 2, 28, 28)).astype("float32"),
                     extrinsics=np.tile(np.eye(4, dtype="float32")[:3], (2, 2, 1, 1)))
        cli.main(["--preset", "tiny", "--mode", "dp", "--steps", "3", "--data", str(tmp_path),
                  "--hw", "28", "28", "--log_every", "1", "--device", "cpu"])
        final = json_lines(capsys.readouterr().out)[-1]
        assert final["final_step"] == 3 and np.isfinite(final["final_loss"])

    @pytest.mark.parametrize("extra,mesh", [
        (["--mode", "sp", "--devices", "2"], {"sp": 2}),
        (["--mode", "pp", "--stages", "2"], {"pp": 2}),
        (["--devices", "2"], {"dp": 2, "tp": 1}),
        (["--devices", "2", "--tp", "2"], {"dp": 1, "tp": 2}),
        (["--devices", "4"], {"dp": 2, "tp": 2}),  # tp defaults to 2 at 4 devices
    ])
    def test_multi_device_modes_run(self, extra, mesh, capfd):
        """Each mode on gloo ranks on the CPU (spawned; rank 0 prints): the
        header's mesh holds the mesh's axis sizes, the loss is finite."""
        cli.main(["--preset", "tiny", "--steps", "2", "--batch", "2", "--views", "2",
                  "--hw", "28", "28", "--log_every", "1", "--device", "cpu", *extra])
        lines = json_lines(capfd.readouterr().out)
        assert lines[0]["mesh"] == mesh
        assert [ln["step"] for ln in lines if "step" in ln] == [1, 2]
        assert lines[-1]["final_step"] == 2 and np.isfinite(lines[-1]["final_loss"])

    def test_sp_on_one_device_runs_in_process(self, capfd):
        """A mesh of one: a process group of this process alone, no spawn."""
        cli.main(["--preset", "tiny", "--mode", "sp", "--steps", "1", "--views", "2",
                  "--hw", "28", "28", "--log_every", "1", "--device", "cpu"])
        lines = json_lines(capfd.readouterr().out)
        assert lines[0]["mesh"] == {"sp": 1} and np.isfinite(lines[-1]["final_loss"])

    def test_pp_checkpoint_and_resume(self, tmp_path, capfd):
        """Stages gathered into one file by rank 0, restored on every rank."""
        args = ["--preset", "tiny", "--mode", "pp", "--stages", "2", "--batch", "2",
                "--views", "2", "--hw", "28", "28", "--device", "cpu",
                "--ckpt_dir", str(tmp_path), "--log_every", "1"]
        cli.main([*args, "--steps", "2"])
        assert (tmp_path / "latest").exists()
        capfd.readouterr()
        cli.main([*args, "--steps", "3", "--resume"])
        out = capfd.readouterr().out
        assert "resumed step 2" in out
        assert json_lines(out)[-1]["final_step"] == 3

    @pytest.mark.parametrize("extra,error,match", [
        (["--mode", "sp", "--devices", "2", "--views", "3"], SystemExit,
         "--views 3 must divide by the sp mesh size 2"),
        (["--devices", "2", "--batch", "3"], SystemExit,
         "--batch 3 must divide by the dp mesh axis 2"),
        (["--mode", "pp", "--stages", "3"], ValueError, "n_stages=3 must divide depth=4"),
        (["--devices", "3", "--tp", "2"], ValueError, "tp=2 must divide device count 3"),
        (["--devices", "4", "--tp", "4"], ValueError, "tp=4 must divide num_heads 2"),
    ])
    def test_jax_cli_errors(self, extra, error, match):
        """The JAX CLI's errors, raised before any rank is spawned."""
        with pytest.raises(error, match=match):
            cli.main(["--preset", "tiny", "--steps", "1", "--device", "cpu", *extra])

    def test_cuda_device_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--preset", "tiny", "--steps", "1"])
