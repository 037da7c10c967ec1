"""The port's W8A8 path against ``da3slam_tpu.ops.quant`` and the JAX
package's quantized encoder, f32 on the CPU.

The quantizers divide, round half to even and clip, the same IEEE steps in
both packages, so on the same numpy input ``quantize_rows`` and
``quantize_weight`` give equal integers and equal scales.
``layer_norm_quant`` normalises first, and the two layernorms sum in another
order (last-digit differences), so a value within that of a rounding boundary
may land one count apart: at most one count, in under 0.1% of the elements,
with scales equal to 1e-6 relative.  ``int8_gemm`` takes an exact integer
product and differs in the f32 rescale's rounding alone (1e-6 relative).
Through a whole encoder such flips make the comparison discontinuous, so the
W8A8 forward is held to the JAX W8A8 forward at 1e-3 of the output's range
(the tiny preset's LayerScale 1e-5 keeps a flipped count's effect far below
that) and to the float port at ``tests/test_quant.py``'s limits (depth
relative L2 0.05, extrinsics 0.05).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import DepthAnything3 as JDA3
from da3slam_tpu.models.da3 import forward_fn as jforward
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.ops import quant as jquant
from da3slam_tpu_torch.models import vit
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net, DepthAnything3, forward_fn
from da3slam_tpu_torch.ops import quant

torch.set_num_threads(2)


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


class TestQuantizers:
    def test_quantize_rows_equals_jax(self):
        rng = np.random.default_rng(0)
        x = (rng.normal(size=(3, 64, 96)) * rng.uniform(0.1, 10, (3, 64, 1))).astype(np.float32)
        x[1, 5] = 0.0  # an all-zero row: scale 1e-30/127, values 0
        q, s = quant.quantize_rows(T(x))
        jq, js = jquant.quantize_rows(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.shape == (3, 64, 1)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        # bf16 activations are widened first, as in JAX
        qb, sb = quant.quantize_rows(T(x).bfloat16())
        jqb, jsb = jquant.quantize_rows(jnp.asarray(x, jnp.bfloat16))
        np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))
        np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))

    def test_quantize_weight_equals_jax(self):
        rng = np.random.default_rng(1)
        w = (rng.normal(size=(48, 32)) * rng.uniform(0.01, 5.0, size=(1, 32))).astype(np.float32)
        wq = quant.quantize_weight(T(w))
        jwq = jquant.quantize_weight(jnp.asarray(w))
        assert wq["w8"].shape == (48, 32) and wq["w8"].stride() == (1, 48)  # column-major
        np.testing.assert_array_equal(wq["w8"].numpy(), np.asarray(jwq["w8"]))
        np.testing.assert_array_equal(wq["wscale"].numpy(), np.asarray(jwq["wscale"]))

    def test_int8_gemm_equals_jax(self):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(2, 64, 64)).astype(np.float32)
        w = rng.normal(size=(64, 80)).astype(np.float32)
        b = rng.normal(size=(80,)).astype(np.float32)
        x8, xs = quant.quantize_rows(T(x))
        wq = quant.quantize_weight(T(w))
        out = quant.int8_gemm(x8, xs, wq, T(b), out_dtype=torch.float32)
        jx8, jxs = jquant.quantize_rows(jnp.asarray(x))
        jout = jquant.int8_gemm(jx8, jxs, jquant.quantize_weight(jnp.asarray(w)), jnp.asarray(b),
                                out_dtype=jnp.float32)
        assert out.shape == (2, 64, 80)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
        # the integer product is exact: against int64 numpy
        acc = x8.numpy().astype(np.int64).reshape(-1, 64) @ wq["w8"].numpy().astype(np.int64)
        np.testing.assert_array_equal(
            torch._int_mm(x8.reshape(-1, 64), wq["w8"]).numpy(), acc)
        # and it is the float product to quantization noise
        ref = x @ w + b
        assert np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref) < 0.02
        assert quant.int8_gemm(x8, xs, wq, None).dtype == torch.bfloat16

    def test_int8_gemm_is_exact_where_f32_is_not(self):
        """127·127·4096 > 2^24: an f32 product of these integers would round."""
        x8 = torch.full((20, 4096), 127, dtype=torch.int8)
        x8[:, ::2] = -127
        x8[:, 0] = 127
        w8 = torch.full((4096, 8), 127, dtype=torch.int8).t().contiguous().t()
        out = quant.int8_gemm(x8, torch.ones(20, 1), {"w8": w8, "wscale": torch.ones(8)}, None,
                              out_dtype=torch.float32)
        exact = int(x8[0].long().sum()) * 127
        assert exact == 2 * 127 * 127 and (out == float(exact)).all()

    def test_layer_norm_quant_matches_jax(self):
        rng = np.random.default_rng(3)
        scale = (rng.normal(size=(32,)) * 0.5 + 1.0).astype(np.float32)
        bias = (rng.normal(size=(32,)) * 0.1).astype(np.float32)
        x = rng.normal(size=(4, 160, 32)).astype(np.float32)
        q, s = quant.layer_norm_quant(T(scale), T(bias), T(x))
        jq, js = jquant.layer_norm_quant({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                         jnp.asarray(x))
        dq = np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32))
        assert dq.max() <= 1 and (dq != 0).mean() < 1e-3
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
        ln = torch.nn.LayerNorm(32, eps=vit.LN_EPS)
        ln.load_state_dict({"weight": T(scale), "bias": T(bias)})
        deq = q.float() * s
        assert (deq - vit.layer_norm(ln, T(x))).abs().max() <= s.max() / 2 + 1e-6


def models(mlp_type):
    """(JAX float model, port float model) on the tiny preset with the JAX
    package's seed-0 weights carried over."""
    jcfg = jget_preset("tiny").with_overrides(mlp_type=mlp_type)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    cfg = get_preset("tiny").with_overrides(mlp_type=mlp_type)
    net = DA3Net(cfg)
    net.load_state_dict(convert(jax.tree.map(np.asarray, jparams)), strict=True)
    return JDA3(jcfg, jparams, dtype=jnp.float32), DepthAnything3(cfg, net)


@pytest.mark.parametrize("mlp_type", ["mlp", "swiglu"])
class TestQuantizedEncoder:
    def test_same_integers_as_jax(self, mlp_type):
        """Both W8A8 forwards run on the same integers: every quantized
        projection of the port equals the JAX pytree's ``w8``/``wscale``."""
        jmodel, model = models(mlp_type)
        jq = jmodel.quantize().params["encoder"]["blocks"]
        qnet = model.quantize().net
        for jb, blk in zip(jq, qnet.blocks):
            pairs = [(blk.attn.qkv, [jb["attn"]["qkv_q"]])]
            if mlp_type == "swiglu":
                pairs += [(blk.mlp.w12, [jb["mlp"]["wg_q"], jb["mlp"]["wv_q"]]),
                          (blk.mlp.w3, [jb["mlp"]["w3_q"]])]
            else:
                pairs += [(blk.mlp.fc1, [jb["mlp"]["w1_q"]]), (blk.mlp.fc2, [jb["mlp"]["w2_q"]])]
            for mod, jparts in pairs:
                assert isinstance(mod, vit.Int8Linear) and mod.w8.dtype == torch.int8
                np.testing.assert_array_equal(
                    mod.w8.numpy(), np.concatenate([np.asarray(p["w8"]) for p in jparts], axis=1))
                np.testing.assert_array_equal(
                    mod.wscale.numpy(), np.concatenate([np.asarray(p["wscale"]) for p in jparts]))
            assert isinstance(blk.attn.proj, torch.nn.Linear)  # the out-projection stays float
        assert not any(isinstance(m, vit.Int8Linear) for m in qnet.depth_head.modules())
        assert not any(isinstance(m, vit.Int8Linear) for m in qnet.camera_head.modules())

    def test_forward_matches_jax_w8a8_and_the_float_port(self, mlp_type):
        jmodel, model = models(mlp_type)
        # LayerScale 0.5 instead of the init's 1e-5, so the blocks' int8 GEMMs
        # reach the outputs at full weight
        jparams = jax.tree.map(lambda x: x, jmodel.params)
        for jb in jparams["encoder"]["blocks"]:
            jb["ls1"], jb["ls2"] = jnp.full_like(jb["ls1"], 0.5), jnp.full_like(jb["ls2"], 0.5)
        jmodel = JDA3(jmodel.cfg, jparams, dtype=jnp.float32)
        with torch.no_grad():
            for blk in model.net.blocks:
                blk.ls1.gamma.fill_(0.5)
                blk.ls2.gamma.fill_(0.5)
        before = {k: v.clone() for k, v in model.net.state_dict().items()}
        imgs = np.random.default_rng(0).normal(size=(2, 56, 56, 3)).astype(np.float32)
        qmodel = model.quantize()
        jqmodel = jmodel.quantize()
        jout = jforward(jqmodel.params, jnp.asarray(imgs), jqmodel.cfg, dtype=jnp.float32)
        with torch.no_grad():
            out_q = forward_fn(qmodel.net, T(imgs), qmodel.cfg)
            out_f = forward_fn(model.net, T(imgs), model.cfg)
        for key in ("depth", "conf", "extrinsics", "intrinsics"):
            a, b = out_q[key].numpy(), np.asarray(jout[key])
            assert np.isfinite(a).all()
            assert np.abs(a - b).max() <= 1e-3 * max(np.abs(b).max(), 1.0), key
        d_f, d_q = out_f["depth"].numpy(), out_q["depth"].numpy()
        assert 0 < np.linalg.norm(d_q - d_f) / np.linalg.norm(d_f) < 0.05
        np.testing.assert_allclose(out_q["extrinsics"].numpy(), out_f["extrinsics"].numpy(),
                                   atol=0.05)
        # the float model is untouched, and still the one it was
        after = model.net.state_dict()
        assert set(after) == set(before) and all(torch.equal(after[k], before[k]) for k in before)
        assert isinstance(model.net.blocks[0].attn.qkv, torch.nn.Linear)
        assert qmodel.dtype == model.dtype and qmodel.cfg is model.cfg


def test_quantize_rejects_unknown_scheme():
    model = DepthAnything3.from_pretrained("tiny", device="cpu")
    with pytest.raises(ValueError, match="unknown quantization scheme"):
        model.quantize("w4a16")


def test_inference_runs_on_the_quantized_model():
    model = DepthAnything3.from_pretrained("tiny", device="cpu").quantize()
    imgs = np.random.default_rng(1).integers(0, 256, size=(2, 56, 70, 3)).astype(np.uint8)
    pred = model.inference(image=imgs, process_res=70)
    assert pred.depth.shape == (2, 56, 70) and np.isfinite(pred.depth).all()
    assert np.isfinite(pred.extrinsics).all()
