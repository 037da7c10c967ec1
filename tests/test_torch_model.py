"""The port's model against ``da3slam_tpu.models`` on the tiny preset.

The JAX package's seed-0 parameters cross over through
``da3slam_tpu_torch.models.convert``; inputs are made from a seed with numpy
and fed to both packages.  f32 on the CPU; the JAX side runs XLA's softmax
attention, the port its plain bound-mode attention.  Tolerances: 1e-5 where
the two compute the same sums in a different order over few terms; 1e-4 on
the DPT outputs, whose 3x3 convolutions over 8-32 channels reach magnitudes
~50 with ~1e-6 relative accumulation-order noise.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from da3slam_tpu.models import camera as jcam
from da3slam_tpu.models import dpt as jdpt
from da3slam_tpu.models import vit as jvit
from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import DepthAnything3 as JDA3
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.models.torch_import import export_torch_style
from da3slam_tpu.ops import resize as jresize
from da3slam_tpu_torch.models import camera, dpt, vit
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net, DepthAnything3
from da3slam_tpu_torch.ops import resize

torch.set_num_threads(2)
CFG = get_preset("tiny")
FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jget_preset("tiny")))


@pytest.fixture(scope="module")
def net(jparams):
    n = DA3Net(CFG)
    n.load_state_dict(convert(jparams), strict=True)
    return n.eval()


def normalized_images(seed, n=2, h=56, w=70):
    return np.random.default_rng(seed).normal(size=(n, h, w, 3)).astype(np.float32)


class TestConvert:
    def test_equals_export_torch_style(self, jparams):
        sd = convert(jparams)
        ref = export_torch_style(jparams)
        assert set(sd) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)

    def test_strict_load_covers_every_parameter(self, jparams):
        sd = convert(jparams)
        fresh = DA3Net(CFG)
        assert set(fresh.state_dict()) == set(sd)
        fresh.load_state_dict(sd, strict=True)

    @pytest.mark.parametrize("tier", ["small", "base", "large"])
    def test_names_and_shapes_match_published_schema(self, tier):
        """The module names are the released DINOv2/DPT ones
        (tests/fixtures/torch_schema_*.json, written without this repo's
        code).  The schema's documented gaps: the released ``layerN_rn``
        convs have no bias (the JAX package's do), and the DINOv2
        ``mask_token`` serves only training."""
        schema = json.loads((FIXTURES / f"torch_schema_{tier}.json").read_text())
        with torch.device("meta"):
            sd = {k: list(v.shape) for k, v in DA3Net(get_preset(tier)).state_dict().items()}
        assert sorted(set(sd) - set(schema["keys"])) == sorted(schema["expected_missing"])
        assert sorted(set(schema["keys"]) - set(sd)) == ["mask_token"]
        assert {k: s for k, s in sd.items() if k in schema["keys"]} == \
            {k: s for k, s in schema["keys"].items() if k in sd}


class TestResize:
    @pytest.mark.parametrize("hw,out", [((518, 518), (504, 504)),  # the ingest downscale
                                        ((60, 80), (56, 70)),
                                        ((40, 50), (56, 70))])  # upscale
    def test_resize_normalize(self, hw, out):
        img = np.random.default_rng(0).integers(0, 256, size=(2, *hw, 3)).astype(np.uint8)
        assert resize.upper_bound_shape(*hw, 504 if hw[0] == 518 else 70) == \
            jresize.upper_bound_shape(*hw, 504 if hw[0] == 518 else 70)
        t_out = resize.resize_normalize(torch.from_numpy(img), out).numpy()
        j_out = np.asarray(jresize.resize_normalize(jnp.asarray(img), out))
        # torch builds its antialias filter weights in f32, off float64's by
        # up to 1.4e-5 (JAX's by 2e-7): up to 1.2e-5 on [0, 1] pixels, 5.3e-5
        # after the division by the ImageNet std
        np.testing.assert_allclose(t_out, j_out, atol=1e-4)

    def test_denormalize_to_uint8(self):
        x = normalized_images(1)
        t_out = resize.denormalize_to_uint8(torch.from_numpy(x)).numpy()
        j_out = np.asarray(jresize.denormalize_to_uint8(jnp.asarray(x)))
        np.testing.assert_array_equal(t_out, j_out)

    def test_pos_embed_downscale(self):
        pos = np.random.default_rng(2).normal(size=(37, 37, 8)).astype(np.float32)
        t_out = vit.interpolate_pos_embed(torch.from_numpy(pos), 36, 36).numpy()
        j_out = np.asarray(jvit.interpolate_pos_embed(jnp.asarray(pos), 36, 36))
        np.testing.assert_allclose(t_out, j_out, atol=1e-5)


class TestModules:
    def test_encode(self, jparams, net):
        x = normalized_images(3)
        taps, final, grid = jvit.encode(jparams["encoder"], jnp.asarray(x), jget_preset("tiny"))
        with torch.no_grad():
            t_taps, t_final, t_grid = vit.encode(net, torch.from_numpy(x), CFG)
        assert t_grid == grid
        for a, b in zip(t_taps, taps):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        np.testing.assert_allclose(t_final.numpy(), np.asarray(final), atol=1e-5)

    def test_block_attention_is_not_negligible(self, net):
        """LayerScale starts at 1e-5, so a block barely moves its input: pin
        the attention and MLP paths with unit-scale LayerScale too."""
        import copy

        from da3slam_tpu.models.vit import _block as jblock

        rng = np.random.default_rng(4)
        x = rng.normal(size=(3, 21, CFG.embed_dim)).astype(np.float32)
        blk = copy.deepcopy(net.blocks[1])
        with torch.no_grad():
            blk.ls1.gamma.fill_(1.0)
            blk.ls2.gamma.fill_(1.0)
            for cross in (False, True):
                t_out = vit._block(blk, torch.from_numpy(x), CFG.num_heads, cross).numpy()
                jp = {
                    "ln1": {"scale": blk.norm1.weight.numpy(), "bias": blk.norm1.bias.numpy()},
                    "attn": {"qkv_w": blk.attn.qkv.weight.numpy().T,
                             "qkv_b": blk.attn.qkv.bias.numpy(),
                             "proj_w": blk.attn.proj.weight.numpy().T,
                             "proj_b": blk.attn.proj.bias.numpy()},
                    "ls1": np.ones(CFG.embed_dim, np.float32),
                    "ln2": {"scale": blk.norm2.weight.numpy(), "bias": blk.norm2.bias.numpy()},
                    "mlp": {"w1": blk.mlp.fc1.weight.numpy().T, "b1": blk.mlp.fc1.bias.numpy(),
                            "w2": blk.mlp.fc2.weight.numpy().T, "b2": blk.mlp.fc2.bias.numpy()},
                    "ls2": np.ones(CFG.embed_dim, np.float32),
                }
                j_out = np.asarray(jblock(jp, jnp.asarray(x), CFG.num_heads, cross, "xla"))
                assert np.abs(t_out - x).max() > 1e-2
                np.testing.assert_allclose(t_out, j_out, atol=1e-5)

    def test_apply_dpt(self, jparams, net):
        x = normalized_images(5)
        taps, _, grid = jvit.encode(jparams["encoder"], jnp.asarray(x), jget_preset("tiny"))
        jd, jc, jr = jdpt.apply_dpt(jparams["dpt"], taps, grid, (56, 70), jget_preset("tiny"))
        with torch.no_grad():
            td, tc, tr = dpt.apply_dpt(net.depth_head, [torch.from_numpy(np.array(t)) for t in taps],
                                       grid, (56, 70), CFG)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)

    def test_apply_camera_head(self, jparams, net):
        tokens = np.random.default_rng(6).normal(size=(4, CFG.embed_dim)).astype(np.float32)
        for ref_idx in (0, 2):
            je, jk = jcam.apply_camera_head(jparams["camera"], jnp.asarray(tokens), (56, 70), ref_idx)
            with torch.no_grad():
                te, tk = camera.apply_camera_head(net.camera_head, torch.from_numpy(tokens),
                                                  (56, 70), ref_idx)
            np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5)
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4, rtol=1e-6)


class TestInference:
    def test_matches_jax_with_downscale(self, jparams, net):
        """uint8 frames 80x100 at process_res 70: resized down to 56x70."""
        imgs = np.random.default_rng(7).integers(0, 256, size=(3, 80, 100, 3)).astype(np.uint8)
        pj = JDA3(jget_preset("tiny"), jparams).inference(image=imgs, process_res=70)
        pt = DepthAnything3(CFG, net).inference(image=imgs, process_res=70)
        assert pt.depth.shape == pj.depth.shape == (3, 56, 70)
        # rounding to uint8 may flip a value sitting at .5 by f32 noise
        assert np.abs(pt.processed_images.astype(int) - pj.processed_images).max() <= 1
        for f in ("depth", "conf"):
            np.testing.assert_allclose(getattr(pt, f), getattr(pj, f), atol=1e-4, rtol=1e-4)
        for f in ("extrinsics", "frame_desc"):
            np.testing.assert_allclose(getattr(pt, f), getattr(pj, f), atol=1e-5)
        np.testing.assert_allclose(pt.intrinsics, pj.intrinsics, atol=1e-4, rtol=1e-6)

    def test_reproduces_golden(self, net):
        """tests/golden/tiny_seed0.npz (the JAX package's seed-0 tiny model)
        through the converted weights.  1e-4: see the module docstring (the
        JAX-vs-JAX golden test holds 1e-5)."""
        g = np.load("tests/golden/tiny_seed0.npz")
        pred = DepthAnything3(CFG, net).inference(image=g["images"], process_res=70)
        np.testing.assert_allclose(pred.depth[:, ::4, ::4], g["depth"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(pred.conf[:, ::4, ::4], g["conf"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(pred.extrinsics, g["extrinsics"], atol=1e-5)
        np.testing.assert_allclose(pred.intrinsics, g["intrinsics"], atol=1e-4)

    def test_extrinsics_conditioning_adopts_given_poses(self, jparams, net):
        rng = np.random.default_rng(9)
        imgs = rng.integers(0, 256, size=(3, 56, 70, 3)).astype(np.uint8)
        ext = np.concatenate([np.tile(np.eye(3, dtype=np.float32), (3, 1, 1)),
                              rng.normal(size=(3, 3, 1)).astype(np.float32)], axis=-1)
        kw = dict(image=imgs, process_res=70, extrinsics=ext, align_to_input_ext_scale=True)
        pj = JDA3(jget_preset("tiny"), jparams).inference(**kw)
        pt = DepthAnything3(CFG, net).inference(**kw)
        np.testing.assert_array_equal(pt.extrinsics, ext)
        np.testing.assert_allclose(pt.depth, pj.depth, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("n_views", [7, 6])
    def test_pose_scale_ratio(self, n_views):
        """Median ratio of translation norms: the reference view's zero
        translation drops out, leaving an even (6) or odd (5) count; an even
        count averages the two middle ratios."""
        from da3slam_tpu.models.da3 import _pose_scale_ratio as jratio
        from da3slam_tpu_torch.models.da3 import _pose_scale_ratio

        rng = np.random.default_rng(10)
        target, pred = (rng.normal(size=(n_views, 3, 4)).astype(np.float32) for _ in range(2))
        pred[0, :, 3] = 0.0
        t_out = float(_pose_scale_ratio(torch.from_numpy(target), torch.from_numpy(pred)))
        j_out = float(jratio(jnp.asarray(target), jnp.asarray(pred)))
        ratios = np.sort(np.linalg.norm(target[1:, :, 3], axis=-1)
                         / np.linalg.norm(pred[1:, :, 3], axis=-1))
        mid = len(ratios) // 2
        expect = ratios[mid] if len(ratios) % 2 else 0.5 * (ratios[mid - 1] + ratios[mid])
        np.testing.assert_allclose(t_out, j_out, rtol=1e-6)
        np.testing.assert_allclose(t_out, expect, rtol=1e-6)

    def test_keep_on_device_returns_tensors(self, net):
        imgs = np.random.default_rng(8).integers(0, 256, size=(2, 56, 70, 3)).astype(np.uint8)
        m = DepthAnything3(CFG, net)
        dev = m.inference(image=imgs, process_res=70, keep_on_device=True)
        host = m.inference(image=imgs, process_res=70)
        for f in ("processed_images", "depth", "conf", "extrinsics", "intrinsics", "frame_desc"):
            t = getattr(dev, f)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), getattr(host, f))

    def test_from_pretrained_is_seeded(self):
        a = DepthAnything3.from_pretrained("tiny", seed=0, device="cpu")
        b = DepthAnything3.from_pretrained("checkpoints/tiny", seed=0, device="cpu")
        c = DepthAnything3.from_pretrained("tiny", seed=1, device="cpu")
        assert a.dtype == torch.float32
        sa, sb, sc = (m.net.state_dict() for m in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert not torch.equal(sa["blocks.0.attn.qkv.weight"], sc["blocks.0.attn.qkv.weight"])
        with pytest.raises(KeyError):
            DepthAnything3.from_pretrained("no-such-tier", device="cpu")
