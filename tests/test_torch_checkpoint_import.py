"""The port's torch-checkpoint import (``da3slam_tpu_torch/models/torch_import.py``)
against ``da3slam_tpu.models.torch_import``.

Checkpoints are the JAX package's ``export_torch_style`` of its tiny
parameters (seed 0), renamed and cut as released checkpoints differ; both
packages import the same dict, and their ``ImportReport``s must be equal
entry for entry.  The imported weights are held to the JAX package's: the
tensors bit for bit where no resample is involved, the resampled
``pos_embed`` within 1e-5 (bilinear weights in f32, summed in another order),
the predictions as ``tests/test_torch_weights.py`` holds them.  At the giant
tier only names and shapes are checked, on the meta device.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import DepthAnything3 as JDA3
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.models import torch_import as jti
from da3slam_tpu_torch.models import torch_import as ti
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net, DepthAnything3, init_params
from da3slam_tpu_torch.models.weights import save_file

torch.set_num_threads(2)
FIXTURES = Path(__file__).parent / "fixtures"
IMGS = np.random.default_rng(0).integers(0, 256, size=(2, 56, 70, 3)).astype(np.uint8)


def jparams(mlp_type="mlp", seed=0, preset="tiny"):
    cfg = jget_preset(preset).with_overrides(mlp_type=mlp_type)
    return cfg, jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(seed), cfg))


def both_import(sd, mlp_type="mlp", preset="tiny"):
    """Import ``sd`` into seed-1 parameters in both packages (the targets'
    own values differ from the checkpoint's, so a missed tensor shows)."""
    jcfg, jp = jparams(mlp_type, seed=1, preset=preset)
    jnew, jreport = jti.import_torch_checkpoint(sd, jp, jcfg)
    cfg = get_preset(preset).with_overrides(mlp_type=mlp_type)
    net = DA3Net(cfg)
    net.load_state_dict(convert(jp), strict=True)
    net, report = ti.import_torch_checkpoint(sd, net, cfg)
    return net, report, jnew, jreport


def assert_same_report(report, jreport):
    assert report.matched == jreport.matched
    assert report.missing == jreport.missing
    assert report.unused == jreport.unused
    assert str(report) == str(jreport)


def renamed(sd, fn):
    return {fn(k): v for k, v in sd.items()}


def _cases():
    def cut(sd):
        out = dict(sd)
        out.pop("blocks.0.norm1.bias")
        out.pop("depth_head.scratch.refinenet2.out_conv.weight")
        out.pop("camera_head.out.bias")
        out["blocks.2.attn.proj.weight"] = np.zeros((5, 7), np.float32)  # wrong shape
        out["depth_head.projects.1.weight"] = np.zeros((3, 3, 1, 1), np.float32)
        out["extra.thing"] = np.zeros(3, np.float32)
        return out

    head_alt = {"depth_head.projects": "head.projects", "depth_head.resize_layers": "dpt.resize_layers",
                "depth_head.scratch.refinenet": "dpt_head.scratch.refinenet",
                "camera_head.mlp": "pose_head.mlp", "camera_head.out": "cam_head.out"}

    def head_alts(k):
        for a, b in head_alt.items():
            if k.startswith(a):
                return b + k[len(a):]
        return k

    def enc_prefix(k):
        if k.startswith(("blocks.0.", "blocks.1.", "patch_embed", "pos_embed", "norm.")):
            return "backbone." + k
        if k.startswith(("blocks.2.", "cls_token")):
            return "encoder." + k
        if k.startswith(("blocks.3.", "register_tokens")):
            return "pretrained." + k
        return k

    return {
        "as_exported": lambda sd: sd,
        "mask_token": lambda sd: {**sd, "mask_token": np.zeros((1, 32), np.float32)},
        "wrapped_model": lambda sd: renamed(sd, lambda k: "model." + k),
        "wrapped_module": lambda sd: renamed(sd, lambda k: "module." + k),
        "wrapped_model_module": lambda sd: renamed(sd, lambda k: "model.module." + k),
        "backbone_prefixed": lambda sd: {**renamed(sd, enc_prefix),
                                         "backbone.mask_token": np.zeros((1, 32), np.float32)},
        "head_alternates": lambda sd: renamed(sd, head_alts),
        "camera_token_name": lambda sd: renamed(
            sd, lambda k: {"cls_token": "camera_token", "register_tokens": "reg_token"}.get(k, k)),
        "partial": cut,
        "no_rn_bias": lambda sd: {k: v for k, v in sd.items() if not k.endswith("_rn.bias")},
        "empty": lambda sd: {},
    }


CASES = list(_cases())


class TestReportEqualsJax:
    @pytest.mark.parametrize("mlp_type", ["mlp", "swiglu"])
    @pytest.mark.parametrize("case", CASES)
    def test_report_and_weights(self, case, mlp_type):
        _, jp = jparams(mlp_type)
        sd = _cases()[case](jti.export_torch_style(jp))
        net, report, jnew, jreport = both_import(sd, mlp_type)
        assert_same_report(report, jreport)
        # the port's weights are the JAX package's after its import, bit for bit
        want = convert(jax.tree.map(np.asarray, jnew))
        got = net.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k

    def test_numpy_and_tensor_inputs_agree(self):
        _, jp = jparams()
        sd = jti.export_torch_style(jp)
        cfg = get_preset("tiny")
        a, ra = ti.import_torch_checkpoint(sd, init_params(cfg, 2), cfg)
        b, rb = ti.import_torch_checkpoint({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                                           init_params(cfg, 2), cfg)
        assert ra == rb and not ra.missing and not ra.unused
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


class TestSectionImports:
    """``import_torch_encoder`` and ``import_torch_heads``, the two sections
    of the import by themselves: the JAX package's reports (its ``unused``
    lists what the section left, the other section's tensors among them)."""

    @staticmethod
    def both(sd, section, mlp_type="mlp", preset="tiny"):
        jcfg, jp = jparams(mlp_type, seed=1, preset=preset)
        cfg = get_preset(preset).with_overrides(mlp_type=mlp_type)
        net = DA3Net(cfg)
        net.load_state_dict(convert(jp), strict=True)
        if section == "encoder":
            jnew, jreport = jti.import_torch_encoder(sd, jp, jcfg)
            net, report = ti.import_torch_encoder(sd, net, cfg)
        else:
            jnew, jreport = jti.import_torch_heads(sd, jp)
            net, report = ti.import_torch_heads(sd, net)
        return net, report, jnew, jreport

    @pytest.mark.parametrize("section", ["encoder", "heads"])
    @pytest.mark.parametrize("case", ["as_exported", "backbone_prefixed", "head_alternates",
                                      "partial", "mask_token", "empty"])
    def test_report_and_weights(self, case, section):
        _, jp = jparams()
        sd = _cases()[case](jti.export_torch_style(jp))
        net, report, jnew, jreport = self.both(sd, section)
        assert_same_report(report, jreport)
        want = convert(jax.tree.map(np.asarray, jnew))
        got = net.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v), k

    @pytest.mark.parametrize("section", ["encoder", "heads"])
    def test_published_small_schema(self, section):
        """The published SMALL names (tests/fixtures/gen_torch_schema.py's
        manifest) through one section in both packages: the same report."""
        schema = json.loads((FIXTURES / "torch_schema_small.json").read_text())
        sd = {k: np.broadcast_to(np.float32(0.5), tuple(s)) for k, s in schema["keys"].items()}
        _, report, _, jreport = self.both(sd, section, preset="small")
        assert_same_report(report, jreport)
        assert report.matched and report.unused


class TestPosEmbedResample:
    @pytest.mark.parametrize("side", [36, 16])
    @pytest.mark.parametrize("cls_row", [True, False])
    def test_grid_equals_jax(self, side, cls_row):
        """37→36 (the 504² grid, a downscale: antialiased) and 16→37 (an
        upscale), with and without the leading cls row."""
        rng = np.random.default_rng(side)
        _, jp = jparams()
        sd = jti.export_torch_style(jp)
        grid = rng.normal(size=(1, side * side, 32)).astype(np.float32)
        sd["pos_embed"] = (np.concatenate([np.zeros((1, 1, 32), np.float32), grid], axis=1)
                           if cls_row else grid)
        net, report, jnew, jreport = both_import(sd)
        assert_same_report(report, jreport)
        assert "pos_embed" in report.matched
        got = net.pos_embed[0, 1:].reshape(37, 37, 32).detach().numpy()
        want = np.asarray(jnew["encoder"]["pos_embed"])
        assert want.shape == (37, 37, 32)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_dim_mismatch_is_reported(self):
        _, jp = jparams()
        sd = jti.export_torch_style(jp)
        sd["pos_embed"] = np.zeros((1, 1 + 37 * 37, 48), np.float32)
        net, report, _, jreport = both_import(sd)
        assert_same_report(report, jreport)
        assert "pos_embed (dim mismatch)" in report.missing


class TestLoudErrors:
    @pytest.mark.parametrize("ours,theirs", [("mlp", "swiglu"), ("swiglu", "mlp")])
    def test_ffn_flavour_mismatch(self, ours, theirs):
        _, jp = jparams(theirs)
        sd = jti.export_torch_style(jp)
        jcfg, jtarget = jparams(ours, seed=1)
        with pytest.raises(ValueError, match="FFN flavour mismatch at blocks.0"):
            jti.import_torch_checkpoint(sd, jtarget, jcfg)
        cfg = get_preset("tiny").with_overrides(mlp_type=ours)
        with pytest.raises(ValueError, match="FFN flavour mismatch at blocks.0"):
            ti.import_torch_checkpoint(sd, init_params(cfg), cfg)

    def test_fused_width(self):
        _, jp = jparams("swiglu")
        sd = jti.export_torch_style(jp)
        sd["blocks.1.mlp.w12.weight"] = np.zeros((2 * 80, 32), np.float32)
        jcfg, jtarget = jparams("swiglu", seed=1)
        with pytest.raises(ValueError, match="blocks.1.mlp.w12 has fused width 160"):
            jti.import_torch_checkpoint(sd, jtarget, jcfg)
        cfg = get_preset("tiny").with_overrides(mlp_type="swiglu")
        with pytest.raises(ValueError, match="blocks.1.mlp.w12 has fused width 160"):
            ti.import_torch_checkpoint(sd, init_params(cfg), cfg)


class TestFiles:
    @pytest.mark.parametrize("wrapped", [False, True])
    def test_pickled_file_equals_jax(self, tmp_path, wrapped):
        _, jp = jparams()
        sd = {k: torch.from_numpy(np.array(v)) for k, v in jti.export_torch_style(jp).items()}
        torch.save({"state_dict": sd} if wrapped else sd, tmp_path / "pytorch_model.bin")
        got = ti.load_torch_checkpoint_file(tmp_path / "pytorch_model.bin")
        want = jti.load_torch_checkpoint_file(tmp_path / "pytorch_model.bin")
        assert list(got) == list(want)
        assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)

    def test_safetensors_file_equals_jax(self, tmp_path):
        _, jp = jparams()
        save_file(jti.export_torch_style(jp), tmp_path / "m.safetensors")
        got = ti.load_torch_checkpoint_file(tmp_path / "m.safetensors")
        want = jti.load_torch_checkpoint_file(tmp_path / "m.safetensors")
        assert set(got) == set(want)
        assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)

    @pytest.mark.parametrize("layout", ["backbone_safetensors", "pytorch_model.bin", "model.pt"])
    def test_directory_loads_as_jax(self, tmp_path, layout):
        """A ``backbone.``-prefixed safetensors directory and pickled files
        load through ``from_pretrained`` in both packages to the same
        predictions."""
        cfg, jp = jparams()
        sd = {k: np.ascontiguousarray(v) for k, v in jti.export_torch_style(jp).items()}
        d = tmp_path / "ckpt"
        d.mkdir()
        if layout == "backbone_safetensors":
            sd = renamed(sd, lambda k: k if k.startswith(("depth_head", "camera_head"))
                         else "backbone." + k)
            save_file(sd, d / "model.safetensors")
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, d / layout)
        (d / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
        model = DepthAnything3.from_pretrained(str(d), device="cpu")
        jmodel = JDA3.from_pretrained(str(d))
        pred = model.inference(image=IMGS, process_res=70)
        jpred = jmodel.inference(image=IMGS, process_res=70)
        np.testing.assert_allclose(pred.depth, jpred.depth, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(pred.conf, jpred.conf, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(pred.extrinsics, jpred.extrinsics, atol=1e-5)
        np.testing.assert_allclose(pred.intrinsics, jpred.intrinsics, atol=1e-3)

    def test_export_round_trip(self):
        """``export_torch_style`` is the import's inverse: a network exported
        and imported into another seed's network gives back every tensor."""
        cfg = get_preset("tiny").with_overrides(mlp_type="swiglu")
        src = init_params(cfg, 3)
        dst, report = ti.import_torch_checkpoint(ti.export_torch_style(src), init_params(cfg, 4),
                                                 cfg)
        assert not report.missing and not report.unused
        a, b = src.state_dict(), dst.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)


class TestPublishedSchema:
    def test_small_maps_with_nothing_unmatched(self):
        """The published SMALL names (tests/fixtures/torch_schema_small.json)
        against real SMALL parameters in both packages: the same report, only
        the released head's absent ``layerN_rn`` biases missing, the mask
        token consumed."""
        schema = json.loads((FIXTURES / "torch_schema_small.json").read_text())
        sd = {k: np.broadcast_to(np.float32(0.5), tuple(s)) for k, s in schema["keys"].items()}
        net, report, _, jreport = both_import(sd, preset="small")
        assert_same_report(report, jreport)
        assert sorted(report.missing) == sorted(schema["expected_missing"])
        assert report.unused == []

    def test_nested_giant_maps_with_nothing_unmatched(self):
        """The nested giant + large manifest, split, into meta-device networks
        of both tiers: every name and shape maps; only the ``layerN_rn``
        biases are missing and nothing is left over."""
        schema = json.loads((FIXTURES / "torch_schema_nested_giant.json").read_text())
        sd = {k: torch.empty(s, device="meta") for k, s in schema["keys"].items()}
        sd_any, sd_met, prefixes = ti.split_nested_state_dict(sd)
        assert prefixes == ("model.", "metric_model.")
        for prefix, sub, tier in ((prefixes[0], sd_any, "giant"), (prefixes[1], sd_met, "large")):
            cfg = get_preset(tier)
            with torch.device("meta"):
                net = DA3Net(cfg)
            _, report = ti.import_torch_checkpoint(sub, net, cfg)
            missing = sorted(prefix + m for m in report.missing)
            assert missing == sorted(m for m in schema["expected_missing"] if m.startswith(prefix))
            assert report.unused == []
            n_params = len(net.state_dict())
            # every parameter but the 4 biases; SwiGLU's w12 counts twice
            extra = 2 * cfg.depth if cfg.mlp_type == "swiglu" else 0
            assert len(report.matched) == n_params - 4 + extra
