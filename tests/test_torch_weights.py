"""The port's checkpoint directories and its safetensors reader/writer against
the JAX package's ``models/weights.py`` and the ``safetensors`` package.

Weights are the JAX package's seed-0 tiny parameters.  A directory that the
JAX ``save_checkpoint`` writes (native, ``/``-joined names) and one holding
``export_torch_style``'s dot-named tensors both load through the port's
``from_pretrained`` and give the JAX model's outputs (f32 on the CPU: 1e-4
on the dense maps, 1e-5 on poses, as ``tests/test_torch_model.py``).  The
file format is held bit for bit: what the port writes, ``safetensors`` reads;
what ``safetensors`` writes, the port reads.
"""

import json
import struct

import numpy as np
import pytest
import torch

import jax

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import DepthAnything3 as JDA3
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.models.torch_import import export_torch_style
from da3slam_tpu.models.weights import flatten_params as jflatten
from da3slam_tpu.models.weights import save_checkpoint as jsave
from da3slam_tpu_torch.models import weights
from da3slam_tpu_torch.models.config import config_from_json, get_preset
from da3slam_tpu_torch.models.da3 import DepthAnything3

torch.set_num_threads(2)
IMGS = np.random.default_rng(0).integers(0, 256, size=(2, 56, 70, 3)).astype(np.uint8)


@pytest.fixture(scope="module", params=["mlp", "swiglu"])
def jmodel(request):
    cfg = jget_preset("tiny").with_overrides(mlp_type=request.param)
    return JDA3(cfg, jinit(jax.random.PRNGKey(0), cfg), dtype=jax.numpy.float32)


def assert_same_prediction(model, jmodel):
    pred = model.inference(image=IMGS, process_res=70)
    jpred = jmodel.inference(image=IMGS, process_res=70)
    np.testing.assert_allclose(pred.depth, jpred.depth, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pred.conf, jpred.conf, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pred.extrinsics, jpred.extrinsics, atol=1e-5)
    np.testing.assert_allclose(pred.intrinsics, jpred.intrinsics, atol=1e-3)


def all_dtypes():
    rng = np.random.default_rng(1)
    return {
        "f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.normal(size=(7,)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32)).bfloat16(),
        "i8": torch.from_numpy(rng.integers(-128, 128, size=(4, 4)).astype(np.int8)),
        "i32": torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(5,)).astype(np.int32)),
        "i64": torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, size=(2, 2)).astype(np.int64)),
        "u8": torch.from_numpy(rng.integers(0, 256, size=(6,)).astype(np.uint8)),
        "bool": torch.from_numpy(rng.integers(0, 2, size=(3, 3)).astype(bool)),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }


class TestDirectories:
    def test_jax_native_directory_loads(self, jmodel, tmp_path):
        jsave(tmp_path / "ckpt", jmodel.params, jmodel.cfg)
        model = DepthAnything3.from_pretrained(str(tmp_path / "ckpt"), device="cpu")
        assert model.cfg == get_preset("tiny").with_overrides(mlp_type=jmodel.cfg.mlp_type)
        assert_same_prediction(model, jmodel)
        # the port's load_checkpoint reads the same pytree back
        params, cfg = weights.load_checkpoint(tmp_path / "ckpt")
        assert cfg == model.cfg and len(params["encoder"]["blocks"]) == cfg.depth
        for k, v in jflatten(jax.tree.map(np.asarray, jmodel.params)).items():
            np.testing.assert_array_equal(weights.flatten_params(params)[k].numpy(), v)

    @pytest.mark.parametrize("rn_bias", [True, False])
    def test_dot_named_directory_loads(self, jmodel, tmp_path, rn_bias):
        """``export_torch_style``'s state dict, with the mask token a released
        checkpoint carries, with and without the ``layerN_rn`` biases that the
        released DPT head lacks (the JAX package's are zeros at init); the FFN
        flavour is read off the tensors, not the config."""
        from safetensors.numpy import save_file

        # (made contiguous: safetensors.numpy writes a transposed view's bytes
        # in storage order)
        sd = {k: np.ascontiguousarray(v) for k, v in
              export_torch_style(jax.tree.map(np.asarray, jmodel.params)).items()}
        sd["mask_token"] = np.zeros((1, jmodel.cfg.embed_dim), np.float32)
        if not rn_bias:
            for k in range(1, 5):
                assert not sd.pop(f"depth_head.scratch.layer{k}_rn.bias").any()
        d = tmp_path / "tiny"
        d.mkdir()
        save_file(sd, str(d / "model.safetensors"))
        blob = {"embed_dim": 32, "depth": 4, "num_heads": 2, "num_register_tokens": 1,
                "dpt_layers": [0, 1, 2, 3], "dpt_dim": 16, "dpt_features": [8, 16, 24, 32],
                "camera_dim": 32, "architectures": ["DepthAnything3"]}  # no mlp_type
        (d / "config.json").write_text(json.dumps(blob))
        model = DepthAnything3.from_pretrained(str(d), device="cpu")
        assert model.cfg.mlp_type == jmodel.cfg.mlp_type
        assert_same_prediction(model, jmodel)
        # without a config.json the directory's name picks the preset
        (d / "config.json").unlink()
        if jmodel.cfg.mlp_type == "mlp":
            again = DepthAnything3.from_pretrained(str(d), device="cpu")
            assert again.cfg == get_preset("tiny")

    def test_port_round_trip_is_bit_equal(self, tmp_path):
        model = DepthAnything3.from_pretrained("tiny", seed=3, device="cpu")
        weights.save_checkpoint(tmp_path / "port", model.net.state_dict(), model.cfg)
        loaded = DepthAnything3.from_pretrained(str(tmp_path / "port"), device="cpu")
        assert loaded.cfg == model.cfg
        sd, sd2 = model.net.state_dict(), loaded.net.state_dict()
        assert set(sd) == set(sd2) and all(torch.equal(sd[k], sd2[k]) for k in sd)
        a = model.inference(image=IMGS, process_res=70)
        b = loaded.inference(image=IMGS, process_res=70)
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.extrinsics, b.extrinsics)

    def test_what_is_not_ported_raises(self, tmp_path, jmodel):
        """What used to raise (a nested checkpoint, a pickled one) now loads
        and gives the JAX package's outputs for the same directory; a native
        directory without its config.json still raises."""
        import dataclasses

        from da3slam_tpu_torch.models.nested import DepthAnything3Nested

        d = tmp_path / "nested"
        sd = {k: torch.tensor(np.array(v)) for k, v in
              export_torch_style(jax.tree.map(np.asarray, jmodel.params)).items()}
        both = {f"model.{k}": v for k, v in sd.items()}
        both.update({f"metric_model.{k}": v for k, v in sd.items()})
        weights.save_checkpoint(d, both, get_preset("tiny"))
        if jmodel.cfg.mlp_type == "swiglu":  # no preset is a SwiGLU tiny: name it
            cfg = dataclasses.asdict(jmodel.cfg)
            (d / "config.json").write_text(json.dumps({"model": cfg, "metric_model": cfg}))
        nested = DepthAnything3.from_pretrained(str(d), device="cpu")
        assert isinstance(nested, DepthAnything3Nested)
        jnested = JDA3.from_pretrained(str(d))
        pred = nested.inference(image=IMGS, process_res=70)
        jpred = jnested.inference(image=IMGS, process_res=70)
        # the metric scale multiplies depth and translations: held as the
        # dense maps are, 1e-4 of the largest value
        np.testing.assert_allclose(pred.depth, jpred.depth, rtol=1e-4,
                                   atol=1e-4 * np.abs(jpred.depth).max())
        np.testing.assert_allclose(pred.extrinsics, jpred.extrinsics, rtol=1e-4,
                                   atol=1e-4 * np.abs(jpred.extrinsics).max())
        assert abs(pred.metric_scale - jpred.metric_scale) <= 1e-5 * abs(jpred.metric_scale)

        pickled = tmp_path / "pickled"
        pickled.mkdir()
        torch.save(sd, pickled / "pytorch_model.bin")
        (pickled / "config.json").write_text(json.dumps(dataclasses.asdict(jmodel.cfg)))
        model = DepthAnything3.from_pretrained(str(pickled), device="cpu")
        assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jmodel.cfg)
        assert_same_prediction(model, jmodel)
        assert_same_prediction(model, JDA3.from_pretrained(str(pickled)))

        native = tmp_path / "native"
        weights.save_checkpoint(native, {"encoder": {"norm": {"scale": torch.ones(2)}}},
                                get_preset("tiny"))
        (native / "config.json").unlink()
        with pytest.raises(FileNotFoundError, match="config.json"):
            DepthAnything3.from_pretrained(str(native), device="cpu")

    def test_config_from_json_equals_jax(self, tmp_path):
        import dataclasses

        from da3slam_tpu.models.config import config_from_json as jconfig_from_json

        path = tmp_path / "config.json"
        blob = dataclasses.asdict(jget_preset("giant"))
        blob["unknown_key"] = 1
        path.write_text(json.dumps(blob))
        assert dataclasses.asdict(config_from_json(path)) == \
            dataclasses.asdict(jconfig_from_json(path))
        assert config_from_json(path) == get_preset("giant")


class TestSafetensorsFormat:
    def test_flatten_unflatten_equal_jax(self):
        from da3slam_tpu.models.weights import unflatten_params as junflatten

        tree = {"a": {"b": [np.ones(2), {"c": np.zeros(3)}]}, "d": np.arange(4)}
        flat = weights.flatten_params(tree)
        assert list(flat) == list(jflatten(tree)) == ["a/b/0", "a/b/1/c", "d"]
        back, jback = weights.unflatten_params(flat), junflatten(jflatten(tree))
        assert isinstance(back["a"]["b"], list) and back["a"]["b"][1].keys() == {"c"}
        assert jax.tree.structure(back) == jax.tree.structure(jback)

    def test_every_dtype_round_trips_bit_equal(self, tmp_path):
        tensors = all_dtypes()
        weights.save_file(tensors, tmp_path / "t.safetensors")
        back = weights.load_file(tmp_path / "t.safetensors")
        assert set(back) == set(tensors)
        for k, t in tensors.items():
            assert back[k].dtype == t.dtype and back[k].shape == t.shape, k
            assert torch.equal(back[k], t), k
        # numpy arrays are taken too
        weights.save_file({"x": np.arange(6, dtype=np.int32).reshape(2, 3)}, tmp_path / "n.st")
        assert weights.load_file(tmp_path / "n.st")["x"].tolist() == [[0, 1, 2], [3, 4, 5]]

    def test_agrees_with_the_safetensors_package(self, tmp_path):
        st_numpy = pytest.importorskip("safetensors.numpy")
        st_torch = pytest.importorskip("safetensors.torch")
        tensors = all_dtypes()
        weights.save_file(tensors, tmp_path / "ours.safetensors")
        theirs = st_torch.load_file(str(tmp_path / "ours.safetensors"))
        assert set(theirs) == set(tensors)
        for k, t in tensors.items():
            assert theirs[k].dtype == t.dtype and torch.equal(theirs[k], t), k
        no_bf16 = {k: t.numpy() for k, t in tensors.items() if t.dtype != torch.bfloat16}
        # numpy has no bf16: the other dtypes, from a file without it
        weights.save_file(no_bf16, tmp_path / "ours_np.safetensors")
        by_numpy = st_numpy.load_file(str(tmp_path / "ours_np.safetensors"))
        for k, a in no_bf16.items():
            assert by_numpy[k].dtype == a.dtype
            np.testing.assert_array_equal(by_numpy[k], a)
        # and the other way: their files, our reader (metadata entry skipped)
        st_torch.save_file({k: t.contiguous() for k, t in tensors.items()},
                           str(tmp_path / "theirs.safetensors"), metadata={"format": "pt"})
        ours = weights.load_file(tmp_path / "theirs.safetensors")
        assert set(ours) == set(tensors)
        for k, t in tensors.items():
            assert ours[k].dtype == t.dtype and torch.equal(ours[k], t), k

    def test_broken_files_raise(self, tmp_path):
        good = tmp_path / "good.safetensors"
        weights.save_file({"x": torch.arange(10.0), "y": torch.ones(3)}, good)
        raw = good.read_bytes()
        (n,) = struct.unpack("<Q", raw[:8])

        def write(name, data):
            (tmp_path / name).write_bytes(data)
            return tmp_path / name

        with pytest.raises(ValueError, match="spans bytes"):
            weights.load_file(write("cut_body", raw[:-5]))
        with pytest.raises(ValueError, match="exceeds the file"):
            weights.load_file(write("cut_header", raw[:8 + n // 2]))
        with pytest.raises(ValueError, match="shorter than"):
            weights.load_file(write("tiny", raw[:5]))
        with pytest.raises(ValueError, match="not JSON"):
            weights.load_file(write("not_json", raw[:8] + b"{" * n + raw[8 + n:]))
        bad = json.dumps({"x": {"dtype": "F99", "shape": [1], "data_offsets": [0, 4]}}).encode()
        with pytest.raises(ValueError, match="bad header entry"):
            weights.load_file(write("bad_dtype", struct.pack("<Q", len(bad)) + bad + b"\0" * 4))
        wrong = json.dumps({"x": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}).encode()
        with pytest.raises(ValueError, match="spans bytes"):
            weights.load_file(write("wrong_size",
                                    struct.pack("<Q", len(wrong)) + wrong + b"\0" * 8))
        with pytest.raises(TypeError, match="no safetensors name"):
            weights.save_file({"c": torch.zeros(2, dtype=torch.complex64)}, tmp_path / "c")
