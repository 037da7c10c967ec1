"""The port's tensor-parallel rules (``parallel/sharding.py``) against the
JAX package's ``_spec_for``, the shard cut and its inverse, and the Megatron
operators of ``parallel/comm.py`` on two gloo ranks against plain sums.

Each JAX parameter leaf k is filled with the value k + 1 and carried over by
``convert``: the values of a port tensor then name the JAX leaves it came
from (``w12`` holds two, gate and value), and the JAX spec of each reads in
the port's ``[out, in]`` layout by transposing a 2-D linear's.
"""

import numpy as np
import pytest
import torch

import jax

from da3slam_tpu.models.config import get_preset as jget_preset
from da3slam_tpu.models.da3 import init_params as jinit
from da3slam_tpu.parallel.sharding import _path_strings, _spec_for
from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.convert import convert
from da3slam_tpu_torch.models.da3 import DA3Net
from da3slam_tpu_torch.parallel import run_ranks
from da3slam_tpu_torch.parallel.sharding import (
    check_tp,
    param_shardings,
    shard_tensor,
    unshard_tensor,
)

import test_torch_train_bodies as bodies

SWIGLU = {"mlp_type": "swiglu", "mlp_ratio": 4.0}
CONFIGS = {"tiny": {}, "tiny_swiglu": SWIGLU}


def jax_specs_in_port_layout(cfg_kw: dict) -> dict[str, tuple]:
    """Each port parameter's spec from the JAX leaves it holds."""
    jcfg = jget_preset("tiny").with_overrides(**cfg_kw)
    params = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    ids = treedef.unflatten([np.full(leaf.shape, i + 1, np.float32)
                             for i, (_, leaf) in enumerate(leaves)])
    specs = [_spec_for(_path_strings(path)) for path, _ in leaves]
    out = {}
    for name, t in convert(ids).items():
        found = {int(v) - 1 for v in np.unique(t.numpy()) if v}
        port = set()
        for i in found:
            spec, ndim = tuple(specs[i]), leaves[i][1].ndim
            if ndim == 2 and spec:  # [in, out] -> [out, in]
                spec = spec[::-1]
            port.add(spec)
        assert len(port) == 1, (name, port)  # gate and value split alike
        out[name] = port.pop()
    return out


class TestRules:
    @pytest.mark.parametrize("config", ["tiny", "tiny_swiglu"])
    def test_param_shardings_equal_jax(self, config):
        """Every parameter's rule, by name, as the JAX package's for the leaves
        it holds: column-parallel qkv / fc1 / w12, row-parallel proj / fc2 /
        w3, everything else (the camera head's own MLP included) replicated."""
        kw = CONFIGS[config]
        net = DA3Net(get_preset("tiny").with_overrides(**kw))
        want = jax_specs_in_port_layout(kw)
        got = param_shardings(net)
        assert set(got) == set(want)
        for name, spec in want.items():
            assert got[name] == spec, name

    def test_only_block_linears_split(self):
        sh = param_shardings(DA3Net(get_preset("tiny").with_overrides(**SWIGLU)))
        split = sorted({n.split(".", 2)[2] for n, s in sh.items() if s})
        assert split == ["attn.proj.weight", "attn.qkv.bias", "attn.qkv.weight",
                         "mlp.w12.bias", "mlp.w12.weight", "mlp.w3.weight"]

    @pytest.mark.parametrize("tp,ok", [(1, True), (2, True), (3, True), (4, False), (6, True)])
    def test_tp_must_divide_heads_and_hidden(self, tp, ok):
        """SMALL: 6 heads, hidden 1536."""
        if ok:
            check_tp(get_preset("small"), tp)
        else:
            with pytest.raises(ValueError, match=f"tp={tp} must divide num_heads 6"):
                check_tp(get_preset("small"), tp)


class TestCut:
    @pytest.mark.parametrize("config", ["tiny", "tiny_swiglu"])
    @pytest.mark.parametrize("tp", [1, 2])
    def test_cut_and_put_back_is_identity(self, config, tp):
        net = DA3Net(get_preset("tiny").with_overrides(**CONFIGS[config]))
        torch.manual_seed(0)
        for name, p in net.named_parameters():
            whole = torch.randn(p.shape)
            shards = [shard_tensor(name, whole, r, tp) for r in range(tp)]
            assert torch.equal(unshard_tensor(name, shards), whole), name

    def test_fused_tensors_are_cut_by_heads(self):
        """qkv: rank r holds heads r·H/tp.. of each of q, k and v; w12: the
        same slice of gate and value."""
        D, tp = 32, 2
        qkv = torch.arange(3 * D, dtype=torch.float32)[:, None].expand(3 * D, 4)
        got = shard_tensor("blocks.0.attn.qkv.weight", qkv, 1, tp)[:, 0]
        want = torch.cat([torch.arange(p * D + D // 2, (p + 1) * D) for p in range(3)])
        assert torch.equal(got, want.float())
        w12 = torch.arange(8, dtype=torch.float32)
        assert shard_tensor("blocks.0.mlp.w12.bias", w12, 0, tp).tolist() == [0, 1, 4, 5]


@pytest.fixture(scope="module")
def operators():
    rng = np.random.default_rng(0)
    x, w = (rng.normal(size=(2, 5)).astype(np.float32) for _ in range(2))
    return x, w, run_ranks(bodies.operator_checks, 2, "gloo", "cpu", 120, x, w)


class TestOperators:
    def test_copy_to_group(self, operators):
        """f: identity forward; the input's gradient is the sum of the ranks'."""
        x, w, out = operators
        for r, ops in enumerate(out["ops"]):
            y, g = ops["f"]
            np.testing.assert_array_equal(y, x[r])
            np.testing.assert_allclose(g, w.sum(0), rtol=1e-6)

    def test_reduce_from_group(self, operators):
        """g: the sum forward on every rank; the gradient passes unchanged."""
        x, w, out = operators
        for ops in out["ops"]:
            y, g = ops["g"]
            np.testing.assert_allclose(y, x.sum(0), rtol=1e-6)
            np.testing.assert_array_equal(g, w[0])

    def test_gather_from_group(self, operators):
        """The all-gather forward; the gradient is this rank's rows."""
        x, w, out = operators
        for r, ops in enumerate(out["ops"]):
            y, g = ops["gather"]
            np.testing.assert_array_equal(y, x)
            np.testing.assert_array_equal(g, w[r:r + 1])

    def test_ranks_import_no_jax(self, operators):
        assert operators[2]["foreign"] == [[], []]
