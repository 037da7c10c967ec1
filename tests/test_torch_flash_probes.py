"""The port's flash probe forwards against the JAX package's probe kernels.

CPU cases: each plain version (what the wrappers run on CPU tensors) against
the ``_kernel`` of the JAX package's ``tools/flash_nomax_probe.py``,
``tools/flash_bound_bisect.py`` and ``tools/flash_lab.py``, loaded by path and
run through the Pallas interpreter with the tool's own block specs, on the
same numpy inputs in bf16 (the tools' type) at S = 300 in blocks of 128.
Tolerances: O to 2^-6·max|O| (p is rounded to bf16 at the same point in both;
an f32 difference in the logits can tip a p across a rounding boundary, the
lab's running max is taken over 128 keys there and 16 here, and O is rounded
to bf16: two to four output ulps), lse to 1e-3.  CUDA cases (marker ``cuda``,
skipped without a card) hold the hand-written kernels to the plain versions:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_probes.py
"""

import functools
import importlib.util
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from da3slam_tpu_torch.ops.flash_probes import (
    BISECT_VARIANTS,
    LAB_VARIANTS,
    PROBE_M,
    flash_bisect,
    flash_bisect_reference,
    flash_lab,
    flash_lab_reference,
    flash_nomax,
    flash_nomax_reference,
)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
BH, D, S, BLOCK = 2, 64, 300, 128
SP = -(-S // BLOCK) * BLOCK  # 384: the padded length, 84 padded keys
BF16_REL_TOL = 2.0 ** -6
LSE_TOL = 1e-3


def load_tool(name):
    """One of the JAX package's root ``tools/*.py`` scripts as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(seed, q_scale=0.18, zero_pad=True):
    """q ~ q_scale·N(0, 1), k, v ~ N(0, 1), [BH, SP, 64], rounded to bf16; the
    padded k and v rows are zeros when ``zero_pad``."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BH, SP, D)) * q_scale
    k, v = rng.normal(size=(2, BH, SP, D))
    if zero_pad:
        k[:, S:] = 0
        v[:, S:] = 0
    return [torch.from_numpy(a.astype(np.float32)).bfloat16() for a in (q, k, v)]


def to_jax(*ts):
    import jax.numpy as jnp

    return [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts]


def assert_o_close(o, o_jax):
    o, o_jax = o.float().numpy(), np.asarray(o_jax, np.float32)
    assert np.isfinite(o).all()
    assert np.abs(o - o_jax).max() <= BF16_REL_TOL * np.abs(o_jax).max()


def jax_bisect(tool, q, k, v, m, variant, seq_k):
    """``tools/flash_bound_bisect.py``'s call as its ``run`` builds it (or
    ``tools/flash_nomax_probe.py``'s when ``variant`` is None), interpreted."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    qspec = pl.BlockSpec((1, BLOCK, D), lambda b, qi, ki: (b, qi, 0))
    kspec = pl.BlockSpec((1, BLOCK, D), lambda b, qi, ki: (b, ki, 0))
    rowq = pl.BlockSpec((1, BLOCK, 8), lambda b, qi, ki: (b, qi, 0))
    o_shape = jax.ShapeDtypeStruct((BH, SP, D), jnp.bfloat16)
    common = dict(grid=(BH, SP // BLOCK, SP // BLOCK),
                  scratch_shapes=[pltpu.VMEM((BLOCK, 128), jnp.float32)], interpret=True)
    if variant is None:
        call = pl.pallas_call(functools.partial(tool._kernel, head_dim=D),
                              in_specs=[qspec, kspec, kspec], out_specs=qspec,
                              out_shape=o_shape, **common)
        return call(*to_jax(q, k, v)), None
    use_m_ref, mask = tool.VARIANTS[variant]["use_m_ref"], tool.VARIANTS[variant]["mask"]
    call = pl.pallas_call(
        functools.partial(tool._kernel, head_dim=D, seq_k=seq_k, use_m_ref=use_m_ref, mask=mask),
        in_specs=[qspec, kspec, kspec] + ([rowq] if use_m_ref else []),
        out_specs=(qspec, rowq),
        out_shape=(o_shape, jax.ShapeDtypeStruct((BH, SP, 8), jnp.float32)), **common)
    args = to_jax(q, k, v)
    if use_m_ref:
        args.append(jnp.asarray(np.repeat(m.numpy()[:, :, None], 8, axis=2)))
    o, lse = call(*args)
    return o, np.asarray(lse)[:, :, 0]


def row_shift(seed):
    """A per-row shift in [14.5, 15.5): not the constant, so a kernel that
    ignored its m input would show."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((14.5 + rng.uniform(size=(BH, SP))).astype(np.float32))


class TestNomaxAndBisectMatchJax:
    def test_nomax(self):
        q, k, v = inputs(0, zero_pad=False)  # every key of the array counts
        o_jax, _ = jax_bisect(load_tool("flash_nomax_probe"), q, k, v, None, None, SP)
        assert_o_close(flash_nomax(q, k, v), o_jax)

    @pytest.mark.parametrize("variant", sorted(BISECT_VARIANTS))
    def test_bisect(self, variant):
        tool = load_tool("flash_bound_bisect")
        assert {t: (c["use_m_ref"], c["mask"]) for t, c in tool.VARIANTS.items()} == BISECT_VARIANTS
        q, k, v = inputs(1)
        m = row_shift(2)
        o_jax, lse_jax = jax_bisect(tool, q, k, v, m, variant, S)
        o, lse = flash_bisect(q, k, v, variant, m, seq_k=S)
        assert_o_close(o, o_jax)
        np.testing.assert_allclose(lse.numpy(), lse_jax, atol=LSE_TOL)

    def test_variants_differ_where_they_should(self):
        """With 84 padded keys: counting them (B) moves lse against masking
        them (C); the two masks (C, D) are the same function; subtracting the
        padding's share (E) equals the mask because the padded rows are
        zeros; A ignores m."""
        q, k, v = inputs(1)
        m = row_shift(2)
        out = {t: flash_bisect(q, k, v, t, m, seq_k=S) for t in sorted(BISECT_VARIANTS)}
        assert torch.equal(out["C"][0], out["D"][0]) and torch.equal(out["C"][1], out["D"][1])
        assert (out["B"][1] - out["C"][1]).min() > 0.05  # log2(384/300)-ish more mass
        # E sums the padded keys' p after rounding it to bf16 and subtracts the
        # unrounded exp2(-m): 84 keys x up to 2^-9 relative, of ~300 in the sum
        np.testing.assert_allclose(out["E"][1].numpy(), out["C"][1].numpy(), atol=2e-3)
        assert (out["E"][0].float() - out["C"][0].float()).abs().max() <= 2.0 ** -8
        a_const = flash_bisect(q, k, v, "A", None, seq_k=S)
        assert torch.equal(out["A"][0], a_const[0]) and torch.equal(out["A"][1], a_const[1])
        b_const = flash_bisect(q, k, v, "B", torch.full((BH, SP), PROBE_M), seq_k=S)
        assert torch.equal(b_const[0], a_const[0])  # B with m = 15 is A
        assert not torch.equal(out["B"][1], b_const[1])
        assert torch.equal(flash_nomax(q, k, v), a_const[0])

    def test_subtract_with_nonzero_padding_is_not_the_mask(self):
        """The subtraction removes exp2(-m) a padded key: right only for zero
        k rows.  The plain version follows the kernel, not the intent."""
        q, k, v = inputs(3, zero_pad=False)
        m = row_shift(4)
        e, c = (flash_bisect(q, k, v, t, m, seq_k=S)[1] for t in "EC")
        assert (e - c).abs().max() > 1e-2


def jax_lab(tool, q, k, v, variant, seq_k, nh):
    from jax.experimental import pallas as pl

    with mock.patch.object(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)), \
            mock.patch.object(tool, "N_INNER", 1):
        fn, sp = tool.make_fn(BH, seq_k, D, variant, BLOCK, BLOCK, nh)
        assert sp == SP
        return fn(*to_jax(q, k, v))


class TestLabMatchesJax:
    @pytest.mark.parametrize("variant,nh", [(v, 1) for v in LAB_VARIANTS] + [("new", 2)])
    def test_lab(self, variant, nh):
        q, k, v = inputs(5, q_scale=1.0, zero_pad=False)  # the tool's inputs: all N(0, 1)
        o_jax = jax_lab(load_tool("flash_lab"), q, k, v, variant, S, nh)
        assert_o_close(flash_lab(q, k, v, variant, seq_k=S, nh=nh), o_jax)

    def test_is_softmax_attention_over_the_unpadded_keys(self):
        rng = np.random.default_rng(6)
        q, k, v = (torch.from_numpy(a.astype(np.float32)) for a in rng.normal(size=(3, BH, 70, D)))
        ref = torch.softmax(q @ k[:, :50].transpose(1, 2) / D ** 0.5, -1) @ v[:, :50]
        for variant in LAB_VARIANTS:  # f32: nothing is rounded, the variants coincide
            np.testing.assert_allclose(flash_lab(q, k, v, variant, seq_k=50).numpy(), ref.numpy(),
                                       atol=2e-6)
        assert torch.equal(flash_lab(q, k, v, "new", seq_k=50, nh=2),
                           flash_lab(q, k, v, "new", seq_k=50))

    def test_old_and_new_differ_by_their_denominators(self):
        """Two keys, logits 0 and log2(0.7517): p = (1, 0.7517 → 0.75 in
        bf16).  ``new`` divides by the rounded sum 1.75 and returns the exact
        convex combination 0.75·v1/1.75; ``old`` divides by the unrounded
        1.7517 and lands 0.1% lower, which moves some of the 64 output
        columns (v1 sweeps the bf16 values in [1, 1.5)) down by one bf16 ulp."""
        scale = 1.4426950408889634 / 8.0
        q = torch.zeros(1, 1, D)
        k = torch.zeros(1, 2, D)
        v = torch.zeros(1, 2, D)
        q[0, 0, 0], k[0, 1, 0] = 1.0078125, -2.265625
        v[0, 1] = 1.0 + torch.arange(D) / 128.0
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        p1 = 2.0 ** (1.0078125 * -2.265625 * scale)
        assert 0.75 < p1 < 0.751953125  # rounds down to 0.75
        new = flash_lab(q, k, v, "new").float()[0, 0]
        old = flash_lab(q, k, v, "old").float()[0, 0]
        exact_new = (0.75 * v.double()[0, 1] / 1.75).float().bfloat16().float()
        exact_old = (0.75 * v.double()[0, 1] / (1 + p1)).float().bfloat16().float()
        assert torch.equal(new, exact_new) and torch.equal(old, exact_old)
        assert (old <= new).all() and 5 <= int((old < new).sum()) < D
        assert torch.equal(flash_lab(q, k, v, "qs").float()[0, 0] <= new, torch.ones(D).bool())


class TestWrappers:
    def test_cpu_tensors_run_the_plain_versions_and_count_no_launch(self):
        q, k, v = inputs(7)
        m = row_shift(8)
        before = (flash_nomax.launches, flash_bisect.launches, flash_lab.launches)
        assert torch.equal(flash_nomax(q, k, v), flash_nomax_reference(q, k, v))
        for a, b in zip(flash_bisect(q, k, v, "E", m, seq_k=S),
                        flash_bisect_reference(q, k, v, "E", m, seq_k=S)):
            assert torch.equal(a, b)
        assert torch.equal(flash_lab(q, k, v, "old", seq_k=S),
                           flash_lab_reference(q, k, v, "old", seq_k=S))
        assert before == (flash_nomax.launches, flash_bisect.launches, flash_lab.launches)

    def test_bad_arguments_raise(self):
        q, k, v = inputs(9)
        with pytest.raises(ValueError, match="unknown variant"):
            flash_bisect(q, k, v, "F")
        with pytest.raises(ValueError, match="per-row shift"):
            flash_bisect(q, k, v, "C", seq_k=S)
        with pytest.raises(ValueError, match="unknown variant"):
            flash_lab(q, k, v, "new2")
        with pytest.raises(ValueError, match="nh 3 must divide"):
            flash_lab(q, k, v, "new", nh=3)
        with pytest.raises(ValueError, match="seq_k"):
            flash_lab(q, k, v, "new", seq_k=SP + 1)
        with pytest.raises(ValueError, match="expected q"):
            flash_nomax(q, k[:1], v[:1])
        with pytest.raises(ValueError, match="share a dtype"):
            flash_nomax(q.float(), k, v)

    @pytest.mark.parametrize("tool,argv", [
        ("flash_nomax_probe", ["128,256", "--S", "300"]),
        ("flash_bound_bisect", ["A", "C", "E", "--S", "300", "--bq", "128", "--bk", "128"]),
        ("flash_lab", ["300", "--pad", "128", "--nh", "2"]),
        ("probe_conv3x3", ["tiny"]),
    ])
    def test_tools_run_on_the_cpu_when_asked(self, tool, argv, capsys, monkeypatch):
        """Each tool's ``main`` at a small size with ``--device cpu``: one
        line and one row a case, the plain version against itself (error 0)."""
        mod = importlib.import_module(f"da3slam_tpu_torch.tools.{tool}")
        if tool == "probe_conv3x3":
            monkeypatch.setattr(mod, "SHAPES", [("tiny", 2, 19, 21, 8, 5)])
        rows = mod.main(argv + ["--device", "cpu"])
        lines = [ln for ln in capsys.readouterr().out.splitlines() if " ms" in ln]
        assert len(rows) == len(lines) == {"flash_bound_bisect": 3, "flash_lab": 3}.get(tool, 1)
        assert all(r["max_abs_err"] == 0.0 and r["ms"] > 0 for r in rows)
        assert all("max|err| vs plain" in ln and "TFLOP/s" in ln for ln in lines)
        if torch.cuda.is_available():
            return
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def assert_kernel_close(o, o_ref):
    assert torch.isfinite(o).all()
    err = (o.float() - o_ref.float()).abs().max().item()
    assert err <= BF16_REL_TOL * o_ref.float().abs().max().item()


CARD_SHAPES = [(SP, SP, S), (333, 1301, 1250), (63, 50, 50)]  # (Sq, Sk, seq_k)


@pytest.mark.cuda
class TestKernelsOnCard:
    @staticmethod
    def card_inputs(card, Sq, Sk, seq_k, q_scale):
        gen = torch.Generator(device=card).manual_seed(10)
        q = (torch.randn(BH, Sq, D, generator=gen, device=card) * q_scale).bfloat16()
        k, v = (torch.randn(BH, Sk, D, generator=gen, device=card).bfloat16() for _ in range(2))
        k[:, seq_k:] = 0
        v[:, seq_k:] = 0
        m = 14.5 + torch.rand(BH, Sq, generator=gen, device=card)
        return q, k, v, m

    @pytest.mark.parametrize("Sq,Sk,seq_k", CARD_SHAPES)
    def test_nomax_and_bisect(self, card, Sq, Sk, seq_k):
        q, k, v, m = self.card_inputs(card, Sq, Sk, seq_k, 0.18)
        before = (flash_nomax.launches, flash_bisect.launches)
        assert_kernel_close(flash_nomax(q, k, v), flash_nomax_reference(q, k, v))
        for variant in sorted(BISECT_VARIANTS):
            o, lse = flash_bisect(q, k, v, variant, m, seq_k=seq_k)
            o_ref, lse_ref = flash_bisect_reference(q, k, v, variant, m, seq_k=seq_k)
            torch.cuda.synchronize()
            assert_kernel_close(o, o_ref)
            assert (lse - lse_ref).abs().max().item() <= LSE_TOL, variant
        assert (flash_nomax.launches, flash_bisect.launches) == (before[0] + 1, before[1] + 5)

    @pytest.mark.parametrize("Sq,Sk,seq_k", CARD_SHAPES)
    @pytest.mark.parametrize("variant,nh", [(v, 1) for v in LAB_VARIANTS] + [("new", 2)])
    def test_lab(self, card, Sq, Sk, seq_k, variant, nh):
        q, k, v, _ = self.card_inputs(card, Sk, Sk, seq_k, 1.0)
        before = flash_lab.launches
        o = flash_lab(q, k, v, variant, seq_k=seq_k, nh=nh)
        torch.cuda.synchronize()
        assert flash_lab.launches == before + 1
        assert_kernel_close(o, flash_lab_reference(q, k, v, variant, seq_k=seq_k))

    def test_refuses_what_the_kernels_do_not_take(self, card):
        q, k, v, m = self.card_inputs(card, 64, 64, 64, 1.0)
        with pytest.raises(ValueError, match="compiled for bf16"):
            flash_nomax(q.float(), k.float(), v.float())
        with pytest.raises(ValueError, match="contiguous"):
            flash_lab(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
        with pytest.raises(ValueError, match="one CUDA device"):
            flash_bisect(q, k, v, "B", m.cpu())
