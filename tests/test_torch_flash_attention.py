"""The port's bound-mode attention against the JAX package's Pallas forward.

CPU cases: the plain torch version (``flash_attention_bound_reference``)
against ``da3slam_tpu``'s ``flash_attention(stable=False)`` run through the
Pallas interpreter, on the same numpy inputs.  CUDA cases (marker ``cuda``,
skipped without a card) hold the hand-written kernel against the plain
version on the card.  JAX is imported inside the CPU cases only, so the CUDA
cases run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py
"""

import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from da3slam_tpu_torch.ops.attention import multi_head_attention
from da3slam_tpu_torch.ops.flash_attention import (
    flash_attention_bound,
    flash_attention_bound_reference,
)

torch.set_num_threads(2)


def rand_qkv(seed, B, S, H, D=64, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))
    return q * scale, k, v


def jax_bound(q, k, v, dtype):
    """The JAX package's max-free forward in interpret mode: (O, lse [BH, S])."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from da3slam_tpu.ops.flash_attention import _flash_forward

    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call", functools.partial(orig, interpret=True)):
        o, res = _flash_forward(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                128, 128, stable=False)
    S = q.shape[1]
    return np.asarray(o, np.float32), np.asarray(res[-1][:, :S, 0])


def port_bound(q, k, v, dtype):
    o, lse = flash_attention_bound(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)))
    return o.float().numpy(), lse.numpy()


class TestPlainMatchesJax:
    # f32: same formula, same rounding points; only the summation order of
    # the logits and of p·V differs (~1e-7 relative)
    @pytest.mark.parametrize("S", [128, 300])
    def test_f32(self, S):
        q, k, v = rand_qkv(20, 2, S, 3)
        o_j, lse_j = jax_bound(q, k, v, torch.float32)
        o_t, lse_t = port_bound(q, k, v, torch.float32)
        np.testing.assert_allclose(o_t, o_j, atol=2e-6)
        np.testing.assert_allclose(lse_t, lse_j, atol=2e-5)

    def test_bf16(self):
        # bf16: a p near a rounding boundary can round the other way, and the
        # output is rounded to bf16 (1 ulp = 2^-8 relative): 2e-2 is the JAX
        # package's own bf16 bound for this forward
        q, k, v = rand_qkv(21, 1, 256, 2)
        o_j, _ = jax_bound(q, k, v, torch.bfloat16)
        o_t, _ = port_bound(q, k, v, torch.bfloat16)
        np.testing.assert_allclose(o_t, o_j, atol=2e-2)

    def test_underflow_pathology_gives_zeros(self):
        """30x-scaled diffuse q: the bound exceeds every logit by more than
        f32's exponent range, every p flushes to 0 and both give zeros (not
        NaN)."""
        q, k, v = rand_qkv(23, 1, 128, 1, scale=30.0)
        o_j, _ = jax_bound(q, k, v, torch.float32)
        o_t, _ = port_bound(q, k, v, torch.float32)
        np.testing.assert_array_equal(o_j, 0.0)
        np.testing.assert_array_equal(o_t, 0.0)

    def test_matches_exact_softmax_attention(self):
        """At layernormed scales the bound forward is softmax attention."""
        q, k, v = rand_qkv(24, 2, 200, 2)
        o_t, _ = port_bound(q, k, v, torch.float32)
        qt, kt, vt = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
        p = torch.softmax(qt @ kt.transpose(-1, -2) / 8.0, dim=-1)
        ref = (p @ vt).transpose(1, 2).numpy()
        np.testing.assert_allclose(o_t, ref, atol=5e-6)


class TestDispatch:
    def test_cpu_never_launches_the_kernel(self):
        q, k, v = (torch.from_numpy(x) for x in rand_qkv(25, 2, 64, 2))
        before = flash_attention_bound.launches
        out = multi_head_attention(q, k, v)
        assert flash_attention_bound.launches == before
        ref, _ = flash_attention_bound_reference(q, k, v)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)

    def test_unsupported_device_raises(self):
        q = torch.zeros(1, 4, 1, 64, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            flash_attention_bound(q, q, q)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize(
        "dtype,shape,tol",
        [
            (torch.bfloat16, (3, 1301, 2, 64), 2e-2),  # intra-view sequence length
            (torch.bfloat16, (1, 777, 6, 64), 2e-2),  # ragged last q and k tile
            (torch.float32, (2, 300, 3, 64), 5e-5),
            (torch.float32, (1, 63, 1, 64), 5e-5),  # shorter than one tile
        ],
    )
    def test_kernel_matches_plain(self, card, dtype, shape, tol):
        gen = torch.Generator(device=card).manual_seed(0)
        q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype) for _ in range(3))
        before = flash_attention_bound.launches
        o, lse = flash_attention_bound(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention_bound.launches == before + 1
        o_ref, lse_ref = flash_attention_bound_reference(q, k, v)
        assert torch.isfinite(o).all()
        assert (o.float() - o_ref.float()).abs().max().item() <= tol
        assert (lse - lse_ref).abs().max().item() <= 1e-3

    def test_kernel_underflow_gives_zeros(self, card):
        q, k, v = (torch.from_numpy(x).to(card) for x in rand_qkv(23, 1, 128, 1, scale=30.0))
        o, _ = flash_attention_bound(q, k, v)
        assert (o == 0).all()

    def test_wrapper_rejects_what_the_kernel_does_not_take(self, card):
        x = torch.zeros(1, 8, 2, 64, device=card)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention_bound(*(torch.zeros(1, 8, 2, 32, device=card),) * 3)
        with pytest.raises(ValueError, match="dtype"):
            flash_attention_bound(x.half(), x.half(), x.half())
        with pytest.raises(ValueError, match="contiguous"):
            t = torch.zeros(1, 2, 8, 64, device=card).transpose(1, 2)
            flash_attention_bound(t, t, t)
        with pytest.raises(ValueError, match="head_dim"):
            multi_head_attention(*(torch.zeros(1, 8, 1, 128, device=card),) * 3)
