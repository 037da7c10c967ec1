"""The port's 3×3 conv against the JAX package's Pallas kernel and ``F.conv2d``.

CPU cases: ``conv3x3_reference`` (what ``conv3x3_fused`` runs on CPU tensors)
against ``da3slam_tpu.ops.conv3x3.conv3x3_fused`` through the Pallas
interpreter, on the cases of ``tests/test_conv3x3.py`` and the same numpy
inputs.  f32 to 1e-4 (both sum exact f32 products, in another order; the JAX
test's own bound against XLA); bf16 to the JAX test's own atol 0.1, rtol 0.05.
CUDA cases (marker ``cuda``, skipped without a card) hold the hand-written
kernel to the plain version on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_conv3x3.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from da3slam_tpu_torch.ops.conv3x3 import (
    TILE_H,
    TILE_W,
    conv3x3_eligible,
    conv3x3_fused,
    conv3x3_reference,
)

torch.set_num_threads(2)

JAX_CASES = [  # tests/test_conv3x3.py::test_matches_xla_conv
    ((2, 16, 20, 8), 4, True),
    ((1, 24, 9, 16), 8, False),
    ((2, 16, 16, 3), 5, False),
]


def operands(seed, shape, cout, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, shape[-1], cout)) * scale).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, k, b


def jax_conv(x, k, b, relu, dtype="float32"):
    import jax.numpy as jnp

    from da3slam_tpu.ops.conv3x3 import conv3x3_fused as j_conv

    out = j_conv(jnp.asarray(k), jnp.asarray(b), jnp.asarray(x, getattr(jnp, dtype)),
                 relu=relu, interpret=True)
    return np.asarray(out, np.float32)


def torch_conv(x, k, b, relu):
    """F.conv2d on the same operands: NHWC/HWIO in and out."""
    out = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b, padding=1).permute(0, 2, 3, 1)
    return out.relu() if relu else out


class TestPlainMatchesJax:
    @pytest.mark.parametrize("shape,cout,relu", JAX_CASES)
    def test_f32(self, shape, cout, relu):
        x, k, b = operands(0, shape, cout)
        out = conv3x3_fused(*(torch.from_numpy(a) for a in (k, b, x)), relu=relu)
        assert out.dtype == torch.float32 and out.shape == (*shape[:3], cout)
        np.testing.assert_allclose(out.numpy(), jax_conv(x, k, b, relu), atol=1e-4, rtol=1e-4)

    def test_zero_padding_boundary(self):
        """Border pixels see zero padding, not wrapped neighbours: a ones
        input makes any leak visible (8 / 12 / 18 taps × channels)."""
        x, k, b = np.ones((1, 8, 8, 2), np.float32), np.ones((3, 3, 2, 1), np.float32), \
            np.zeros((1,), np.float32)
        out = conv3x3_fused(*(torch.from_numpy(a) for a in (k, b, x))).numpy()[0, :, :, 0]
        assert (out[0, 0], out[0, 4], out[4, 4]) == (8.0, 12.0, 18.0)
        np.testing.assert_array_equal(out, jax_conv(x, k, b, False)[0, :, :, 0])

    def test_bf16_in_bf16_out(self):
        x, k, b = operands(1, (1, 16, 12, 8), 4)
        out = conv3x3_fused(torch.from_numpy(k), torch.from_numpy(b),
                            torch.from_numpy(x).bfloat16())
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), jax_conv(x, k, b, False, "bfloat16"),
                                   atol=0.1, rtol=0.05)
        # the kernel is cast to bf16 and the sum kept in f32, as the TPU kernel
        # does: against the f32 oracle on the rounded operands, one output ulp
        xr = torch.from_numpy(x).bfloat16().float()
        kr = torch.from_numpy(k).bfloat16().float()
        ref = torch_conv(xr, kr, torch.from_numpy(b), False)
        assert (out.float() - ref).abs().max() <= 2.0 ** -8 * ref.abs().max()


class TestRaggedAndGates:
    def test_ragged_height_the_tpu_kernel_refuses(self):
        """H = 37 does not tile by 8: the JAX package's gate says no, the port
        takes it (the edge is masked in its kernel).  1e-4 against F.conv2d."""
        import jax.numpy as jnp

        from da3slam_tpu.ops.conv3x3 import conv3x3_eligible as j_eligible

        x, k, b = operands(2, (2, 37, 45, 21), 40, scale=0.1)
        assert not j_eligible(jnp.asarray(x), jnp.asarray(k))
        xt, kt, bt = (torch.from_numpy(a) for a in (x, k, b))
        assert conv3x3_eligible(xt, kt)
        for relu in (False, True):
            out = conv3x3_fused(kt, bt, xt, relu=relu)
            np.testing.assert_allclose(out.numpy(), torch_conv(xt, kt, bt, relu).numpy(),
                                       atol=1e-4)

    def test_eligibility_gates(self):
        x = torch.zeros(1, 16, 16, 8)
        k = torch.zeros(3, 3, 8, 4)
        assert conv3x3_eligible(x, k)
        assert conv3x3_eligible(torch.zeros(1, 15, 16, 8), k)  # any height
        assert conv3x3_eligible(x.bfloat16(), k)
        assert not conv3x3_eligible(x, torch.zeros(1, 1, 8, 4))  # not 3x3
        assert not conv3x3_eligible(x, torch.zeros(3, 3, 4, 4))  # channel mismatch
        assert not conv3x3_eligible(x[0], k)  # not 4-D
        assert not conv3x3_eligible(x.double(), k)  # a dtype the kernel is not compiled for
        assert not conv3x3_eligible(x.half(), k)
        with pytest.raises(ValueError, match="unsupported operands"):
            conv3x3_fused(k, torch.zeros(4), x.double())
        with pytest.raises(ValueError, match="bias"):
            conv3x3_fused(k, torch.zeros(5), x)

    def test_cpu_tensors_run_the_plain_version_and_count_no_launch(self):
        x, k, b = (torch.from_numpy(a) for a in operands(3, (1, 9, 11, 5), 3))
        before = conv3x3_fused.launches
        out = conv3x3_fused(k, b, x, relu=True)
        assert conv3x3_fused.launches == before
        assert torch.equal(out, conv3x3_reference(k, b, x, relu=True))


class TestDroppedHaloBreaksTheSmokeBound:
    """chip_smoke.py holds the kernel to ``conv_bound`` of the plain output; a
    kernel that staged a tile without its halo column or row must break it."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_bound_catches_a_dropped_halo(self, dtype):
        x, k, b = (torch.from_numpy(a) for a in
                   operands(4, (2, TILE_H + 9, TILE_W + 13, 16), 8, scale=0.1))
        x = x.to(dtype)
        ref = conv3x3_reference(k, b, x)
        cut = chip_smoke.dropped_halo_errors(k, b, x, ref, relu=False)
        assert cut["column"] > chip_smoke.conv_bound(ref)
        assert cut["row"] > chip_smoke.conv_bound(ref)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


CARD_CASES = [(s, c, r, torch.float32) for s, c, r in JAX_CASES] + [
    ((1, 16, 12, 8), 4, False, torch.bfloat16),
    ((2, 37, 45, 21), 40, True, torch.float32),  # ragged in H, W, C and COUT
    ((2, 37, 45, 24), 40, False, torch.bfloat16),
    ((1, 5, 3, 1), 1, False, torch.float32),  # smaller than one tile
    ((2, 64, 96, 64), 32, True, torch.bfloat16),  # whole tiles, the head2 channels
]


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("shape,cout,relu,dtype", CARD_CASES)
    def test_kernel_matches_plain(self, card, shape, cout, relu, dtype):
        x, k, b = (torch.from_numpy(a).to(card) for a in operands(5, shape, cout, scale=0.1))
        x = x.to(dtype)
        before = conv3x3_fused.launches
        out = conv3x3_fused(k, b, x, relu=relu)
        torch.cuda.synchronize()
        assert conv3x3_fused.launches == before + 1
        ref = conv3x3_reference(k, b, x, relu=relu)
        assert out.dtype == dtype and out.shape == ref.shape
        assert (out.float() - ref.float()).abs().max().item() <= chip_smoke.conv_bound(ref)

    def test_ones_border_on_card(self, card):
        x = torch.ones(1, 40, 70, 2, device=card)
        out = conv3x3_fused(torch.ones(3, 3, 2, 1, device=card), torch.zeros(1, device=card), x)
        out = out[0, :, :, 0].cpu()
        assert (out[0, 0], out[0, 4], out[4, 4], out[39, 69]) == (8.0, 12.0, 18.0, 8.0)
        # tile edges (16 rows, 32 columns) are interior pixels like any other
        assert out[1:-1, 1:-1].eq(18.0).all()

    def test_refuses_what_the_kernel_does_not_take(self, card):
        k, b = torch.zeros(3, 3, 8, 4, device=card), torch.zeros(4, device=card)
        with pytest.raises(ValueError, match="contiguous"):
            conv3x3_fused(k, b, torch.zeros(1, 8, 16, 16, device=card).transpose(1, 3))
        with pytest.raises(ValueError, match="tensors on"):
            conv3x3_fused(k.cpu(), b, torch.zeros(1, 16, 16, 8, device=card))
