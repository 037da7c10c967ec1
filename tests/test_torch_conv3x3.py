"""The port's 3×3 conv against the JAX package's Pallas kernel and ``F.conv2d``.

CPU cases: ``conv3x3_reference`` (what ``conv3x3_fused`` runs on CPU tensors)
against ``da3slam_tpu.ops.conv3x3.conv3x3_fused`` through the Pallas
interpreter, on the cases of ``tests/test_conv3x3.py`` and the same numpy
inputs.  f32 to 1e-4 (both sum exact f32 products, in another order; the JAX
test's own bound against XLA); bf16 to the JAX test's own atol 0.1, rtol 0.05.
The wgmma kernel's packed weights, read back through their swizzle, give the
plain conv (one bf16 ulp).  CUDA cases (marker ``cuda``, skipped without a
card) hold the hand-written kernels to the plain version on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_conv3x3.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from da3slam_tpu_torch.ops.conv3x3 import (
    CHUNK,
    TILE_H,
    TILE_W,
    conv3x3_eligible,
    conv3x3_fused,
    conv3x3_reference,
    pack_weights,
    packed_weights,
    strip_width,
    uses_wgmma,
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
        before = (conv3x3_fused.launches, conv3x3_fused.direct_launches)
        out = conv3x3_fused(k, b, x, relu=True)
        assert (conv3x3_fused.launches, conv3x3_fused.direct_launches) == before
        assert torch.equal(out, conv3x3_reference(k, b, x, relu=True))


def gemm_from_packed(x, w, cout, n_tile):
    """The wgmma kernel's sum written out on the CPU from the packed weights:
    for each strip, 64-channel chunk and tap, the shifted input times the tap's
    [n_tile, 64] slice, read back through the 128-byte swizzle (row n's
    16-byte chunk j at position j ^ (n % 8)); f32 sums of bf16 values."""
    N, H, W, C = x.shape
    ns, nc = w.shape[:2]
    xp = torch.nn.functional.pad(x.float(), (0, nc * CHUNK - C, 1, 1, 1, 1))
    rows = torch.arange(n_tile)[:, None]
    slots = torch.arange(8)[None, :] ^ (rows % 8)  # the position of logical chunk j
    out = torch.zeros(N, H, W, ns * n_tile)
    for s in range(ns):
        for c in range(nc):
            for tap in range(9):
                sl = w[s, c, tap][rows, slots].reshape(n_tile, CHUNK).float()  # [n, channels]
                dh, dw = divmod(tap, 3)
                xs = xp[:, dh:dh + H, dw:dw + W, c * CHUNK:(c + 1) * CHUNK]
                out[..., s * n_tile:(s + 1) * n_tile] += xs @ sl.T
    return out[..., :cout]


class TestWgmmaLayout:
    """The wgmma kernel's operands as the wrapper prepares them (its arithmetic
    runs only on the card: ``TestKernelOnCard``)."""

    @pytest.mark.parametrize("C,cout", [(8, 4), (24, 40), (64, 32), (72, 130), (16, 128)])
    def test_packed_weights_give_the_plain_conv(self, C, cout):
        x, k, b = (torch.from_numpy(a) for a in operands(6, (2, 11, 13, C), cout, scale=0.1))
        x = x.bfloat16()
        n_tile = strip_width(cout)
        w = pack_weights(k, n_tile)
        assert w.dtype == torch.bfloat16 and w.is_contiguous()
        assert w.shape == (-(-cout // n_tile), -(-C // CHUNK), 9, n_tile, 8, 8)
        ref = conv3x3_reference(k, b, x)
        out = (gemm_from_packed(x, w, cout, n_tile) + b).bfloat16()
        assert (out.float() - ref.float()).abs().max() <= 2.0 ** -8 * ref.float().abs().max()

    def test_packing_is_the_bf16_kernel_swizzled(self):
        """Row n of a tap's slice is output channel strip·n_tile + n; its
        16-byte chunk j (channels 8j to 8j + 7) sits at position j ^ (n % 8);
        channels past C and outputs past COUT are zeros."""
        k = torch.from_numpy(operands(7, (1, 3, 3, 24), 40)[1])
        w = pack_weights(k, 32)  # 2 strips of 32 outputs, 1 chunk of 64 channels
        kb = k.bfloat16()
        zeros = torch.zeros(8, dtype=torch.bfloat16)
        for s, n in ((0, 0), (0, 5), (1, 7), (1, 8), (1, 31)):
            co = 32 * s + n
            for j in range(8):
                want = kb[1, 1, 8 * j:8 * j + 8, co] if co < 40 and j < 3 else zeros
                assert torch.equal(w[s, 0, 4, n, j ^ (n % 8)], want), (s, n, j)  # centre tap

    def test_packed_once_per_kernel_and_version(self):
        """The wrapper packs a kernel tensor once; an in-place update (its
        version counter) packs it again."""
        k = torch.from_numpy(operands(8, (1, 3, 3, 16), 8)[1])
        first = packed_weights(k, 32)
        assert packed_weights(k, 32) is first
        assert torch.equal(first, pack_weights(k, 32))
        k.mul_(2.0)
        again = packed_weights(k, 32)
        assert again is not first and torch.equal(again, pack_weights(k, 32))
        assert not torch.equal(again, first)

    def test_shape_rule(self):
        k = torch.zeros(3, 3, 8, 4)
        x = torch.zeros(1, 4, 4, 8)
        assert uses_wgmma(x.bfloat16(), 4)
        assert not uses_wgmma(x, 4)  # f32: the direct kernel
        assert not uses_wgmma(torch.zeros(1, 4, 4, 21).bfloat16(), 4)  # TMA strides C * 2 bytes
        assert uses_wgmma(x.bfloat16(), 1024) and not uses_wgmma(x.bfloat16(), 1025)  # bias stage
        assert conv3x3_eligible(x.bfloat16(), k)
        assert [strip_width(c) for c in (1, 32, 40, 64, 65, 128, 130)] == \
            [32, 32, 32, 32, 128, 128, 128]


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
    # bf16 around the wgmma kernel's pixel tiles (16 x 32 for COUT <= 64, 16 x
    # 16 above), C = 8 and 24 (one k16 step and a half chunk of the 64 staged)
    ((1, 15, 31, 8), 32, True, torch.bfloat16),  # one short of a tile
    ((2, 17, 33, 8), 32, False, torch.bfloat16),  # one past
    ((1, 16, 32, 24), 32, False, torch.bfloat16),  # exactly one
    ((2, 31, 65, 24), 128, True, torch.bfloat16),
    ((1, 17, 17, 8), 128, False, torch.bfloat16),
    ((1, 33, 47, 24), 130, False, torch.bfloat16),  # two strips of 128
    ((2, 20, 20, 12), 32, False, torch.bfloat16),  # C % 8 != 0: the direct kernel
]


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("shape,cout,relu,dtype", CARD_CASES)
    def test_kernel_matches_plain(self, card, shape, cout, relu, dtype):
        x, k, b = (torch.from_numpy(a).to(card) for a in operands(5, shape, cout, scale=0.1))
        x = x.to(dtype)
        before = (conv3x3_fused.launches, conv3x3_fused.direct_launches)
        out = conv3x3_fused(k, b, x, relu=relu)
        torch.cuda.synchronize()
        # the shape rule alone picks the kernel, and its count shows which ran
        direct = 0 if uses_wgmma(x, cout) else 1
        assert (conv3x3_fused.launches, conv3x3_fused.direct_launches) == \
            (before[0] + 1, before[1] + direct)
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
