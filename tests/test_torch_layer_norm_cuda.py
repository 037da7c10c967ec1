"""The one-pass bf16 LayerNorm kernel and its QK-norm + RoPE epilogue
(``da3slam_tpu_torch/ops/layer_norm.py``, ``ops/csrc/layer_norm.cu``) on the
card, held to the composition it replaces (``models/vit.py:layer_norm``,
``models/vggt.py:qk_norm_rope`` on a tensor that requires grad, which keeps
the composition) within one bf16 unit in the last place of every element; the
counters and the dispatch; the counts in a ``model.inference`` span.  Marker
``cuda``, skipped without one; no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_layer_norm_cuda.py
"""

from __future__ import annotations

import importlib.util
import time
from pathlib import Path

import pytest
import torch
from torch import nn

from da3slam_tpu_torch.models import vggt, vit
from da3slam_tpu_torch.models.da3 import DepthAnything3
from da3slam_tpu_torch.ops import layer_norm as fused
from da3slam_tpu_torch.utils import profiling

_spec = importlib.util.spec_from_file_location(
    "layer_norm_ref", Path(__file__).parent / "fixtures" / "layer_norm_ref.py")
REF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _norm(width: int, device, seed: int, eps: float = 1e-6) -> nn.LayerNorm:
    g = torch.Generator().manual_seed(seed)
    ln = nn.LayerNorm(width, eps=eps)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.5 * torch.randn(width, generator=g))
        ln.bias.copy_(0.3 * torch.randn(width, generator=g))
    return ln.to(device)


def _composition(fn, ln: nn.LayerNorm, x: torch.Tensor, *rest):
    """``fn`` (``vit.layer_norm``-like) on a tensor that requires grad: the
    dispatch leaves it to the composition (and counts it eager)."""
    with torch.enable_grad():
        out = fn(ln, x.detach().requires_grad_(), *rest)
    assert out.grad_fn is not None
    return out.detach()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [384, 1024, 1536, 2048])
@pytest.mark.parametrize("rows", [1, 37, 19515])
def test_the_kernel_is_the_composition_within_one_ulp(card, width, rows):
    g = torch.Generator(device=card).manual_seed(width + rows)
    x = (2 * torch.randn(rows, width, generator=g, device=card) + 0.7).bfloat16()
    ln = _norm(width, card, seed=width)
    with torch.no_grad():
        got = vit.layer_norm(ln, x)
    want = _composition(vit.layer_norm, ln, x)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape and got.is_contiguous()
    assert REF.ulps(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("width", REF.WIDTHS)
def test_the_kernel_is_the_jax_layer_norm_within_one_ulp(card, width):
    """The JAX package's f32-statistics LayerNorm of the same bf16 rows,
    weight and bias (37 rows: the last block partly empty)."""
    x, w, b = REF.inputs(width)
    ln = nn.LayerNorm(width, eps=REF.EPS)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        launches = fused.layer_norm.launches
        got = vit.layer_norm(ln.to(card), torch.from_numpy(x).to(card).bfloat16())
    assert fused.layer_norm.launches == launches + 1
    assert REF.ulps(got.cpu(), torch.from_numpy(REF.load()[width])) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1024, 2048])
def test_a_strided_tap_is_read_in_place(card, width):
    """A tap ``[N, S, C]`` with its 5 prefix tokens cut: rows S·C apart
    between views, C apart within one; an odd number of views and tokens."""
    g = torch.Generator(device=card).manual_seed(11)
    tap = torch.randn(3, 1301, width, generator=g, device=card).bfloat16()
    x = tap[:, 5:, :]
    assert not x.is_contiguous()
    ln = _norm(width, card, seed=5)
    with torch.no_grad():
        got = vit.layer_norm(ln, x)
    assert got.shape == x.shape and REF.ulps(got, _composition(vit.layer_norm, ln, x)) <= 1.0
    with torch.no_grad():  # and equal to the kernel on a contiguous copy
        assert torch.equal(got, vit.layer_norm(ln, x.contiguous()))


def _rope(positions: int, device, seed: int):
    g = torch.Generator().manual_seed(seed)
    ang = 40 * torch.rand(positions, 2, 16, generator=g, dtype=torch.float64)
    return torch.cos(ang).float().to(device), torch.sin(ang).float().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(15, 1301), (1, 19515)], ids=["frame", "global"])
def test_qk_norm_rope_from_the_qkv_buffer(card, shape):
    """q and k read from a qkv projection's output ``[N, P, 3·16·64]`` as
    the aggregator splits it, against ``qk_norm_rope``'s composition; out
    contiguous ``[N, P, 16, 64]``."""
    N, P = shape
    g = torch.Generator(device=card).manual_seed(P)
    qkv = (3 * torch.randn(N, P, 3 * 1024, generator=g, device=card) + 0.5).bfloat16()
    q, k, _ = vggt._split_heads(qkv, 16)
    assert q.data_ptr() == qkv.data_ptr() and not q.is_contiguous()
    cos, sin = _rope(P, card, seed=P)
    for t, seed in ((q, 1), (k, 2)):
        ln = _norm(64, card, seed, eps=1e-6)
        with torch.no_grad():
            got = vggt.qk_norm_rope(ln, t, cos, sin)
        want = _composition(vggt.qk_norm_rope, ln, t, cos, sin)
        assert got.shape == t.shape and got.is_contiguous()
        assert REF.ulps(got, want) <= 1.0


@pytest.mark.cuda
def test_rope_tables_of_the_model_and_unrotated_special_tokens(card):
    """The model's own tables (grid 36 × 36, 5 special tokens at p = 0): the
    special tokens come out as the plain LayerNorm of their heads."""
    cos, sin = vggt.rope_tables((36, 36), 64, 5, 100.0, card)
    qkv = torch.randn(2, 1301, 3 * 1024, device=card).bfloat16()
    q = vggt._split_heads(qkv, 16)[0]
    ln = _norm(64, card, seed=3)
    with torch.no_grad():
        got = vggt.qk_norm_rope(ln, q, cos, sin)
        plain = vit.layer_norm(ln, q[:, :5].contiguous())
    assert REF.ulps(got, _composition(vggt.qk_norm_rope, ln, q, cos, sin)) <= 1.0
    assert REF.ulps(got[:, :5], plain) <= 1.0


@pytest.mark.cuda
def test_counters_and_dispatch(card):
    ln = _norm(1024, card, seed=7)
    x = torch.randn(9, 1024, device=card).bfloat16()
    launches, eager = fused.layer_norm.launches, fused.layer_norm.eager
    with torch.no_grad():
        out = vit.layer_norm(ln, x)
    assert out.grad_fn is None
    assert (fused.layer_norm.launches, fused.layer_norm.eager) == (launches + 1, eager)
    # grad enabled but nothing requires it: the kernel
    frozen = _norm(1024, card, seed=7).requires_grad_(False)
    vit.layer_norm(frozen, x)
    assert (fused.layer_norm.launches, fused.layer_norm.eager) == (launches + 2, eager)
    # a gradient wanted of x, or of the weights alone: the composition, counted eager
    vit.layer_norm(ln, x.clone().requires_grad_()).float().sum().backward()
    y = vit.layer_norm(ln, x)
    assert y.grad_fn is not None
    y.float().sum().backward()
    assert ln.weight.grad is not None
    assert (fused.layer_norm.launches, fused.layer_norm.eager) == (launches + 2, eager + 2)
    # f32 on the card: not a candidate, counted in neither
    vit.layer_norm(ln, x.float())
    with torch.no_grad():
        vit.layer_norm(ln, x.float())
    assert (fused.layer_norm.launches, fused.layer_norm.eager) == (launches + 2, eager + 2)


@pytest.mark.cuda
def test_the_inference_span_counts_the_norms(card):
    """DA3-SMALL in bf16: 12 blocks × 2 norms and the final norm, all on the
    kernel."""
    model = DepthAnything3.from_pretrained("small", seed=1, device="cuda")
    frames = torch.randint(0, 256, (2, 56, 70, 3), dtype=torch.uint8)
    t0 = time.perf_counter()
    model.inference(frames.numpy(), process_res=70)
    span = [r for r in profiling.records(since=t0) if r.name == "model.inference"]
    assert len(span) == 1
    assert span[0].attrs["norms_kernel"] == 2 * model.cfg.depth + 1
    assert span[0].attrs["norms_eager"] == 0
