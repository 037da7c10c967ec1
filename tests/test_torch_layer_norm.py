"""The bf16 LayerNorm kernel's dispatch on the CPU (``ops/layer_norm.py``):
CPU, f32 and grad-requiring tensors keep the composition of
``models/vit.py:layer_norm`` / ``models/vggt.py:qk_norm_rope`` and move no
counter; the rule on what takes the kernel; the row geometry the wrapper hands
it (views read in place, copies where the kernel cannot read them); a model of
the kernel's RoPE lanes against ``apply_rope``; the counts in the
``model.inference`` spans; and the benchmark's ``model.norm_kernel_share``
on synthetic span records.  The kernel itself runs on the card only
(``tests/test_torch_layer_norm_cuda.py``)."""

from __future__ import annotations

import importlib.util
import math
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from da3slam_tpu_torch.models import vggt, vit
from da3slam_tpu_torch.models.da3 import DepthAnything3
from da3slam_tpu_torch.ops import layer_norm as fused
from da3slam_tpu_torch.utils import profiling
from da3slam_tpu_torch.utils.profiling import SpanRecord
from slambench.lib import program_spans as ps
from slambench.lib.drive import Run
from slambench.lib.spec import metric_reader

_spec = importlib.util.spec_from_file_location(
    "layer_norm_ref", Path(__file__).parent / "fixtures" / "layer_norm_ref.py")
REF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF)


def _counts():
    return fused.layer_norm.launches, fused.layer_norm.eager


def _norm(width: int, seed: int) -> nn.LayerNorm:
    g = torch.Generator().manual_seed(seed)
    ln = nn.LayerNorm(width, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.5 * torch.randn(width, generator=g))
        ln.bias.copy_(0.3 * torch.randn(width, generator=g))
    return ln


# -- the composition stays where the kernel does not run ---------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [False, True])
def test_cpu_tensors_keep_the_composition(dtype, grad):
    ln = _norm(384, 0)
    x = (2 * torch.randn(5, 7, 384, generator=torch.Generator().manual_seed(1)) + 1).to(dtype)
    before = _counts()
    with torch.set_grad_enabled(grad):
        got = vit.layer_norm(ln, x.requires_grad_(grad) if dtype == torch.float32 else x)
    want = F.layer_norm(x.float(), (384,), ln.weight.float(), ln.bias.float(), 1e-6).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert (got.grad_fn is not None) == grad
    assert _counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qk_norm_rope_on_the_cpu_is_the_composition(dtype):
    ln = _norm(64, 2)
    g = torch.Generator().manual_seed(3)
    qkv = (3 * torch.randn(2, 9, 3 * 128, generator=g)).to(dtype)
    q = vggt._split_heads(qkv, 2)[0]
    cos, sin = vggt.rope_tables((2, 2), 64, 5, 100.0)
    before = _counts()
    got = vggt.qk_norm_rope(ln, q, cos, sin)
    y = F.layer_norm(q.float(), (64,), ln.weight.float(), ln.bias.float(), 1e-6)
    assert torch.equal(got, vggt.apply_rope(y, cos, sin).to(dtype))
    assert _counts() == before


def test_a_tensor_that_requires_grad_keeps_its_gradient():
    ln = _norm(32, 4)
    x = torch.randn(3, 32, requires_grad=True)
    vit.layer_norm(ln, x).sum().backward()
    assert x.grad is not None and ln.weight.grad is not None


# -- which tensors take the kernel -------------------------------------------------

def _stub(shape, dtype=torch.bfloat16, device="cuda", requires_grad=False):
    """What ``takes`` reads of a tensor, standing in for a CUDA one."""
    return SimpleNamespace(shape=shape, ndim=len(shape), dtype=dtype,
                           device=SimpleNamespace(type=device), requires_grad=requires_grad)


@pytest.mark.parametrize("width", [32, 64, 384, 1024, 1536, 2048])
def test_every_cuda_bf16_norm_that_wants_no_gradient_takes_the_kernel(width):
    w = _stub((width,), torch.float32)
    before = _counts()
    with torch.no_grad():
        assert fused.takes(_stub((19515, width)), w, w)
    assert _counts() == before


@pytest.mark.parametrize("width", [1020, 4096])
def test_the_kernel_raises_on_a_width_it_does_not_hold(width):
    ln = _norm(width, 0)
    with pytest.raises(ValueError, match="width"):
        fused.layer_norm(ln.weight, ln.bias, torch.zeros(2, width, dtype=torch.bfloat16), 1e-6)


def test_a_wanted_gradient_sends_a_cuda_bf16_norm_to_the_composition():
    frozen, live = _stub((1024,), torch.float32), _stub((1024,), torch.float32, requires_grad=True)
    x, x_grad = _stub((8, 1024)), _stub((8, 1024), requires_grad=True)
    before = _counts()
    with torch.no_grad():  # nothing is recorded for autograd: the kernel
        assert fused.takes(x_grad, live, live)
    with torch.enable_grad():
        assert fused.takes(x, frozen, frozen)  # nothing requires grad
        assert not fused.takes(x_grad, frozen, frozen)
        assert not fused.takes(x, live, frozen)  # the weight's gradient
    assert _counts() == (before[0], before[1] + 2)


@pytest.mark.parametrize("x", [_stub((8, 1024), torch.float32), _stub((8, 1024), device="cpu"),
                               _stub((8, 1024), torch.float32, device="cpu")],
                         ids=["f32-cuda", "bf16-cpu", "f32-cpu"])
def test_f32_and_cpu_norms_are_no_candidates(x):
    w = _stub((1024,), torch.float32)
    before = _counts()
    assert not fused.takes(x, w, w)
    assert _counts() == before


def test_the_rope_epilogue_raises_on_heads_other_than_64():
    ln = _norm(16, 0)
    cos = torch.ones(30, 2, 4)
    with pytest.raises(ValueError, match="layer_norm_rope"):  # vggt-tiny's heads
        fused.layer_norm_rope(ln.weight, ln.bias, torch.zeros(3, 30, 4, 16, dtype=torch.bfloat16),
                              cos, cos, 1e-6)


def test_the_kernel_raises_off_the_card():
    ln = _norm(64, 0)
    with pytest.raises(ValueError, match="CUDA"):
        fused.layer_norm(ln.weight, ln.bias, torch.zeros(2, 64, dtype=torch.bfloat16), 1e-6)
    cos = torch.ones(3, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fused.layer_norm_rope(ln.weight, ln.bias, torch.zeros(1, 3, 2, 64), cos, cos, 1e-6)


# -- the rows the kernel is handed ------------------------------------------------

def test_a_contiguous_tensor_is_one_run_of_rows():
    x = torch.zeros(3, 7, 1024, dtype=torch.bfloat16)
    y, sizes, strides = fused._rows(x, merge=True)
    assert y is x and sizes == [1, 1, 21] and strides == [0, 0, 1024]


def test_a_tap_with_its_prefix_cut_is_read_in_place():
    tap = torch.zeros(3, 1301, 2048, dtype=torch.bfloat16)
    x = tap[:, 5:, :]
    y, sizes, strides = fused._rows(x, merge=True)
    assert y is x and sizes == [1, 3, 1296] and strides == [0, 1301 * 2048, 2048]


def test_the_q_third_of_qkv_keeps_view_position_and_head():
    qkv = torch.zeros(2, 7, 3 * 4 * 64, dtype=torch.bfloat16)
    q = vggt._split_heads(qkv, 4)[0]
    y, sizes, strides = fused._rows(q, merge=False)
    assert y is q and sizes == [2, 7, 4] and strides == [7 * 768, 768, 64]
    k = vggt._split_heads(qkv, 4)[1]  # 256 elements in: 512 bytes, aligned
    assert fused._rows(k, merge=False)[0] is k


def test_what_the_kernel_cannot_read_is_copied():
    base = torch.zeros(4, 1 + 1024, dtype=torch.bfloat16)
    x = base[:, 1:]  # rows 1025 apart: not 16-byte steps
    y, sizes, strides = fused._rows(x, merge=True)
    assert y.is_contiguous() and y.data_ptr() != base.data_ptr()
    assert sizes == [1, 1, 4] and strides == [0, 0, 1024]
    # more than three row indices that do not merge: one contiguous copy
    z = torch.zeros(2, 3, 4, 5, 64, dtype=torch.bfloat16)[:, :2, :3, :4]
    y, sizes, strides = fused._rows(z, merge=True)
    assert y.is_contiguous() and sizes == [1, 1, 2 * 2 * 3 * 4] and strides == [0, 0, 64]


def _kernel_rope(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The RoPE epilogue as the kernel's lanes compute it on a normed
    ``y [B, P, H, 64]``: lane l holds channels 8l..8l+7, half l // 4, part
    (l // 2) % 2, table entries from 8·(l % 2), its partner lane l ^ 2."""
    lanes = y.unflatten(-1, (8, 8))  # [..., lane, value]
    out = torch.empty_like(lanes)
    for lane in range(8):
        half, part_b, j0 = lane // 4, (lane // 2) % 2, 8 * (lane % 2)
        c = cos[:, half, j0:j0 + 8][:, None]  # [P, 1, 8]: over the heads
        s = sin[:, half, j0:j0 + 8][:, None]
        own, partner = lanes[..., lane, :], lanes[..., lane ^ 2, :]
        out[..., lane, :] = own * c + partner * s if part_b else own * c - partner * s
    return out.flatten(-2)


def test_the_kernel_lanes_pair_channels_as_apply_rope():
    cos, sin = vggt.rope_tables((4, 5), 64, 5, 100.0)
    y = torch.randn(2, 25, 3, 64, generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(_kernel_rope(y, cos, sin), vggt.apply_rope(y, cos, sin),
                               rtol=0, atol=1e-6)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c in f32 with one rounding, as the card's fused multiply-add."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm of f32 rows ``x [R, W]`` in the kernel's order of f32
    operations: ``lanes`` lanes a row (the fewest of 8, 16, 32 that hold it in
    8 vectors of 8 a lane), lane l holding vectors l, l + lanes, ...; each
    lane sums its values in turn, the lanes' sums meet by xor shuffles; then
    the variance of the centred values the same way, and the affine."""
    R, W = x.shape
    nvec = W // 8
    lanes = next(n for n in (8, 16, 32) if nvec <= 8 * n)
    assert nvec % lanes == 0
    v = x.reshape(R, nvec // lanes, lanes, 8)

    def group_sum(parts, square: bool = False):
        s = torch.zeros(R, lanes)
        for i in range(parts.shape[1]):
            for e in range(8):
                t = parts[:, i, :, e]
                s = _fma(t, t, s) if square else s + t
        o = lanes // 2
        while o:
            s = s + s[:, torch.arange(lanes) ^ o]
            o //= 2
        return s[:, :1, None, None]

    mean = group_sum(v) / W
    d = v - mean
    rstd = torch.rsqrt(group_sum(d, square=True) / W + eps)
    return _fma(d * rstd, w.reshape(nvec // lanes, lanes, 8), b.reshape(nvec // lanes, lanes, 8)) \
        .reshape(R, W)


@pytest.mark.parametrize("width", [384, 1024, 1536, 2048])
def test_a_lane_model_of_the_kernel_is_the_composition_within_one_ulp_above_the_floor(width):
    """Summed in the kernel's order, the f32 statistics differ from the
    composition's in their last bits.  Near zero, where x − mean cancels, that
    is many bf16 ulps of the output (the raw measure); above 2^-12 of the
    largest value it is at most one: the measure the card tests hold the
    kernel to (``fixtures/layer_norm_ref.py:ulps``)."""
    g = torch.Generator().manual_seed(width)
    x = (2 * torch.randn(4000, width, generator=g) + 0.7).bfloat16()
    ln = _norm(width, width)
    want = vit.layer_norm(ln, x)
    got = _kernel_norm(x.float(), ln.weight.detach(), ln.bias.detach(), 1e-6).bfloat16()
    assert REF.ulps(got, want, floor=0) > 1
    assert REF.ulps(got, want) <= 1


def test_a_lane_model_of_qk_norm_and_rope_is_the_composition_within_one_ulp_above_the_floor():
    ln = _norm(64, 6)
    qkv = (3 * torch.randn(4, 300, 3 * 1024, generator=torch.Generator().manual_seed(6)) + 0.5)
    q = vggt._split_heads(qkv.bfloat16(), 16)[0]
    ang = 40 * torch.rand(300, 2, 16, generator=torch.Generator().manual_seed(7),
                          dtype=torch.float64)
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    y = _kernel_norm(q.float().reshape(-1, 64), ln.weight.detach(), ln.bias.detach(), 1e-6)
    got = _kernel_rope(y.reshape(q.shape), cos, sin).bfloat16()
    want = vggt.qk_norm_rope(ln, q, cos, sin)
    assert REF.ulps(got, want, floor=0) > 1
    assert REF.ulps(got, want) <= 1


# -- the JAX package's LayerNorm, which the card tests hold the kernel to ------------

@pytest.mark.parametrize("width", REF.WIDTHS)
def test_the_stored_outputs_are_the_jax_package_s(width):
    with np.load(REF.PATH) as f:
        assert np.array_equal(REF.jax_outputs(width), f[f"w{width}"])


@pytest.mark.parametrize("width", REF.WIDTHS)
def test_the_composition_is_the_jax_layer_norm(width):
    x, w, b = REF.inputs(width)
    ln = nn.LayerNorm(width, eps=REF.EPS)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    got = vit.layer_norm(ln, torch.from_numpy(x).bfloat16())
    assert REF.ulps(got, torch.from_numpy(REF.load()[width])) <= 1.0


# -- the counts in the model.inference span -----------------------------------------

def test_count_norms_records_the_change_over_its_block():
    attrs = {}
    with fused.count_norms(attrs):
        fused.layer_norm.launches += 3
        fused.layer_norm.eager += 1
    assert attrs == {"norms_kernel": 3, "norms_eager": 1}


@pytest.mark.parametrize("make", [
    lambda: DepthAnything3.from_pretrained("tiny", device="cpu"),
    lambda: vggt.VGGT(vggt.PRESETS["vggt-tiny"], vggt.init_params(vggt.PRESETS["vggt-tiny"], 1)),
], ids=["da3", "vggt"])
def test_the_inference_span_carries_the_norm_counts(make):
    model = make()
    frames = np.random.default_rng(5).integers(0, 256, size=(2, 56, 70, 3)).astype(np.uint8)
    t0 = time.perf_counter()
    model.inference(frames, process_res=70)
    spans = [r for r in profiling.records(since=t0) if r.name == "model.inference"]
    assert len(spans) == 1
    assert {k: spans[0].attrs[k] for k in ("norms_kernel", "norms_eager")} == \
        {"norms_kernel": 0, "norms_eager": 0}  # the CPU: no candidate


# -- model.norm_kernel_share ---------------------------------------------------------

HOST0 = 500.0  # perf_counter seconds at the window's steady part


def _rec(i, name, at_s, **attrs):
    return SpanRecord(i, name, HOST0 + at_s, HOST0 + at_s + 0.01, None, ("s", i), 1, attrs)


def _run(monkeypatch, recs):
    fake = SimpleNamespace(records=lambda since=-math.inf: [r for r in recs if r.start > since],
                           snapshot=lambda: {"dropped": 0, "dropped_through": HOST0 + 1.0})
    monkeypatch.setattr(ps, "_recorder", lambda: fake)
    run = Run(None, 0, 1.0, True, "offline")
    run.steady, run.t_close = (HOST0, 0.0), HOST0 + 10.0
    return run


def test_the_share_of_norms_on_the_kernel(monkeypatch):
    read = metric_reader("model.norm_kernel_share")
    recs = [_rec(1, "model.inference", -1.0, norms_kernel=0, norms_eager=9),  # before the slice
            _rec(2, "model.inference", 1.0, views=15, norms_kernel=81, norms_eager=0),
            _rec(3, "model.inference", 1.5, views=1, norms_kernel=40, norms_eager=9),
            _rec(4, "model.nested", 1.6, fetches=1),
            _rec(5, "model.inference", 2.0, views=15, norms_kernel=30, norms_eager=0),
            _rec(6, "model.inference", 11.0, norms_kernel=0, norms_eager=50)]  # after the close
    assert read(_run(monkeypatch, recs)) == pytest.approx(100.0 * 151 / 160)
    every = [_rec(i, "model.inference", float(i), norms_kernel=197, norms_eager=0)
             for i in (1, 2, 3)]
    assert read(_run(monkeypatch, every)) == 100.0


def test_nothing_to_read_is_none(monkeypatch):
    read = metric_reader("model.norm_kernel_share")
    older = [_rec(i, "model.inference", float(i), views=15) for i in (1, 2)]  # no counts
    assert read(_run(monkeypatch, older)) is None
    on_cpu = [_rec(1, "model.inference", 1.0, norms_kernel=0, norms_eager=0)]
    assert read(_run(monkeypatch, on_cpu)) is None
    run = _run(monkeypatch, on_cpu)
    run.trace = False  # an untraced run
    assert read(run) is None
