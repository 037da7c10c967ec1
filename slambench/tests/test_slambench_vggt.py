"""The ``vggt`` kind (VGGT-1B): at a tiny size on the CPU it builds, runs the
offline driver and comes out ``correct``, and a fault planted in the port
alone comes out not ``correct``; its operation count at the published sizes
matches a hand count; the three metrics it adds read a synthetic span
record."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest
import torch

from slambench.lib import check
from slambench.lib import program_spans as ps
from slambench.lib.drive import Run
from slambench.lib.model import build, chunk_flops
from slambench.lib.spec import BENCH_DIR, metric_reader
from slambench.lib.trace import TraceSlice
from slambench.tests.test_slambench_harness import run_tiny
from da3slam_tpu_torch.utils.profiling import SpanRecord

CONFIG = json.loads((BENCH_DIR / "configs" / "vggt-1b.json").read_text())
TINY_NETWORK = dict(CONFIG["network"], embed_dim=64, num_heads=4, dino_depth=2, depth=2,
                    dpt_layers=[0, 1, 1, 1], dpt_dim=16, dpt_features=[8, 16, 24, 32],
                    camera_depth=2, camera_heads=4, camera_iters=2)


@pytest.fixture
def vggt_bench(tiny_bench):
    """``tiny_bench`` with a tiny ``vggt`` configuration and its offline cell
    (the tiny cell's 7-frame sequences, chunk 4), as new files.  Its runs
    take a 6 s window: ~0.7 s a chunk on a quiet CPU, so a loaded one still
    completes a sequence's two chunks for the comparison."""
    bench, folder = tiny_bench
    (folder / "configs" / "tiny-vggt.json").write_text(json.dumps(
        dict(CONFIG, name="tiny-vggt", network=TINY_NETWORK)))
    (folder / "workloads" / "tiny-vggt-offline.json").write_text(
        (folder / "workloads" / "tiny-offline.json").read_text())
    bench["workloads"].append({"name": "tiny-vggt-offline", "config": "tiny-vggt",
                               "traffic": "tiny-offline", "chips": 1, "why": "test size"})
    return bench, folder


def test_the_vggt_kind_runs_correct_at_a_tiny_size(vggt_bench):
    bench, folder = vggt_bench
    cell, run, numbers = run_tiny(bench, folder, "tiny-vggt-offline", seconds=6.0)
    correct, checks = check.verdict(numbers, cell.settings["limits"])
    assert correct, checks
    assert run.frames > 0 and numbers["compared_chunks"] >= 2
    built = build(cell.config, 3, torch.device("cpu"), folder)
    sd = built.state_dicts["vggt"]
    # the assumed trained values, by VGGT's names
    assert float(sd["aggregator.frame_blocks.1.ls2.gamma"][0]) == pytest.approx(0.1)
    assert sd["camera_head.pose_branch.fc2.bias"].tolist() == pytest.approx(
        [0.0] * 6 + [0.25] * 3)
    assert sd["depth_head.scratch.output_conv2.2.bias"].tolist() == pytest.approx([0.5, 0.0])
    assert "depth_head.scratch.layer1_rn.bias" not in sd


def _rope_from_zero(grid, head_dim, n_special, freq, device="cpu"):
    """The fault: patch rows and columns counted from 0, not 1."""
    hp, wp = grid
    quarter = head_dim // 4
    inv = freq ** (-torch.arange(quarter, dtype=torch.float64) / quarter)
    ys = torch.arange(hp, dtype=torch.float64).repeat_interleave(wp)
    xs = torch.arange(wp, dtype=torch.float64).repeat(hp)
    pos = torch.cat([torch.zeros(n_special, 2, dtype=torch.float64), torch.stack([ys, xs], -1)])
    ang = pos[:, :, None] * inv
    return torch.cos(ang).float().to(device), torch.sin(ang).float().to(device)


def _no_qk_norm(ln, t, cos, sin):
    """The fault: RoPE without QK-norm."""
    from da3slam_tpu_torch.models import vggt

    return vggt.apply_rope(t.float(), cos, sin).to(t.dtype)


@pytest.mark.parametrize("fault", ["rope_from_zero", "no_qk_norm"])
def test_a_fault_in_the_port_comes_out_not_correct(vggt_bench, monkeypatch, fault):
    from da3slam_tpu_torch.models import vggt

    if fault == "rope_from_zero":
        monkeypatch.setattr(vggt, "rope_tables", _rope_from_zero)
    else:
        monkeypatch.setattr(vggt, "qk_norm_rope", _no_qk_norm)
    bench, folder = vggt_bench
    cell, _, numbers = run_tiny(bench, folder, "tiny-vggt-offline", seconds=6.0)
    correct, checks = check.verdict(numbers, cell.settings["limits"])
    # a sound tiny run reads at most 8e-7 of the 1e-5 limits (rounding); the
    # shifted positions move only the special tokens' scores (RoPE is
    # relative among the patches): pose_gap 8e-5, depth_rel 1.2e-5
    assert not correct, checks
    assert max(c["value"] / c["limit"] for c in checks.values()) > 5, checks


def test_chunk_flops_at_the_published_sizes_match_a_hand_count():
    """15 views at process_res 504: 36×36 patches, 1301 tokens a view."""
    N, g, D, P = 15, 36 * 36, 1024, 14
    S = 1 + 4 + g
    lin = 24 * D * D * N * S * (24 + 48)  # qkv, proj, fc1, fc2 of 72 blocks
    attn = 4 * D * (N * S * S * 48 + (N * S) ** 2 * 24)  # 48 within a view, 24 global
    embed = 2 * N * g * D * 3 * P * P

    def conv(pixels, cin, cout, k):
        return 2 * pixels * cin * cout * k * k

    f, F_ = (256, 512, 1024, 1024), 256
    res = (16 * g, 4 * g, g, g // 4)  # the four stages' pixels
    head = conv(g, 2 * D, sum(f), 1) + conv(g, f[0], f[0], 4) + conv(g, f[1], f[1], 2) \
        + conv(res[3], f[3], f[3], 3) + sum(conv(r, fk, F_, 3) for r, fk in zip(res, f)) \
        + 2 * conv(res[3], F_, F_, 3) + sum(4 * conv(r, F_, F_, 3) for r in res[:3]) \
        + sum(conv(r, F_, F_, 1) for r in (res[2], res[1], res[0], 4 * res[0])) \
        + conv(4 * res[0], F_, F_ // 2, 3) + conv(504 * 504, F_ // 2, 32, 3) \
        + conv(504 * 504, 32, 2, 1)
    camera = 4 * (4 * 24 * (2 * D) ** 2 + 2 * 2 * D * 6 * D + 2 * (2 * D * D + 9 * 2 * D))
    hand = lin + attn + embed + N * (head + camera)
    assert 80e12 < hand < 84e12
    assert chunk_flops(CONFIG, 15, (518, 518), 504) == pytest.approx(hand, rel=0.03)


# -- the three metrics, on a synthetic record -------------------------------------

HOST0 = 500.0  # perf_counter seconds at the slice's start
TRACE0 = 1_000_000  # the same moment on the trace's clock, in µs


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": TRACE0 + ts, "dur": dur, "args": args}


def _rec(i, name, a_us, b_us, **attrs):
    return SpanRecord(i, name, HOST0 + a_us * 1e-6, HOST0 + b_us * 1e-6, None, ("s", 0), 1,
                      attrs)


QK = {"B": 15, "S": 1301, "H": 16, "D": 64}


@pytest.fixture
def synthetic(monkeypatch):
    """A 100 µs slice: two model.qk spans [5, 15] (frame) and [20, 30]
    (global) with kernels of 4 and 6 µs launched inside them, a
    model.camera span [40, 60] with kernels of 3 and 5 µs, a qk span
    starting before the slice (not counted by the roofline), and a kernel
    launched outside every span."""
    events = [
        _x("user_annotation", "slambench.slice", 0, 100),
        *[_x("cuda_runtime", "cudaLaunchKernel", t, 1, correlation=c)
          for c, t in ((1, 6), (2, 21), (3, 41), (4, 45), (5, 70))],
        _x("kernel", "qk_frame", 8, 4, correlation=1),
        _x("kernel", "qk_global", 22, 6, correlation=2),
        _x("kernel", "trunk1", 42, 3, correlation=3),
        _x("kernel", "trunk2", 46, 5, correlation=4),
        _x("kernel", "other", 72, 10, correlation=5),
    ]
    recs = [
        _rec(1, "model.qk", -20, -10, **QK, kind="frame"),
        _rec(2, "model.qk", 5, 15, **QK, kind="frame"),
        _rec(3, "model.qk", 20, 30, B=1, S=15 * 1301, H=16, D=64, kind="global"),
        _rec(4, "model.camera", 40, 60),
    ]
    fake = SimpleNamespace(records=lambda since=-math.inf: [r for r in recs if r.start > since],
                           snapshot=lambda: {"dropped": 0, "dropped_through": -math.inf})
    monkeypatch.setattr(ps, "_recorder", lambda: fake)
    run = Run(None, 0, 1.0, True, "offline", dtype="bfloat16")
    run.slice_trace = TraceSlice(events)
    run.slice_span = (HOST0, HOST0 + 150e-6)
    run.slice_chunks = 2
    return run


def test_the_three_metrics_read_a_synthetic_record(synthetic):
    run = synthetic
    assert metric_reader("model.qk_device_ms_per_chunk")(run) == pytest.approx(10e-3 / 2)
    assert metric_reader("model.camera_device_ms_per_chunk")(run) == pytest.approx(8e-3 / 2)
    # q and k read and written once, bf16, in the two spans that start in the slice
    nbytes = 2 * 4 * 15 * 1301 * 16 * 64 * 2
    assert metric_reader("model.qk_roofline")(run) == pytest.approx(
        100 * nbytes / 3.35e12 / 10e-6)


def test_the_three_metrics_read_none_where_there_is_nothing(synthetic, monkeypatch):
    run = synthetic
    names = ("model.qk_device_ms_per_chunk", "model.qk_roofline",
             "model.camera_device_ms_per_chunk")
    # a program without the spans (the DA3 networks, or one older than them)
    monkeypatch.setattr(ps, "_recorder", lambda: SimpleNamespace(
        records=lambda since=-math.inf: [], snapshot=lambda: {"dropped": 0,
                                                              "dropped_through": -math.inf}))
    assert metric_reader(names[0])(run) == 0.0 and metric_reader(names[2])(run) == 0.0
    assert metric_reader(names[1])(run) is None
    monkeypatch.setattr(ps, "_recorder", lambda: None)  # no recorder at all
    for name in names:
        assert metric_reader(name)(run) is None
    run.slice_trace = None  # an untraced run
    for name in names:
        assert metric_reader(name)(run) is None
