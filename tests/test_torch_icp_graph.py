"""ICP as a captured CUDA graph (``da3slam_tpu_torch/ops/icp.py``): CPU inputs
run the eager body, bit-equal to the benchmark's frozen copy of it; the graph
cache's key, replay, output clones and bound, driven on the CPU through a
stand-in graph that replays the eager body; and on the card (marker ``cuda``,
skipped without one) the captured graph against the eager body, bit for bit,
at the benchmark cells' shapes.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_icp_graph.py
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from da3slam_tpu_torch.core.geometry import backproject_depth
from da3slam_tpu_torch.core.transforms import Sim3, highest_precision
from da3slam_tpu_torch.ops import icp
from slambench.reference import align as ref_align

KW = dict(threshold=0.1, max_iterations=12)


def overlap_pair(hw: int, stride: int, seed: int, device="cpu"):
    """The alignment's ICP inputs for two views of one bumpy surface: the
    target's full point map and the source's strided cloud, moved by a small
    seeded rigid motion, with both validity masks."""
    g = torch.Generator().manual_seed(seed)
    v, u = torch.meshgrid(torch.arange(hw, dtype=torch.float32),
                          torch.arange(hw, dtype=torch.float32), indexing="ij")
    phase = float(torch.rand((), generator=g)) * 6.0
    depth = 2.5 + 0.4 * torch.sin(u / 5.0 + phase) * torch.cos(v / 4.0) \
        + 0.2 * torch.sin((u + v) / 9.0)
    depth[: hw // 8, : hw // 8] = 0.0  # a hole: invalid target pixels
    K = torch.tensor([[0.9 * hw, 0.0, hw / 2], [0.0, 0.9 * hw, hw / 2], [0.0, 0.0, 1.0]])
    tgt = backproject_depth(depth, K)
    ang = 0.01 + 0.02 * float(torch.rand((), generator=g))
    c, s = torch.cos(torch.tensor(ang)), torch.sin(torch.tensor(ang))
    R = torch.stack([torch.stack([c, torch.tensor(0.0), s]), torch.tensor([0.0, 1.0, 0.0]),
                     torch.stack([-s, torch.tensor(0.0), c])])
    src = tgt[::stride, ::stride].reshape(-1, 3) @ R.T + torch.tensor([0.01, -0.02, 0.015])
    src_valid = depth[::stride, ::stride].reshape(-1) > 1e-6
    tgt_valid = depth > 1e-6
    return tuple(x.to(device) for x in (src, tgt, K, src_valid, tgt_valid))


def flat(res: icp.ICPResult) -> list[torch.Tensor]:
    return [*res.transform, res.fitness, res.inlier_rmse]


def assert_bit_equal(a: icp.ICPResult, b: icp.ICPResult) -> None:
    for x, y in zip(flat(a), flat(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), (x, y)


def eager(args, with_scale: bool) -> icp.ICPResult:
    with highest_precision():
        return icp._icp(*args, KW["threshold"], KW["max_iterations"], with_scale)


# -- CPU: the eager body ---------------------------------------------------------


@pytest.mark.parametrize("with_scale", [False, True])
def test_cpu_inputs_run_the_eager_body(with_scale, monkeypatch):
    graphs = icp.ICPGraphs()
    monkeypatch.setattr(icp, "GRAPHS", graphs)
    args = overlap_pair(48, 2, seed=0)
    res, mode = icp.run_icp(*args, with_scale=with_scale, **KW)
    assert mode == "eager"
    assert_bit_equal(res, eager(args, with_scale))
    assert_bit_equal(icp.icp_point_to_point(*args, with_scale=with_scale, **KW), res)
    assert not graphs.graphs and graphs.captures == 0  # CPU calls never enter the cache
    if not with_scale:
        # the benchmark's frozen copy of the body as it stood before graphs
        s, R, t = ref_align.icp(*args, **KW)
        for x, y in zip(res.transform, (s, R, t)):
            assert torch.equal(x, y)


def test_the_graph_key_separates_every_field():
    def t(shape, dtype=torch.float32, index=0):
        return SimpleNamespace(shape=torch.Size(shape), dtype=dtype,
                               device=torch.device("cuda", index))

    base = dict(src_points=t((100, 3)), tgt_point_map=t((20, 30, 3)), tgt_K=t((3, 3)),
                src_valid=None, tgt_valid=None, threshold=0.1, max_iterations=12,
                with_scale=False)
    changes = [
        dict(src_points=t((100, 3), index=1)),  # device
        dict(src_points=t((101, 3))),
        dict(tgt_point_map=t((21, 30, 3))),
        dict(tgt_point_map=t((20, 31, 3))),
        dict(src_points=t((100, 3), torch.float64)),
        dict(tgt_point_map=t((20, 30, 3), torch.float64)),
        dict(tgt_K=t((3, 3), torch.float64)),
        dict(threshold=0.2),
        dict(max_iterations=13),
        dict(with_scale=True),
        dict(src_valid=t((100,), torch.bool)),
        dict(tgt_valid=t((20, 30), torch.bool)),
    ]
    keys = [icp.graph_key(**base)] + [icp.graph_key(**{**base, **c}) for c in changes]
    assert len(set(keys)) == len(keys)
    # other tensors of the same device, shapes and dtypes share the key
    again = dict(base, src_points=t((100, 3)), tgt_point_map=t((20, 30, 3)), tgt_K=t((3, 3)))
    assert icp.graph_key(**again) == icp.graph_key(**base)


# -- CPU: the cache, through a stand-in graph that replays the eager body --------


class _EagerGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: ``replay`` runs the eager body
    on the static inputs and writes the static outputs in place, as a
    replay does."""

    def __init__(self, inputs, with_scale):
        self.inputs, self.with_scale = inputs, with_scale
        self.result = eager(inputs, with_scale)

    def replay(self):
        for static, new in zip(flat(self.result), flat(eager(self.inputs, self.with_scale))):
            static.copy_(new)


@pytest.fixture
def stand_in(monkeypatch):
    """An ``ICPGraphs`` of 2 entries whose captures make ``_EagerGraph``s, put in
    place of the process's cache; CPU inputs are sent to it as CUDA ones are."""
    graphs = icp.ICPGraphs(entries=2)

    def capture(tensors, statics):
        graphs.captures += 1
        inputs = tuple(None if x is None else x.clone() for x in tensors)
        g = _EagerGraph(inputs, with_scale=statics[2])
        return icp._Graph(g, inputs, g.result)

    monkeypatch.setattr(graphs, "_capture", capture)

    def call(args, with_scale=False, **kw):
        kw = {**KW, **kw}
        return graphs(*args, kw["threshold"], kw["max_iterations"], with_scale)

    return graphs, call


def test_a_second_call_at_a_key_replays_and_captures_nothing(stand_in):
    graphs, call = stand_in
    args = overlap_pair(48, 2, seed=1)
    first, mode = call(args)
    assert mode == "capture" and graphs.captures == 1
    second, mode = call(args)
    assert mode == "replay" and graphs.captures == 1 and len(graphs.graphs) == 1
    assert_bit_equal(first, second)
    assert_bit_equal(second, eager(args, False))


def test_results_are_cloned_out_of_the_graph(stand_in):
    """Two calls at one key, read after both: each returns its own inputs'
    result, though the second replay overwrote the graph's outputs."""
    graphs, call = stand_in
    a, b = overlap_pair(48, 2, seed=2), overlap_pair(48, 2, seed=3)
    ra, _ = call(a)
    rb, mode = call(b)
    assert mode == "replay"
    assert_bit_equal(ra, eager(a, False))
    assert_bit_equal(rb, eager(b, False))
    assert not torch.equal(ra.transform.R, rb.transform.R)
    static = flat(next(iter(graphs.graphs.values())).result)
    for x, y in zip(flat(ra) + flat(rb), static * 2):
        assert x.data_ptr() != y.data_ptr()


def test_the_cache_keeps_the_most_recently_used_entries(stand_in):
    graphs, call = stand_in
    a, b, c = (overlap_pair(hw, 2, seed=4) for hw in (40, 44, 48))
    call(a)
    call(b)
    assert call(a)[1] == "replay"  # a is now the most recent
    assert call(c)[1] == "capture"  # b, the least recent, goes
    assert len(graphs.graphs) == 2
    assert call(a)[1] == "replay" and call(b)[1] == "capture"
    assert graphs.captures == 4
    # another static argument at the same shapes is another graph
    assert call(b, threshold=0.2)[1] == "capture"


# -- the card --------------------------------------------------------------------


@pytest.fixture
def cuda_graphs(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    graphs = icp.ICPGraphs()
    monkeypatch.setattr(icp, "GRAPHS", graphs)
    return graphs


@pytest.mark.cuda
@pytest.mark.parametrize("with_scale", [False, True])
def test_the_graph_equals_the_eager_body_at_504(cuda_graphs, with_scale):
    """The cells' shapes: a 504² target map, the source strided by 4."""
    args = overlap_pair(504, 4, seed=5, device="cuda")
    ref = eager(args, with_scale)
    got, mode = icp.run_icp(*args, with_scale=with_scale, **KW)
    assert mode == "capture"
    assert_bit_equal(got, ref)
    again, mode = icp.run_icp(*args, with_scale=with_scale, **KW)
    assert mode == "replay" and cuda_graphs.captures == 1
    assert_bit_equal(again, ref)
    assert float(got.fitness) > 0.5


@pytest.mark.cuda
def test_two_replays_read_after_both_keep_their_own_results(cuda_graphs):
    a, b, c = (overlap_pair(504, 4, seed=s, device="cuda") for s in (6, 7, 8))
    icp.run_icp(*a, **KW)  # the capture
    rb, mode_b = icp.run_icp(*b, **KW)
    rc, mode_c = icp.run_icp(*c, **KW)
    assert (mode_b, mode_c) == ("replay", "replay") and cuda_graphs.captures == 1
    assert_bit_equal(rb, eager(b, False))
    assert_bit_equal(rc, eager(c, False))
    assert not torch.equal(rb.transform.t, rc.transform.t)


@pytest.mark.cuda
def test_a_replay_waits_for_no_host_sync(cuda_graphs):
    args = overlap_pair(504, 4, seed=9, device="cuda")
    icp.run_icp(*args, **KW)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res, mode = icp.run_icp(*args, **KW)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert mode == "replay"
    assert isinstance(res.transform, Sim3)
