"""``align.icp_graph_share`` and its ``.live`` twin: the share of the
program's ``align.icp`` spans after the slice that replayed a captured graph,
read from synthetic records, from a program whose spans lack the attribute
(None), and from a traced tiny run on the CPU, where ICP runs eagerly (0)."""

from __future__ import annotations

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from slambench.lib import program_spans as ps
from slambench.lib.drive import Run, run_cell
from slambench.lib.spec import load_cell, metric_reader
from da3slam_tpu_torch.utils.profiling import SpanRecord

NAMES = ("align.icp_graph_share", "align.icp_graph_share.live")
HOST0 = 500.0  # perf_counter seconds at the window's steady part


def _rec(i, name, at_s, **attrs):
    return SpanRecord(i, name, HOST0 + at_s, HOST0 + at_s + 0.01, None, ("s", i), 1, attrs)


def _run(monkeypatch, recs, dropped=0):
    fake = SimpleNamespace(records=lambda since=-math.inf: [r for r in recs if r.start > since],
                           snapshot=lambda: {"dropped": dropped, "dropped_through": HOST0 + 1.0})
    monkeypatch.setattr(ps, "_recorder", lambda: fake)
    run = Run(None, 0, 1.0, True, "offline")
    run.steady, run.t_close = (HOST0, 0.0), HOST0 + 10.0
    return run


@pytest.mark.parametrize("name", NAMES)
def test_the_share_of_spans_that_replayed(monkeypatch, name):
    recs = [_rec(1, "align.icp", -1.0, iterations=12, graph="capture"),  # before: not counted
            _rec(2, "align.icp", 1.0, iterations=12, graph="replay"),
            _rec(3, "align.icp", 2.0, iterations=12, graph="replay"),
            _rec(4, "align.icp", 3.0, iterations=12, graph="replay"),
            _rec(5, "align.icp", 4.0, iterations=12, graph="eager"),
            _rec(6, "align.fetch", 4.5, bytes=10),
            _rec(7, "align.icp", 11.0, iterations=12, graph="eager")]  # after the close
    assert metric_reader(name)(_run(monkeypatch, recs)) == pytest.approx(75.0)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_is_none(monkeypatch, name):
    # a program whose align.icp spans carry no graph attribute (older than the graph)
    older = [_rec(i, "align.icp", float(i), iterations=12) for i in (1, 2)]
    assert metric_reader(name)(_run(monkeypatch, older)) is None
    assert metric_reader(name)(_run(monkeypatch, [_rec(1, "align.fetch", 1.0)])) is None
    # the ring dropped records of the steady part
    tagged = [_rec(1, "align.icp", 1.0, graph="replay")]
    assert metric_reader(name)(_run(monkeypatch, tagged, dropped=3)) is None
    run = _run(monkeypatch, tagged)
    monkeypatch.setattr(ps, "_recorder", lambda: None)  # no recorder at all
    assert metric_reader(name)(run) is None
    run.trace = False  # an untraced run
    monkeypatch.setattr(ps, "_recorder", lambda: SimpleNamespace(records=None, snapshot=None))
    assert metric_reader(name)(run) is None


def test_a_traced_tiny_run_on_the_cpu_reads_zero(tiny_bench, monkeypatch):
    """On the CPU every ICP call runs the eager body: a share of 0, not None."""
    bench, folder = tiny_bench
    for m in bench["per_layer"]:
        if m["name"] in NAMES:
            assert ("tiny-live" if m["name"].endswith(".live") else "tiny-offline") \
                in m["workloads"]
    path = folder / "traffic" / "tiny-offline.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), hw=[70, 70], process_res=70,
                                    frames=11, order=[[0, 10]])))
    path = folder / "workloads" / "tiny-offline.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), trace_slice_chunks=1)))
    cell = load_cell("tiny-offline", bench, folder)
    assert NAMES[0] in {m["name"] for m in cell.per_layer}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run, _ = run_cell(cell, 2**31 + 29, 8.0, True, time.perf_counter(), torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    assert metric_reader(NAMES[0])(run) == 0.0
