"""The readers of the program's own spans (``lib/program_spans.py``): on a
synthetic trace, device time and launches under a span, the clock offset and
``idle_by_span``; on traced tiny runs on the CPU, every new host metric reads
a finite number and the recorder's spans agree with their events in the
profiler's trace."""

from __future__ import annotations

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from slambench.lib import program_spans as ps
from slambench.lib import trace as trace_mod
from slambench.lib.drive import Chunk, Run, run_cell
from slambench.lib.spec import load_cell, metric_reader
from slambench.lib.trace import TraceSlice
from da3slam_tpu_torch.utils.profiling import SpanRecord

NEW_HOST = ("align.icp_ms_per_chunk", "solver.transfer_ms_per_chunk",
            "solver.transfer_mb_per_chunk", "ingest.decode_ms_per_frame")
NEW_HOST_LIVE = ("align.icp_ms_per_chunk.live", "solver.transfer_ms_per_chunk.live")
NEW_DEVICE = ("align.icp_launches_per_chunk", "model.dpt_device_ms_per_chunk")

HOST0 = 500.0  # perf_counter seconds at the slice's start
TRACE0 = 1_000_000  # the same moment on the trace's clock, in µs


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": TRACE0 + ts, "dur": dur, "args": args}


def _rec(i, name, a_us, b_us, parent=None, thread=1, **attrs):
    """A record at ``a_us``..``b_us`` µs after the slice's start, host clock."""
    return SpanRecord(i, name, HOST0 + a_us * 1e-6, HOST0 + b_us * 1e-6, parent, ("s", 0),
                      thread, attrs)


@pytest.fixture
def synthetic(monkeypatch):
    """A 100 µs slice: a chunk [-5, 95] holding model.dpt [5, 35] and align
    [50, 90] with align.icp [60, 80]; kernels launched at 6, 8 (dpt, [10, 30]
    and [20, 40]), 61, 62 (icp, [64, 66] and [70, 72]) and 91 (after align,
    [92, 100]); a decode span on another thread over the whole slice."""
    events = [
        _x("user_annotation", "slambench.slice", 0, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 8, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 62, 1, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 91, 1, correlation=5),
        _x("kernel", "dpt1", 10, 20, correlation=1),
        _x("kernel", "dpt2", 20, 20, correlation=2),
        _x("kernel", "icp1", 64, 2, correlation=3),
        _x("gpu_memcpy", "icp2", 70, 2, correlation=4),
        _x("kernel", "late", 92, 8, correlation=5),
    ]
    recs = [
        _rec(2, "model.dpt", 5, 35, parent=1),
        _rec(4, "align.icp", 60, 80, parent=3),
        _rec(3, "align", 50, 90, parent=1),
        _rec(1, "chunk", -5, 95),
        _rec(5, "ingest.decode", -10, 110, thread=2),
        _rec(6, "align.fetch", 200, 300, parent=None, bytes=4_000_000),  # after the slice
    ]
    fake = SimpleNamespace(records=lambda since=-math.inf: [r for r in recs if r.start > since],
                           snapshot=lambda: {"dropped": 0, "dropped_through": -math.inf})
    monkeypatch.setattr(ps, "_recorder", lambda: fake)
    run = Run(None, 0, 1.0, True, "offline")
    run.slice_trace = TraceSlice(events)
    run.slice_span = (HOST0, HOST0 + 150e-6)  # the host's end: after the profiler stopped
    run.slice_chunks = 2
    return run, recs, fake


def test_clock_offset_maps_the_slice_start_and_checks_its_end(synthetic):
    run, _, _ = synthetic
    assert ps.clock_offset(run) == pytest.approx(TRACE0 * 1e-6 - HOST0)
    run.slice_span = (HOST0, HOST0 + 100e-6 - 2 * ps.DRIFT_S)  # the host ends before the trace
    assert ps.clock_offset(run) is None


def test_device_time_and_launches_under_a_program_span(synthetic):
    run, _, _ = synthetic
    # dpt1 + dpt2, overlap counted apiece, over 2 chunks
    assert metric_reader("model.dpt_device_ms_per_chunk")(run) == pytest.approx(40e-3 / 2)
    assert metric_reader("align.icp_launches_per_chunk")(run) == pytest.approx(2 / 2)
    assert ps.device_ms_per_chunk("align")(run) == pytest.approx(4e-3 / 2)
    run.slice_trace = None
    assert metric_reader("model.dpt_device_ms_per_chunk")(run) is None


def test_idle_by_span_takes_the_innermost_span_of_the_solver_thread(synthetic):
    run, _, _ = synthetic
    got = dict(ps.idle_by_span(run))
    # busy: [10, 40], [64, 66], [70, 72], [92, 100]; each gap goes to the span open at its
    # start: [0, 10) and [40, 64) to chunk (dpt opens at 5, closes at 35; align opens at
    # 50), [66, 70) and [72, 92) to align.icp (open until 80)
    assert got["chunk"] == pytest.approx((10 + 24) * 1e-6)
    assert got["align.icp"] == pytest.approx((4 + 20) * 1e-6)
    assert "align" not in got and "model.dpt" not in got
    assert "ingest.decode" not in got  # another thread's
    assert sum(got.values()) == pytest.approx(run.slice_trace.window_s - run.slice_trace.busy_s())


def test_host_readers_take_the_part_after_the_slice(synthetic, monkeypatch):
    run, recs, fake = synthetic
    run.steady = (HOST0 + 150e-6, 0.0)
    run.t_close = HOST0 + 1.0
    run.chunks = [Chunk(0, i, HOST0 + 0.1 * (i + 1), 14) for i in range(2)]
    assert metric_reader("solver.transfer_mb_per_chunk")(run) == pytest.approx(2.0)
    assert metric_reader("solver.transfer_ms_per_chunk")(run) == pytest.approx(100e-3 / 2)
    assert metric_reader("align.icp_ms_per_chunk")(run) is None  # no icp span after the slice
    monkeypatch.setattr(fake, "snapshot", lambda: {"dropped": 3, "dropped_through": HOST0 + 0.5})
    assert metric_reader("solver.transfer_mb_per_chunk")(run) is None
    monkeypatch.setattr(fake, "snapshot", lambda: {"dropped": 3, "dropped_through": HOST0})
    assert metric_reader("solver.transfer_mb_per_chunk")(run) == pytest.approx(2.0)
    run.trace = False
    assert metric_reader("solver.transfer_mb_per_chunk")(run) is None


def test_a_program_without_the_recorder_reads_none(synthetic, monkeypatch):
    run, _, _ = synthetic
    monkeypatch.setattr(ps, "_recorder", lambda: None)
    run.steady, run.t_close = (HOST0 + 1e-3, 0.0), HOST0 + 1.0
    for name in NEW_HOST + NEW_HOST_LIVE + NEW_DEVICE:
        assert metric_reader(name)(run) is None
    assert ps.idle_by_span(run) is None


@pytest.mark.parametrize("name", ["tiny-offline", "tiny-live"])
def test_traced_tiny_runs_read_the_program_spans(tiny_bench, monkeypatch, name):
    bench, folder = tiny_bench
    for m in bench["per_layer"]:
        if "workloads" in m and m["name"] in NEW_HOST + NEW_HOST_LIVE + NEW_DEVICE:
            assert ("tiny-live" if "small-live" in m["workloads"] else "tiny-offline") \
                in m["workloads"]
    # frames of 70x70 at process_res 70 (chunks of tenths of a second on a quiet CPU), 11-frame
    # sequences offline (four chunks: the one after the slice is aligned) and a one-chunk
    # slice: chunks after the slice within the window on a loaded CPU too
    path = folder / "traffic" / f"{name}.json"
    traffic = dict(json.loads(path.read_text()), hw=[70, 70], process_res=70)
    if name == "tiny-offline":
        traffic.update(frames=11, order=[[0, 10]])
    path.write_text(json.dumps(traffic))
    path = folder / "workloads" / f"{name}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), trace_slice_chunks=1)))
    raw = []
    load = trace_mod.load_trace
    monkeypatch.setattr(trace_mod, "load_trace", lambda p: raw.extend(load(p)) or raw)
    cell = load_cell(name, bench, folder)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a tiny model: spared the spin of oversubscribed OpenMP threads
    try:
        run, _ = run_cell(cell, 2**31 + 23, 8.0, True, time.perf_counter(), torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    assert run.slice_trace is not None and run.steady[0] > 0
    names = NEW_HOST_LIVE if name == "tiny-live" else NEW_HOST
    reported = {m["name"] for m in cell.per_layer}
    for metric in names:
        assert metric in reported
        value = metric_reader(metric)(run)
        assert value is not None and math.isfinite(value) and value > 0, (metric, value)
    if name == "tiny-offline":
        for metric in NEW_DEVICE:  # no device operations on the CPU
            assert metric_reader(metric)(run) == 0.0
    # the recorder's spans against their record_function events, through the anchor
    off, recs = ps.slice_records(run)
    events = {}
    for e in raw:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            events.setdefault(e["name"], []).append((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6))
    a, b = run.slice_span
    inside = [r for r in recs if a <= r.start and r.end <= b - 1e-3 and r.name in events]
    assert {r.name for r in inside} >= {"chunk", "model.inference", "model.dpt", "align.icp"}
    gaps = []
    for r in inside:
        s, e = min(events[r.name], key=lambda iv: abs(iv[0] - (r.start + off)))
        gaps += [abs(s - (r.start + off)), abs(e - (r.end + off))]
    # record_function stamps inside its enter and exit, and a thread that loses
    # the GIL in between (the decode workers hold it) puts a gap of up to a
    # switch interval between a stamp and the recorder's clock; a wrong clock or
    # anchor moves every span
    assert sum(g < 50e-6 for g in gaps) >= 0.9 * len(gaps), sorted(gaps)
    assert ps.idle_by_span(run) is not None
