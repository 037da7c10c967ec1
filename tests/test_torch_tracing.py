"""The span recorder of ``da3slam_tpu_torch/utils/profiling.py`` and the spans
the port opens: parents and chunk ids over a two-chunk ``SLAMSolver.run()``
of the tiny model, the decode workers' spans, the ring's bound and dropped
count, the bytes of the transfer spans, ``record_function`` only under a
profiler, and ``StageTimer``'s report as the JAX package prints it."""

from __future__ import annotations

import functools
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from da3slam_tpu.utils import profiling as jprof
from da3slam_tpu_torch.models.da3 import DepthAnything3
from da3slam_tpu_torch.slam.solver import SLAMSolver
from da3slam_tpu_torch.utils import profiling as prof

# the parent every span of a chunk has, by name
TREE = {
    "inference": "chunk", "align": "chunk", "viewer": "chunk",
    "ingest.get_batch": "inference", "model.inference": "inference",
    "model.dpt": "model.inference", "model.attention": "model.inference",
    "model.fetch": "model.inference",
    "align.upload": "align", "align.icp": "align", "align.fetch": "align",
    "ingest.decode": "ingest.get_batch",  # an inline decode; a worker's has no parent
}


def _frames_dir(tmp_path, n=7, h=56, w=70):
    from PIL import Image

    rng = np.random.default_rng(0)
    base = rng.integers(40, 200, size=(h, w, 3))
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(n):
        f = np.roll(base, shift=2 * i, axis=1) + rng.integers(0, 20, size=(h, w, 3))
        Image.fromarray(np.clip(f, 0, 255).astype(np.uint8)).save(d / f"{i:06d}.png")
    return str(d)


@pytest.fixture(scope="module")
def tiny_model():
    return DepthAnything3.from_pretrained("tiny", device="cpu")


@pytest.fixture
def two_chunk_run(tmp_path, tiny_model, monkeypatch):
    """7 frames in chunks of 4 with overlap 1 (two chunks, no tail), ICP,
    decoded by the prefetcher, at process_res 70.  Returns (solver, records)."""
    monkeypatch.setattr(DepthAnything3, "inference",
                        functools.partialmethod(DepthAnything3.inference, process_res=70))
    cfg = {"Model": {"chunk_size": 4, "overlap_size": 1}, "Align": {"method": "icp"}}
    solver = SLAMSolver(_frames_dir(tmp_path), cfg, model=tiny_model, viewer=None, device="cpu")
    t0 = time.perf_counter()
    solver.run()
    return solver, prof.records(since=t0)


def test_a_two_chunk_run_is_one_tree_a_chunk(two_chunk_run):
    solver, recs = two_chunk_run
    by_id = {r.id: r for r in recs}
    main = threading.get_ident()
    roots = [r for r in recs if r.name == "chunk"]
    assert [r.chunk for r in roots] == [(solver.serial, 0), (solver.serial, 1)]
    assert all(r.parent is None and r.thread == main for r in roots)
    for r in recs:
        if r.thread != main:
            continue
        if r.name == "chunk":
            continue
        parent = by_id[r.parent]
        assert parent.name == TREE[r.name], (r.name, parent.name)
        assert parent.start <= r.start <= r.end <= parent.end
        assert r.chunk == parent.chunk
        top = r
        while top.parent is not None:
            top = by_id[top.parent]
        assert top.name == "chunk" and top.chunk == r.chunk
    names = {(r.chunk, r.name) for r in recs}
    for idx in (0, 1):
        c = (solver.serial, idx)
        for name in ("inference", "ingest.get_batch", "model.inference", "model.dpt",
                     "model.attention", "model.fetch", "viewer"):
            assert (c, name) in names, (c, name)
    # the first chunk defines the global frame: only the second is aligned
    for name in ("align", "align.upload", "align.icp", "align.fetch"):
        assert ((solver.serial, 0), name) not in names
        assert ((solver.serial, 1), name) in names
    icp = [r for r in recs if r.name == "align.icp"]
    assert icp[0].attrs == {"iterations": 12, "graph": "eager"}
    # tiny: 4 blocks, one attention call each
    assert sum(r.name == "model.attention" and r.chunk == (solver.serial, 0) for r in recs) == 4
    att = next(r for r in recs if r.name == "model.attention")
    assert set(att.attrs) == {"B", "S", "H", "D"}


def test_the_stage_timer_stages_are_the_stage_spans(two_chunk_run):
    solver, recs = two_chunk_run
    for stage in ("inference", "align", "viewer"):
        spans = [r for r in recs if r.name == stage]
        assert len(spans) == solver.timer.counts[stage]
        assert sum(r.end - r.start for r in spans) == pytest.approx(
            solver.timer.totals[stage], rel=0.05, abs=1e-3)


def test_decode_workers_record_into_the_same_recorder(tmp_path):
    from da3slam_tpu_torch.inout.prefetch import ImagePrefetcher

    paths = sorted(str(p) for p in Path(_frames_dir(tmp_path, n=6)).glob("*.png"))
    t0 = time.perf_counter()
    pf = ImagePrefetcher(paths, lookahead=6, workers=3)
    try:
        with prof.span("chunk", chunk="c"):
            pf.get_batch(paths[:3])
            pf.get_batch(paths[2:6])
    finally:
        pf.close()
    recs = prof.records(since=t0)
    decodes = [r for r in recs if r.name == "ingest.decode"]
    workers = {r.thread for r in decodes} - {threading.get_ident()}
    assert workers and len(decodes) >= 6
    for r in decodes:
        if r.thread != threading.get_ident():  # a worker: no span of the consumer around it
            assert r.parent is None and r.chunk is None
    batches = [r for r in recs if r.name == "ingest.get_batch"]
    assert [r.attrs["frames"] for r in batches] == [3, 4] and {r.chunk for r in batches} == {"c"}


def test_spans_on_threads_keep_their_own_parents(monkeypatch):
    monkeypatch.setattr(prof, "_RING", prof._Ring(prof.RING_RECORDS))
    barrier = threading.Barrier(4)

    def work(k):
        with prof.span("outer", chunk=k):
            barrier.wait()
            for _ in range(50):
                with prof.span("inner"):
                    pass

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = prof.records()
    outer = {r.id: r for r in recs if r.name == "outer"}
    assert len(outer) == 4 and len(recs) == 204
    for r in recs:
        if r.name == "inner":
            assert outer[r.parent].thread == r.thread and outer[r.parent].chunk == r.chunk
    assert prof.snapshot()["by_name"]["inner"]["count"] == 200


def test_the_ring_is_bounded_and_counts_what_it_dropped(monkeypatch):
    assert prof.RING_RECORDS == 1 << 16 and prof._RING.capacity == 1 << 16
    monkeypatch.setattr(prof, "_RING", prof._Ring(8))
    starts = []
    for i in range(20):
        with prof.span("s", bytes=i):
            with prof.span("t"):
                pass
        starts.append(prof.records()[-1].start)
    snap = prof.snapshot()
    assert snap["kept"] == 8 and snap["dropped"] == 32 and snap["capacity"] == 8
    # the latest start among the dropped: the inner span of the 16th pair
    assert starts[15] < snap["dropped_through"] < starts[16]
    assert [r.start for r in prof.records() if r.name == "s"] == starts[16:]
    # after the 18th pair's outer start: its inner span, then the last two pairs
    assert [r.name for r in prof.records(since=starts[17])] == ["t", "t", "s", "t", "s"]
    # the totals keep every span closed, dropped or not
    assert snap["by_name"]["s"] == {"count": 20, "seconds": pytest.approx(
        sum(r.end - r.start for r in prof.records() if r.name == "s"), abs=1.0),
        "bytes": sum(range(20))}
    assert snap["by_name"]["t"]["count"] == 20


def test_a_span_closes_on_an_exception():
    t0 = time.perf_counter()
    with pytest.raises(ZeroDivisionError):
        with prof.span("outer"):
            with prof.span("inner"):
                1 / 0
    with prof.span("after"):
        pass
    inner, outer, after = prof.records(since=t0)
    assert inner.parent == outer.id and after.parent is None


def test_transfer_spans_count_the_bytes_moved(tiny_model):
    """``model.fetch``: the prediction's fields; ``align.upload``: the eight
    inputs made float32; ``align.fetch``: the six results."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, size=(3, 56, 70, 3)).astype(np.uint8)
    pred = tiny_model.inference(frames, process_res=70)
    fetch = [r for r in prof.records(since=t0) if r.name == "model.fetch"]
    assert len(fetch) == 1
    assert fetch[0].attrs["bytes"] == sum(np.asarray(getattr(pred, k)).nbytes for k in (
        "processed_images", "depth", "conf", "extrinsics", "intrinsics", "frame_desc"))

    solver = SLAMSolver("", {"Model": {"chunk_size": 3}}, model=tiny_model, viewer=None,
                        device="cpu")
    prev = {"depth": pred.depth, "conf": pred.conf, "intrinsics": pred.intrinsics}
    cur = {"depth": pred.depth.astype(np.float64), "conf": pred.conf,
           "intrinsics": pred.intrinsics, "extrinsics": pred.extrinsics}
    solver.prev_overlap_aligned_3x4 = pred.extrinsics[-1]
    t1 = time.perf_counter()
    solver.process_chunk_alignment(prev, cur)
    recs = {r.name: r for r in prof.records(since=t1)}
    f32 = 4
    upload = (2 * pred.depth[-1].size + 9 + pred.depth.size + pred.conf.size
              + pred.intrinsics.size + pred.extrinsics.size + 12) * f32
    assert recs["align.upload"].attrs == {"bytes": upload}
    # depth_scaled, extrinsics_global, the next overlap pose, the scale, fitness, rmse
    results = (pred.depth.size + pred.extrinsics.size + 12 + 1 + 1 + 1) * f32
    assert recs["align.fetch"].attrs == {"bytes": results}
    assert recs["align.upload"].parent is None  # called outside a chunk here


def test_no_record_function_without_a_profiler(monkeypatch, tmp_path):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for _ in range(5):
        with prof.span("quiet"):
            pass
    assert calls == []
    with prof.profile_trace(tmp_path / "t", device="cpu"):
        with prof.span("traced.outer"):
            with prof.span("traced.inner"):
                torch.ones(4).sum()
    assert calls == ["traced.outer", "traced.inner"]
    events = json.loads((tmp_path / "t" / prof.TRACE_FILE).read_text())["traceEvents"]
    annotated = {e["name"]: e for e in events
                 if e.get("cat") == "user_annotation" and e.get("name", "").startswith("traced.")}
    assert set(annotated) == {"traced.outer", "traced.inner"}
    outer, inner = annotated["traced.outer"], annotated["traced.inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    calls.clear()
    with prof.span("quiet"):
        pass
    assert calls == []


def test_the_model_spans_sit_in_profile_trace(tiny_model, tmp_path):
    frames = np.random.default_rng(2).integers(0, 256, size=(2, 56, 70, 3)).astype(np.uint8)
    with prof.profile_trace(tmp_path / "t", device="cpu"):
        tiny_model.inference(frames, process_res=70)
    events = json.loads((tmp_path / "t" / prof.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"model.inference", "model.dpt", "model.attention", "model.fetch"} <= names


def test_nested_inference_spans_both_submodels():
    nested = DepthAnything3.from_pretrained("nested-tiny", device="cpu")
    t0 = time.perf_counter()
    frames = np.random.default_rng(3).integers(0, 256, size=(2, 56, 70, 3)).astype(np.uint8)
    nested.inference(frames, process_res=70)
    recs = prof.records(since=t0)
    by_id = {r.id: r for r in recs}
    top = [r for r in recs if r.name == "model.nested"]
    subs = [r for r in recs if r.name == "model.inference"]
    assert len(top) == 1 and len(subs) == 2
    assert all(by_id[r.parent].name == "model.nested" for r in subs)
    assert [r.attrs["views"] for r in subs] == [2, 1]


def test_stage_timer_report_is_the_jax_packages():
    """The same totals print the same report in both packages (the solver
    labels it host time in its own header)."""
    reports = []
    for mod in (jprof, prof):
        t = mod.StageTimer(sync=False)
        for stage, total, n, first in (("align", 1.25, 4, 0.5), ("inference", 2.0, 4, 0.8)):
            t.totals[stage], t.counts[stage], t.firsts[stage] = total, n, first
        reports.append(t.report())
    assert reports[0] == reports[1]


def test_stage_timer_records_a_span_per_stage():
    t0 = time.perf_counter()
    timer = prof.StageTimer(sync=False)
    with prof.span("chunk", chunk=("s", 3)):
        with timer("align"):
            with prof.span("align.icp"):
                pass
    recs = {r.name: r for r in prof.records(since=t0)}
    assert recs["align"].parent == recs["chunk"].id and recs["align.icp"].chunk == ("s", 3)
    assert timer.counts == {"align": 1}
