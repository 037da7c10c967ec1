"""Runs a cell: its set-up, its measured window and what the window leaves
for the comparison and the metric readers.

The traffic file names its driver (``"driver"``), a module
``drivers/<driver>.py`` that the harness finds by name; it supplies the
frame source (``source``), the warm pass of the cell's shapes (``warm``),
which chunks are kept for the comparison (``capture_plan``), the loop that
feeds the solver in the window (``drive``) and, optionally, lines for
standard error (``report``).  This module holds what every driver shares:
the run's record, the instruments and the order of a run.

Spans are the benchmark's own: wrappers set on the solver and model
instances, on ``ImagePrefetcher.get_batch`` and, in a traced run, on
``models.vit.multi_head_attention`` (which ``vit._block`` looks up at each
call).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from slambench.lib.model import build


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class WindowClosed(Exception):
    """Raised from a chunk's completion once the window has closed."""


@dataclasses.dataclass
class Chunk:
    seq: int
    index: int  # within its sequence or session
    t_done: float
    n_new: int  # frames that got their global poses with this chunk
    due: float | None = None  # live: due time of the chunk's last frame


@dataclasses.dataclass
class Capture:
    """One chunk as the program produced it, kept for the comparison."""

    seq: int
    index: int
    frames: list  # JPEG paths (offline) or uint8 arrays (live)
    pred: dict  # depth, conf, extrinsics, intrinsics (+ metric_scale) as numpy
    align_in: dict | None = None  # the alignment's inputs, None for a first chunk
    extrinsics_global: np.ndarray | None = None


@dataclasses.dataclass
class Run:
    cell: object
    seed: int
    seconds: float
    trace: bool
    driver: str  # the traffic's driver
    setup_s: float = 0.0
    t0: float = 0.0
    t_close: float = 0.0
    chunks: list = dataclasses.field(default_factory=list)
    captures: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)  # name -> [(t0, t1)]
    attention_calls: list = dataclasses.field(default_factory=list)  # [(t, B, S, H, D)]
    lateness: list = dataclasses.field(default_factory=list)  # open loop: push - due, a frame
    sequences: list = dataclasses.field(default_factory=list)  # closed loop: (seq, t0, t1, whole)
    attempted: int = 0
    failed: int = 0
    # traced runs
    slice_trace: object = None  # lib.trace.TraceSlice
    slice_span: tuple = (0.0, 0.0)  # host perf_counter bounds of the profiled slice
    slice_chunks: int = 0
    host_waits: int = 0
    host_waits_at: dict = dataclasses.field(default_factory=dict)
    steady: tuple = (0.0, 0.0)  # host bounds of the traced run's part after the slice
    flops_per_chunk: float = 0.0
    memory_peak_bytes: int = 0
    dtype: str = "bfloat16"

    @property
    def window_s(self) -> float:
        return self.t_close - self.t0

    @property
    def frames(self) -> int:
        return sum(c.n_new for c in self.chunks)

    def chunks_between(self, a: float, b: float) -> list:
        return [c for c in self.chunks if a < c.t_done <= b]

    def span_total(self, name: str, a: float, b: float) -> tuple[float, int]:
        """Seconds and count of ``name`` spans that start in ``(a, b]``."""
        ivs = [(s, e) for s, e in self.spans.get(name, []) if a < s <= b]
        return sum(e - s for s, e in ivs), len(ivs)


class Instruments:
    """Spans, chunk completions and captures; the profiled slice of a traced run."""

    def __init__(self, run: Run, settings: dict, capture_plan):
        self.run = run
        self.settings = settings
        self.capture_plan = capture_plan  # (seq, index) -> bool
        self.seq = 0
        self._cur: Capture | None = None
        self._last_pred = None
        self._prof = None
        self._slice_rf = None
        self._waits = None
        self.closing = False  # the window's deadline has passed
        self.deadline: float | None = None  # close at the first chunk this long after t0
        self.live_due: float | None = None

    @contextlib.contextmanager
    def span(self, name: str):
        rf = torch.profiler.record_function("slambench." + name) if self.run.trace else None
        if rf is not None:
            rf.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.run.spans.setdefault(name, []).append((t, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)

    # -- the model and the solver ------------------------------------------
    def wrap_model(self, model) -> None:
        inner = model.inference

        def inference(*args, **kwargs):
            with self.span("model"):
                pred = inner(*args, **kwargs)
            self._last_pred = pred
            return pred

        model.inference = inference

    def wrap_solver(self, solver) -> None:
        run_chunk = solver.run_single_chunk_prediction
        align = solver.process_chunk_alignment
        process_frame = solver.process_frame
        flush_tail = solver._flush_tail

        def run_single_chunk_prediction(paths):
            out = run_chunk(paths)
            self._cur = None
            if self.capture_plan(self.seq, solver.chunk_count):
                p = self._last_pred
                pred = {k: np.asarray(getattr(p, k)) for k in
                        ("depth", "conf", "extrinsics", "intrinsics", "frame_desc")}
                if getattr(p, "metric_scale", None) is not None:
                    pred["metric_scale"] = float(p.metric_scale)
                self._cur = Capture(self.seq, solver.chunk_count, list(paths), pred)
            return out

        def process_chunk_alignment(prev, cur, anchor_idx=None):
            if self._cur is not None:
                self._cur.align_in = {
                    "prev_depth": prev["depth"][-1], "prev_conf": prev["conf"][-1],
                    "prev_K": prev["intrinsics"][-1],
                    "prev_overlap_global": np.asarray(solver.prev_overlap_aligned_3x4),
                    "anchor_idx": solver.overlap_size - 1 if anchor_idx is None else anchor_idx}
            with self.span("align"):
                return align(prev, cur, anchor_idx)

        def completed(before: int, call, *args):
            out = call(*args)
            if solver.chunk_count > before:
                self.chunk_done(solver)
            return out

        solver.run_single_chunk_prediction = run_single_chunk_prediction
        solver.process_chunk_alignment = process_chunk_alignment
        solver.process_frame = lambda p: completed(solver.chunk_count, process_frame, p)
        solver._flush_tail = lambda paths: completed(solver.chunk_count, flush_tail, paths)
        if solver.loop_closer is not None:
            loop = solver._loop_stage

            def loop_stage(*args):
                with self.span("loop"):
                    return loop(*args)

            solver._loop_stage = loop_stage

    @contextlib.contextmanager
    def wrap_program(self):
        """Spans on the prefetcher's ``get_batch`` and, traced, on the encoder's
        attention calls; undone on exit."""
        from da3slam_tpu_torch.inout.prefetch import ImagePrefetcher
        from da3slam_tpu_torch.models import vit

        get_batch = ImagePrefetcher.get_batch
        attn = vit.multi_head_attention
        inst = self

        def spanned_get_batch(self_, paths):
            with inst.span("ingest"):
                return get_batch(self_, paths)

        def spanned_attention(q, k, v):
            inst.run.attention_calls.append((time.perf_counter(), *q.shape))
            with inst.span("attention"):
                return attn(q, k, v)

        ImagePrefetcher.get_batch = spanned_get_batch
        if self.run.trace:
            vit.multi_head_attention = spanned_attention
        try:
            yield
        finally:
            ImagePrefetcher.get_batch = get_batch
            vit.multi_head_attention = attn

    # -- chunk completions ---------------------------------------------------
    def chunk_done(self, solver) -> None:
        res = solver.results[-1]
        eg = np.asarray(res["extrinsics_global"])  # a deferred fetch is counted here
        now = time.perf_counter()
        run = self.run
        if not self.closing:
            n_new = len(res["image_paths"]) - res["dedup_skip"]
            run.chunks.append(Chunk(self.seq, solver.chunk_count - 1, now, n_new, self.live_due))
            if self._cur is not None:
                self._cur.extrinsics_global = eg
                run.captures.append(self._cur)
        self._cur = None
        if run.trace:
            self._trace_step()
        if self.deadline is not None and now - run.t0 >= self.deadline:
            run.t_close = now
            self.closing = True
            raise WindowClosed

    def _trace_step(self) -> None:
        """Start the profiled slice after ``trace_skip_chunks`` chunks, stop it
        ``trace_slice_chunks`` later; host waits are counted after it."""
        run, n = self.run, len(self.run.chunks)
        skip, size = self.settings["trace_skip_chunks"], self.settings["trace_slice_chunks"]
        if n == skip and self._prof is None:
            _sync()
            self._prof = _profiler()
            self._prof.start()
            self._slice_rf = torch.profiler.record_function("slambench.slice")
            self._slice_rf.__enter__()
            run.slice_span = (time.perf_counter(), 0.0)
        elif n == skip + size and self._slice_rf is not None:
            _sync()
            self._slice_rf.__exit__(None, None, None)
            self._slice_rf = None
            self._prof.stop()
            run.slice_span = (run.slice_span[0], time.perf_counter())
            run.slice_chunks = size
            run.steady = (time.perf_counter(), 0.0)
            from slambench.lib.trace import HostWaits

            self._waits = HostWaits()
            self._waits.start()

    def finish_trace(self) -> None:
        """Close the slice if the window ended inside it, stop the host-wait
        count, and read the slice's trace (after the window)."""
        run = self.run
        if self._slice_rf is not None:
            _sync()
            self._slice_rf.__exit__(None, None, None)
            self._prof.stop()
            run.slice_span = (run.slice_span[0], time.perf_counter())
            run.slice_chunks = len(run.chunks) - self.settings["trace_skip_chunks"]
        if self._waits is not None:
            run.host_waits, run.host_waits_at = self._waits.stop()
            run.steady = (run.steady[0], run.t_close)
        if self._prof is not None:
            from slambench.lib.trace import TraceSlice, load_trace

            with tempfile.TemporaryDirectory(prefix="slambench-trace-") as d:
                path = Path(d) / "trace.json"
                self._prof.export_chrome_trace(str(path))
                run.slice_trace = TraceSlice(load_trace(path))
            self._prof = None


def chunks_in_sequence(n_frames: int, chunk: int, overlap: int) -> int:
    if n_frames <= chunk:
        return 1
    step = chunk - overlap
    return 1 + (n_frames - chunk) // step + (1 if (n_frames - chunk) % step else 0)


def warm_frames(cell) -> int:
    """Frames of a two-chunk pass: the cell's shapes (the tail window is a full
    chunk's shape)."""
    m = cell.settings["solver"]["Model"]
    return 2 * m["chunk_size"] - m["overlap_size"]


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _warm_profiler(device) -> None:
    """The profiler's first start costs seconds: pay it in set-up."""
    with _profiler():
        torch.ones(8, device=device).sum()
        _sync()


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: torch.device, control: str | None = None) -> tuple[Run, object]:
    """Set-up, the window, and the program's state freed.  Returns the run and
    the built weights, which the comparison reads.  ``control`` ``w8a8`` runs
    the program's own int8 path in its place."""
    drv = cell.driver
    run = Run(cell, seed, seconds, trace, cell.traffic["driver"], dtype=cell.config["dtype"])
    with tempfile.TemporaryDirectory(prefix="slambench-") as d:
        workdir = Path(d)
        built = build(cell.config, seed, device, cell.bench_dir)
        model = built.model
        quantize = "w8a8" if control == "w8a8" else cell.config.get("quantize")
        if quantize:
            model = model.quantize(quantize)
        source = drv.source(cell, seed, device, workdir)
        with contextlib.redirect_stdout(sys.stderr):
            drv.warm(model, cell, source, workdir, device)
            _sync()
            if trace:
                _warm_profiler(device)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            inst = Instruments(run, cell.settings, drv.capture_plan(cell, seed, seconds))
            inst.wrap_model(model)
            run.setup_s = time.perf_counter() - t_start
            with inst.wrap_program():
                drv.drive(model, cell, source, run, inst, device)
            if device.type == "cuda":
                run.memory_peak_bytes = torch.cuda.max_memory_allocated()
            inst.finish_trace()
        del model, inst, source
        built.model = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        # the reference decodes the JPEGs itself: read them before the folder goes
        for c in run.captures:
            if c.frames and isinstance(c.frames[0], str):
                from PIL import Image

                c.frames = [np.asarray(Image.open(p).convert("RGB")) for p in c.frames]
    return run, built
