"""Spans, per-stage wall-time accumulation, a kernel timer and a device
trace context (counterpart of ``da3slam_tpu/utils/profiling.py``; the spans
are the port's own).

``span(name, **attrs)`` records one named interval of host time
(``time.perf_counter``) into an in-memory ring of ``RING_RECORDS`` records,
with its enclosing span on the same thread, the chunk it served (inherited
from the enclosing span) and its attributes (``bytes`` for a transfer).  A
per-name aggregate keeps the count, seconds and bytes of every span ever
closed; ``records()`` and ``snapshot()`` read them.  The recorder is always
on and costs 1.6-2.3 µs a span on an H100 machine's host; only while a
``torch.profiler`` runs does a span also open
``torch.profiler.record_function(name)`` (7-8 µs even without a profiler),
so that it sits in the profiler's trace beside the kernels it launched.

CUDA work is asynchronous: a host clock around it measures the enqueue.
``StageTimer(sync=True)`` waits for the device at the end of each stage so
the stage's time includes its device work; each stage is also a span.
``profile_trace`` records a ``torch.profiler`` trace (host activities, and
the card's kernels when the device is CUDA) and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import statistics
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Any, NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

# the Chrome trace ``profile_trace`` writes into its directory
TRACE_FILE = "trace.json"


def _first_tensor(x: Any) -> torch.Tensor | None:
    """The first tensor of a nested structure (dicts by sorted key, as JAX
    flattens them; lists, tuples, named tuples, dataclasses), or None."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        try:
            items = [x[k] for k in sorted(x)]
        except TypeError:  # keys that do not sort: insertion order
            items = x.values()
    elif isinstance(x, (list, tuple)):
        items = x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        items = [getattr(x, f.name) for f in dataclasses.fields(x)]
    else:
        return None
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


# -- spans ----------------------------------------------------------------------

RING_RECORDS = 1 << 16


class SpanRecord(NamedTuple):
    id: int
    name: str
    start: float  # time.perf_counter seconds
    end: float
    parent: int | None  # id of the enclosing span on the same thread
    chunk: Any  # the chunk served, as its root span names it; None outside chunks
    thread: int  # threading.get_ident()
    attrs: dict  # e.g. {"bytes": n} for a transfer


class _Ring:
    """The recorder's state: the kept records (raw tuples in the order they
    closed), and the count, latest start and per-name totals of those the
    bound dropped."""

    __slots__ = ("records", "capacity", "drop_batch", "lock", "dropped", "dropped_through",
                 "dropped_totals")

    def __init__(self, capacity: int):
        self.records: deque = deque()
        self.capacity = capacity
        self.drop_batch = max(1, capacity >> 6)  # records dropped at once at the bound
        self.lock = threading.Lock()
        self.dropped = 0
        self.dropped_through = -math.inf
        self.dropped_totals: dict[str, list] = {}  # name -> [count, seconds, bytes]

    def add_at_bound(self, raw: tuple) -> None:
        """Append at the bound: drop the oldest records, ``drop_batch`` below
        it, so that the next appends take the path without the lock
        (``deque.append`` is atomic; the ring may pass the bound by one record
        a thread until the next drop)."""
        with self.lock:
            self.records.append(raw)
            while len(self.records) > self.capacity - self.drop_batch:
                old = self.records.popleft()
                self.dropped += 1
                self.dropped_through = max(self.dropped_through, old[2])
                _add_to_totals(self.dropped_totals, old)


def _add_to_totals(totals: dict, raw: tuple) -> None:
    t = totals.setdefault(raw[1], [0, 0.0, 0])
    t[0] += 1
    t[1] += raw[3] - raw[2]
    t[2] += raw[7].get("bytes", 0)


_RING = _Ring(RING_RECORDS)
_ids = itertools.count(1)
_local = threading.local()  # .state = (stack of open (id, chunk), thread ident)
_clock = time.perf_counter


class _Span:
    """``span(name, chunk=None, **attrs)``: a span of the process's recorder,
    ``with span("align.fetch") as a: ...; a["bytes"] = n``.  ``__enter__``
    returns ``attrs``, which the block may still fill (the bytes of a
    transfer known only once it is made).  ``chunk`` names the chunk a root
    span serves; nested spans inherit it."""

    __slots__ = ("_name", "_chunk", "_attrs", "_id", "_parent", "_start", "_rf", "_state")

    def __init__(self, name: str, chunk: Any = None, **attrs):
        self._name = name
        self._chunk = chunk
        self._attrs = attrs

    def __enter__(self) -> dict:
        try:
            state = _local.state
        except AttributeError:
            state = _local.state = ([], threading.get_ident())
        stack = state[0]
        if stack:
            self._parent, chunk = stack[-1]
            if self._chunk is None:
                self._chunk = chunk
        else:
            self._parent = None
        self._id = i = next(_ids)
        stack.append((i, self._chunk))
        self._state = state
        if _autograd_profiler._is_profiler_enabled:  # set by any running torch.profiler
            self._rf = rf = torch.profiler.record_function(self._name)
            rf.__enter__()
        else:
            self._rf = None
        # read after the profiler's event has opened and after it has closed:
        # record_function stamps early in its enter and late in its exit
        self._start = _clock()
        return self._attrs

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        end = _clock()
        state = self._state
        state[0].pop()
        raw = (self._id, self._name, self._start, end, self._parent, self._chunk, state[1],
               self._attrs)
        ring = _RING
        if len(ring.records) < ring.capacity:
            ring.records.append(raw)
        else:
            ring.add_at_bound(raw)


# the class itself, not a function returning it: a call less a span
span = _Span


def records(since: float = -math.inf) -> list[SpanRecord]:
    """The kept records of spans that started after ``since``
    (``perf_counter`` seconds), in the order they closed."""
    raw = list(_RING.records)  # one C call: atomic with respect to appends
    return [SpanRecord(*r) for r in raw if r[2] > since]


def snapshot() -> dict:
    """``{"kept", "dropped", "dropped_through", "capacity", "by_name": {name:
    {"count", "seconds", "bytes"}}}``: the ring's counts (``dropped_through``
    is the latest start among the dropped records) and the totals of every
    span closed, dropped or kept."""
    ring = _RING
    with ring.lock:
        kept = list(ring.records)
        totals = {k: list(v) for k, v in ring.dropped_totals.items()}
        dropped, through = ring.dropped, ring.dropped_through
    for raw in kept:
        _add_to_totals(totals, raw)
    return {"kept": len(kept), "dropped": dropped, "dropped_through": through,
            "capacity": ring.capacity,
            "by_name": {k: {"count": c, "seconds": t, "bytes": b}
                        for k, (c, t, b) in totals.items()}}


def nbytes(*xs) -> int:
    """Bytes of the tensors and arrays ``xs`` (what a transfer of them moves)."""
    return sum(int(x.nbytes) for x in xs)


def force_completion(x: Any) -> None:
    """Wait until the device that holds the first tensor of ``x`` (a nested
    structure) has finished its queued work; nothing to wait for on the CPU
    or without a tensor."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def time_ms(fn, device: torch.device | str, reps: int = 5) -> float:
    """Median time of ``fn()`` in ms over ``reps`` runs, after one warm-up:
    CUDA events on a CUDA device, the host clock on the CPU."""
    on_cuda = torch.device(device).type == "cuda"
    fn()
    times = []
    for _ in range(reps):
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class StageTimer:
    """Accumulates host wall time per named stage across loop iterations;
    each stage is also a ``span`` of its name.

    >>> timer = StageTimer(sync=True)
    >>> with timer("forward") as box:
    ...     box["result"] = model(x)  # or timer("forward", result=...)
    >>> print(timer.report())

    With ``sync``, a stage ends by waiting for the device of its result
    (``box["result"]``, else the ``result`` argument; ``force_completion``),
    or for every CUDA device when it names none.
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        # first call per stage (warm-up, kernel build) is reported apart
        self.firsts: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, stage: str, result: Any = None):
        with span(stage):
            t0 = time.perf_counter()
            box: dict = {}
            try:
                yield box
            finally:
                target = box.get("result", result)
                if self.sync and target is not None:
                    force_completion(target)
                elif self.sync and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                self.firsts.setdefault(stage, dt)
                self.totals[stage] += dt
                self.counts[stage] += 1

    def steady_ms(self, stage: str) -> float:
        """Mean ms/call excluding the first call (the first call alone when
        the stage ran once)."""
        n = self.counts[stage]
        t = self.totals[stage]
        if n <= 1:
            return t * 1e3
        return (t - self.firsts[stage]) / (n - 1) * 1e3

    def report(self) -> str:
        if not self.totals:
            return "(no stages timed)"
        width = max(len(s) for s in self.totals)
        total = sum(self.totals.values())
        lines = []
        for stage, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[stage]
            lines.append(
                f"{stage:<{width}}  {t:8.3f}s total  {self.steady_ms(stage):8.1f} ms/call"
                f"  x{n:<5d} first {self.firsts[stage] * 1e3:8.1f} ms"
                f"  {100 * t / total:5.1f}%"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.firsts.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str | Path = "da3slam_trace", device: str | torch.device | None = None):
    """Record a ``torch.profiler`` trace of the block and write it as a Chrome
    trace, ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing).
    Host activities always; the card's kernels too when ``device`` (default:
    CUDA when available) is CUDA.  Yields ``log_dir``.  On the CPU a profiler
    that cannot start prints why and yields None, and the block runs
    untraced; on CUDA that is an error."""
    from torch.profiler import ProfilerActivity, profile

    on_cuda = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except Exception as e:
        if on_cuda:
            raise
        print(f"profiler unavailable ({e}); running without trace")
        yield None
        return
    try:
        yield log_dir
    finally:
        prof.__exit__(None, None, None)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / TRACE_FILE))
