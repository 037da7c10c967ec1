"""Per-stage wall-time accumulation, a kernel timer and a device trace
context (counterpart of ``da3slam_tpu/utils/profiling.py``).

CUDA work is asynchronous: a host clock around it measures the enqueue.
``StageTimer(sync=True)`` waits for the device at the end of each stage so
the stage's time includes its device work.  ``profile_trace`` records a
``torch.profiler`` trace (host activities, and the card's kernels when the
device is CUDA) and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from collections import defaultdict
from pathlib import Path
from typing import Any

import torch

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
    """Accumulates wall time per named stage across loop iterations.

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
