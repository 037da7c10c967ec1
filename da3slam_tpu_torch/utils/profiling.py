"""Per-stage wall-time accumulation (counterpart of
``da3slam_tpu/utils/profiling.py:StageTimer``) and a kernel timer.

CUDA work is asynchronous: a host clock around it measures the enqueue.
``StageTimer(sync=True)`` synchronises the device at the end of each stage so
the stage's time includes its device work.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict

import torch


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
    >>> with timer("forward"):
    ...     out = model(x)
    >>> print(timer.report())
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        # first call per stage (warm-up, kernel build) is reported apart
        self.firsts: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_initialized():
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
