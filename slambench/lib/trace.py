"""Counters and the reading of a profiler trace.

``HostWaits`` is a frozen copy of ``chip_smoke.py:_count_syncs`` at commit
b277bb1.
The idle share is computed anew: from the union of the device's kernel,
copy and set intervals inside the traced slice (the copied ``_profile`` took
1 − Σ self device time ÷ profiled wall, which counts overlapping streams
twice).
"""

from __future__ import annotations

import bisect
import gzip
import json
import warnings
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "slambench."
SLICE = "slambench.slice"


class HostWaits:
    """Counts the host's waits for the device as ``torch.cuda.set_sync_debug_mode``
    reports them, between ``start()`` and ``stop()``, with the Python line of each."""

    def __init__(self):
        self._ctx = None
        self._caught: list = []

    def start(self) -> None:
        import torch

        self._ctx = warnings.catch_warnings(record=True)
        self._caught = self._ctx.__enter__()
        warnings.simplefilter("always")
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode("warn")

    def stop(self) -> tuple[int, dict[str, int]]:
        import torch

        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode("default")
        self._ctx.__exit__(None, None, None)
        where: dict[str, int] = {}
        for w in self._caught:
            if "synchroniz" in str(w.message):
                key = f"{Path(w.filename).name}:{w.lineno}"
                where[key] = where.get(key, 0) + 1
        return sum(where.values()), where


def load_trace(path: Path) -> list[dict]:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Length covered by the union of ``(start, end)`` intervals."""
    return sum(e - s for s, e in merged(intervals))


class TraceSlice:
    """A chrome trace of one profiled slice: device operations, the host spans
    named ``slambench.*`` and the ``slambench.slice`` span around the whole
    slice.  Times in seconds."""

    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        sl = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == SLICE]
        if not sl:
            raise ValueError("the trace holds no slambench.slice span")
        self.t0 = sl[0]["ts"] * 1e-6
        self.t1 = self.t0 + sl[0]["dur"] * 1e-6
        self.ops = []  # (start, end, name, correlation)
        for e in xs:
            if e.get("cat") in DEVICE_CATS:
                s = max(e["ts"] * 1e-6, self.t0)
                t = min((e["ts"] + e["dur"]) * 1e-6, self.t1)
                if t > s:
                    self.ops.append((s, t, e["name"], e.get("args", {}).get("correlation")))
        self.launch_ts = {e["args"]["correlation"]: e["ts"] * 1e-6 for e in xs
                          if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.spans: dict[str, list[tuple[float, float]]] = {}
        for e in xs:
            name = e.get("name", "")
            if e.get("cat") == "user_annotation" and name.startswith(SPAN_PREFIX) and name != SLICE:
                self.spans.setdefault(name[len(SPAN_PREFIX):], []).append(
                    (e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6))
        for v in self.spans.values():
            v.sort()

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return union_length([(s, e) for s, e, _, _ in self.ops])

    def device_s_under(self, span: str) -> float:
        """Device time of the operations whose launch the host issued inside a
        ``slambench.<span>`` span (by the profiler's correlation ids)."""
        ivs = self.spans.get(span, [])
        starts = [s for s, _ in ivs]
        total = 0.0
        for s, e, _, corr in self.ops:
            ts = self.launch_ts.get(corr)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= ivs[i][1]:
                total += e - s
        return total

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for s, e, name, _ in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle time inside the slice, summed by the innermost host span that
        was open at the start of each gap."""
        busy = merged([(s, e) for s, e, _, _ in self.ops])
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        starts = {name: [s for s, _ in ivs] for name, ivs in self.spans.items()}
        by: dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            inner, start = "no span", -1.0
            for name, ivs in self.spans.items():
                i = bisect.bisect_right(starts[name], a) - 1
                if i >= 0 and a < ivs[i][1] and ivs[i][0] > start:
                    inner, start = name, ivs[i][0]
            by[inner] = by.get(inner, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
