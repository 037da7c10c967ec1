"""Readers of the program's own spans: the in-memory recorder of
``da3slam_tpu_torch/utils/profiling.py`` (``records()``, ``snapshot()``),
read in the process that ran the cell.

Host readers take the spans that started after the profiled slice, up to the
window's close (``(run.steady[0], run.t_close]``, as ``lib/readers.py``
does), and return None where the ring dropped records of that part.  Device
readers put the spans on the profiler trace's clock: the recorder's times are
``time.perf_counter`` seconds, and the offset between the two clocks is read
at the start of ``slambench.slice`` (its trace event against
``run.slice_span[0]``).  A program without the recorder (one older than it)
gives None everywhere.
"""

from __future__ import annotations

import bisect

from slambench.lib.readers import _steady_chunks
from slambench.lib.trace import merged

TRANSFER_SUFFIXES = (".upload", ".fetch")
# how far the trace's end of the slice may pass the host's, mapped through the
# offset read at its start (the host's end is read after the profiler stopped,
# so it can only be later, unless the two clocks drift apart)
DRIFT_S = 1e-3
# the spans open at the slice's start (its chunk's) opened at most this long before it
LOOKBACK_S = 60.0


def _recorder():
    try:
        from da3slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") and hasattr(profiling, "snapshot") else None


def steady_records(run):
    """The program's records of spans that started after the slice, up to
    the window's close; None untraced, without the recorder, or where the
    ring dropped records of that part."""
    rec = _recorder()
    if rec is None or not run.trace or run.steady[0] <= 0:
        return None
    a, b = run.steady[0], run.t_close
    snap = rec.snapshot()
    if snap["dropped"] and snap["dropped_through"] > a:
        return None
    return [r for r in rec.records(since=a) if r.start <= b]


def _is_transfer(name: str) -> bool:
    return name.endswith(TRANSFER_SUFFIXES)


def span_ms_per_span(name: str):
    def read(run):
        """Host wall of the program's ``name`` spans after the slice, per span."""
        recs = steady_records(run)
        if recs is None:
            return None
        spans = [r.end - r.start for r in recs if r.name == name]
        return sum(spans) * 1e3 / len(spans) if spans else None
    return read


def transfer_ms_per_chunk(run):
    """Host wall of every ``*.upload`` and ``*.fetch`` span after the slice,
    a chunk: the time the host spent moving data to and from the card."""
    recs, n = steady_records(run), len(_steady_chunks(run))
    if recs is None or not n:
        return None
    return sum(r.end - r.start for r in recs if _is_transfer(r.name)) * 1e3 / n


def transfer_mb_per_chunk(run):
    """Bytes of those spans after the slice, in 1e6 B, a chunk."""
    recs, n = steady_records(run), len(_steady_chunks(run))
    if recs is None or not n:
        return None
    return sum(r.attrs.get("bytes", 0) for r in recs if _is_transfer(r.name)) / 1e6 / n


def clock_offset(run):
    """Seconds that put a ``perf_counter`` time on the slice trace's clock;
    None without a trace or where the slice's end shows the clocks drifting
    apart by more than ``DRIFT_S``."""
    sl = run.slice_trace
    if sl is None or run.slice_span[1] <= 0:
        return None
    off = sl.t0 - run.slice_span[0]
    if run.slice_span[1] + off < sl.t1 - DRIFT_S:
        return None
    return off


def slice_records(run):
    """(offset, the program's records of spans that overlap the slice), or
    None."""
    rec, off = _recorder(), clock_offset(run)
    if rec is None or off is None:
        return None
    a, b = run.slice_span
    snap = rec.snapshot()
    if snap["dropped"] and snap["dropped_through"] > a - LOOKBACK_S:
        return None
    return off, [r for r in rec.records(since=a - LOOKBACK_S) if r.end >= a and r.start <= b]


def _ops_under(run, name: str):
    """The slice's device operations whose launch the host issued inside a
    ``name`` span of the program; None where the spans cannot be placed."""
    got = slice_records(run)
    if got is None:
        return None
    off, recs = got
    ivs = merged([(r.start + off, r.end + off) for r in recs if r.name == name])
    starts = [s for s, _ in ivs]
    sl = run.slice_trace
    out = []
    for op in sl.ops:
        ts = sl.launch_ts.get(op[3])
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ivs[i][1]:
            out.append(op)
    return out


def launches_per_chunk(name: str):
    def read(run):
        """Device operations launched inside the program's ``name`` spans in
        the slice, a chunk of the slice."""
        ops = _ops_under(run, name) if run.slice_chunks else None
        return None if ops is None else len(ops) / run.slice_chunks
    return read


def device_ms_per_chunk(name: str):
    def read(run):
        """Device time of the operations launched inside the program's
        ``name`` spans in the slice, a chunk of the slice."""
        ops = _ops_under(run, name) if run.slice_chunks else None
        return None if ops is None else sum(e - s for s, e, _, _ in ops) * 1e3 / run.slice_chunks
    return read


def idle_by_span(run, n: int = 12):
    """The slice's idle time summed by the innermost program span open on the
    solver's thread at the start of each idle gap; ``[[name, seconds]]``,
    the largest first, or None."""
    got = slice_records(run)
    if got is None:
        return None
    off, recs = got
    solver = {r.thread for r in recs if r.name == "chunk"}
    spans = sorted((r.start + off, r.end + off, r.name) for r in recs if r.thread in solver)
    starts = [s for s, _, _ in spans]
    sl = run.slice_trace
    busy = merged([(s, e) for s, e, _, _ in sl.ops])
    edges = [sl.t0] + [x for iv in busy for x in iv] + [sl.t1]
    by: dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        inner = "no span"
        for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            if spans[i][1] > a:  # the latest-starting span still open
                inner = spans[i][2]
                break
        by[inner] = by.get(inner, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
