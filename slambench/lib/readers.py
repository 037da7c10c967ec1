"""The arithmetic of the metrics; each ``metrics/<name>.py`` binds one of
these as its ``read``.  A reader returns None where the run holds nothing to
read (an untraced run, no chunk in the part it reads)."""

from __future__ import annotations

import math

from slambench.lib.roofline import PEAK_FLOPS, attention_roofline_s


def frames_per_s(run):
    """Frames whose global poses reached the host in the window, over its length."""
    if not run.chunks or run.window_s <= 0:
        return None
    return run.frames / run.window_s


def chunk_latency_ms_p95(run):
    """Open loop: the 95th percentile (nearest rank) of every chunk due in the window, from the
    due time of its last frame to its global poses on the host; a chunk due
    and not completed counts as infinitely late."""
    if run.attempted == 0 or any(c.due is None for c in run.chunks):
        return None
    lat = sorted([(c.t_done - c.due) * 1e3 for c in run.chunks] + [math.inf] * run.failed)
    return lat[math.ceil(0.95 * len(lat)) - 1]


def setup_s(run):
    return run.setup_s


def _steady_chunks(run):
    return run.chunks_between(run.steady[0], run.t_close) if run.trace else []


def host_waits_per_chunk(run):
    """The host's waits for the device (sync debug mode) after the slice, a chunk."""
    n = len(_steady_chunks(run))
    return run.host_waits / n if n else None


def span_ms_per_chunk(name: str):
    def read(run):
        """Host wall of the ``name`` spans after the slice, per span."""
        if not run.trace:
            return None
        total, n = run.span_total(name, run.steady[0], run.t_close)
        return total * 1e3 / n if n else None
    return read


def ingest_ms_per_chunk(run):
    """Host wall of ``ImagePrefetcher.get_batch`` after the slice, a chunk."""
    n = len(_steady_chunks(run))
    if not n:
        return None
    total, calls = run.span_total("ingest", run.steady[0], run.t_close)
    return total * 1e3 / n if calls else None


def model_device_ms_per_chunk(run):
    """Device time of what the model's calls launched in the slice, a chunk."""
    if run.slice_trace is None or not run.slice_chunks:
        return None
    return run.slice_trace.device_s_under("model") * 1e3 / run.slice_chunks


def mfu(run):
    """The reference's operations of the chunks completed after the slice,
    over that time, as a share of the card's dense peak in the stated dtype."""
    chunks = _steady_chunks(run)
    seconds = run.t_close - run.steady[0]
    if not chunks or seconds <= 0 or not run.flops_per_chunk:
        return None
    return 100.0 * run.flops_per_chunk * len(chunks) / seconds / PEAK_FLOPS[run.dtype]


def attention_roofline(run):
    """Σ roofline bound of the encoder's attention calls in the slice over the
    device time of what they launched."""
    if run.slice_trace is None:
        return None
    a, b = run.slice_span
    bound = sum(attention_roofline_s(B, S, H, D, run.dtype)
                for t, B, S, H, D in run.attention_calls if a <= t <= b)
    device = run.slice_trace.device_s_under("attention")
    return 100.0 * bound / device if bound and device else None


def idle_share(run):
    """1 − the union of device operations over the traced slice."""
    if run.slice_trace is None or run.slice_trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice_trace.busy_s() / run.slice_trace.window_s)
