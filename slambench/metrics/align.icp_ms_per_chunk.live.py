"""align.icp_ms_per_chunk.live: host wall of align.icp, a chunk aligned (live)."""
from slambench.lib.program_spans import span_ms_per_span

read = span_ms_per_span("align.icp")
