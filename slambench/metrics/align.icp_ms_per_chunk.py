"""align.icp_ms_per_chunk: host wall of the program's align.icp spans, a chunk aligned."""
from slambench.lib.program_spans import span_ms_per_span

read = span_ms_per_span("align.icp")
