"""ingest.decode_ms_per_frame: host wall of the program's ingest.decode spans, a frame."""
from slambench.lib.program_spans import span_ms_per_span

read = span_ms_per_span("ingest.decode")
