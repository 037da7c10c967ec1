"""align.ms_per_chunk: host wall of process_chunk_alignment (offline)."""
from slambench.lib.readers import span_ms_per_chunk

read = span_ms_per_chunk("align")
