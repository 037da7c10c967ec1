"""align.ms_per_chunk.live: host wall of process_chunk_alignment (live)."""
from slambench.lib.readers import span_ms_per_chunk

read = span_ms_per_chunk("align")
