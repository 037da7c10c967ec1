"""solver.transfer_ms_per_chunk.live: host wall of *.upload and *.fetch spans, a chunk (live)."""
from slambench.lib.program_spans import transfer_ms_per_chunk as read  # noqa: F401
