"""solver.transfer_ms_per_chunk: host wall of the program's *.upload and *.fetch spans, a chunk."""
from slambench.lib.program_spans import transfer_ms_per_chunk as read  # noqa: F401
