"""solver.transfer_mb_per_chunk: bytes of the *.upload and *.fetch spans, 1e6 B a chunk."""
from slambench.lib.program_spans import transfer_mb_per_chunk as read  # noqa: F401
