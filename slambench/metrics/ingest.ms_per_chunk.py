"""ingest.ms_per_chunk: host wall of ImagePrefetcher.get_batch, a chunk."""
from slambench.lib.readers import ingest_ms_per_chunk as read  # noqa: F401
