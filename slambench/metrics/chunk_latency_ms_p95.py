"""chunk_latency_ms_p95: live chunk latency, 95th percentile."""
from slambench.lib.readers import chunk_latency_ms_p95 as read  # noqa: F401
