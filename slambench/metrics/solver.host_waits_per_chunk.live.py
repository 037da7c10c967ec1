"""solver.host_waits_per_chunk.live: host waits for the device, a chunk (live)."""
from slambench.lib.readers import host_waits_per_chunk as read  # noqa: F401
