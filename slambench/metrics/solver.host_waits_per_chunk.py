"""solver.host_waits_per_chunk: host waits for the device, a chunk (offline)."""
from slambench.lib.readers import host_waits_per_chunk as read  # noqa: F401
