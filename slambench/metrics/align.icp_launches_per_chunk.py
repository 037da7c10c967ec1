"""align.icp_launches_per_chunk: device operations launched inside align.icp, a slice chunk."""
from slambench.lib.program_spans import launches_per_chunk

read = launches_per_chunk("align.icp")
