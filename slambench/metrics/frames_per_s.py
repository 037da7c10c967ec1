"""frames_per_s: SLAM frames a second, offline cells."""
from slambench.lib.readers import frames_per_s as read  # noqa: F401
