"""setup_s: from process start to the window."""
from slambench.lib.readers import setup_s as read  # noqa: F401
