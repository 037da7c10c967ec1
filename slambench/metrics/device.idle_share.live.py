"""device.idle_share.live: idle share of the card in the traced slice (live)."""
from slambench.lib.readers import idle_share as read  # noqa: F401
