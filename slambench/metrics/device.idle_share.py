"""device.idle_share: idle share of the card in the traced slice (offline)."""
from slambench.lib.readers import idle_share as read  # noqa: F401
