"""mfu: the model's operations a second as a share of the card's peak."""
from slambench.lib.readers import mfu as read  # noqa: F401
