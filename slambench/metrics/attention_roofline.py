"""attention_roofline: the encoder attention's roofline bound over its device time."""
from slambench.lib.readers import attention_roofline as read  # noqa: F401
