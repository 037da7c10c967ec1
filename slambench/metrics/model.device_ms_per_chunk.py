"""model.device_ms_per_chunk: device time the model launched, a chunk."""
from slambench.lib.readers import model_device_ms_per_chunk as read  # noqa: F401
