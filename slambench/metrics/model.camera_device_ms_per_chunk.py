"""model.camera_device_ms_per_chunk: device time launched inside model.camera (VGGT's camera head) in the slice, a chunk."""
from slambench.lib.program_spans import device_ms_per_chunk

read = device_ms_per_chunk("model.camera")
