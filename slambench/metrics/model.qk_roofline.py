"""model.qk_roofline: the least time QK-norm and RoPE could take over the
device time of what the program's ``model.qk`` spans launched in the slice.

The bound of one span is the bytes that QK-norm and RoPE of one attention
must move at least: q and k read once and written once in the activation
dtype, ``4·B·S·H·D`` elements (``B``, ``S``, ``H``, ``D`` are the span's
attributes, its attention's shape), at the card's 3.35 TB/s.  The spans
counted are those that start in the slice; None where the run holds none or
no device time under them.
"""
from slambench.lib import program_spans
from slambench.lib.roofline import ELEMENT_BYTES, PEAK_BYTES_PER_S

SPAN = "model.qk"
_device_ms = program_spans.device_ms_per_chunk(SPAN)


def qk_bytes(B: int, S: int, H: int, D: int, dtype: str) -> float:
    """q and k, each read once and written once."""
    return 4.0 * B * S * H * D * ELEMENT_BYTES[dtype]


def read(run):
    got = program_spans.slice_records(run)
    ms = _device_ms(run)
    if got is None or not ms:
        return None
    a, b = run.slice_span
    spans = [r for r in got[1] if r.name == SPAN and a <= r.start <= b]
    if not spans:
        return None
    bound = sum(qk_bytes(*(r.attrs[k] for k in "BSHD"), run.dtype) for r in spans)
    return 100.0 * bound / PEAK_BYTES_PER_S / (ms * run.slice_chunks / 1e3)
