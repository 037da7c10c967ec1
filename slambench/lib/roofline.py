"""Peaks of the card and the least time an operation could take.

Frozen copy of ``chip_smoke.py:PEAK_FLOPS``, ``PEAK_BYTES_PER_S``,
``roofline`` and ``attention_roofline`` at commit b277bb1: NVIDIA's H100 SXM
data sheet, dense rates.  The exp2 floor (``PEAK_EXP2_PER_S``) is left out:
it is an assumed rate, not a published peak.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def roofline_s(flop: float, nbytes: float, dtype: str) -> float:
    """The larger of operations over the peak rate of their type and bytes
    (each input read once, each output written once) over the memory rate."""
    return max(flop / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def attention_flop(B: int, S: int, H: int, D: int) -> float:
    """A forward without a mask: Q·Kᵀ and P·V, 2·S²·D each, per (batch, head)."""
    return 4.0 * B * H * S * S * D


def attention_roofline_s(B: int, S: int, H: int, D: int, dtype: str) -> float:
    """q, k and v read once and o written once."""
    return roofline_s(attention_flop(B, S, H, D), 4 * B * S * H * D * ELEMENT_BYTES[dtype], dtype)
