"""Overlapping temporal chunking (counterpart of
``da3slam_tpu/slam/chunks.py:make_chunk_indices``): step = chunk_size - overlap,
with the tail window re-anchored so every window has the full chunk size."""

from __future__ import annotations


def make_chunk_indices(n_frames: int, chunk_size: int, overlap: int) -> list[tuple[int, int]]:
    """[start, end) index ranges; the last range is re-anchored to keep the
    full chunk size."""
    if chunk_size <= overlap:
        raise ValueError(f"chunk_size ({chunk_size}) must exceed overlap ({overlap})")
    if n_frames <= chunk_size:
        return [(0, n_frames)]
    step = chunk_size - overlap
    ranges = []
    start = 0
    while start + chunk_size < n_frames:
        ranges.append((start, start + chunk_size))
        start += step
    ranges.append((n_frames - chunk_size, n_frames))
    return ranges
