"""Overlapping temporal chunking (counterpart of ``da3slam_tpu/slam/chunks.py``):
step = chunk_size - overlap, with the tail window re-anchored so every window
has the full chunk size; and the chunked-inference + alignment loop that the
offline tools share."""

from __future__ import annotations

from typing import Sequence, TypeVar

import numpy as np
import torch

T = TypeVar("T")


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


def make_image_chunks(items: Sequence[T], chunk_size: int, overlap: int) -> list[list[T]]:
    """Materialised chunk lists."""
    return [list(items[a:b]) for a, b in make_chunk_indices(len(items), chunk_size, overlap)]


def run_chunked_alignment(
    model,
    paths: Sequence,
    chunk_size: int,
    overlap: int = 1,
    process_res: int = 504,
    align_config=None,
    collect_images: bool = False,
    verbose: bool = True,
    dedup_overlap: bool = False,
):
    """Run the model per chunk, chain each chunk into the global frame via
    single-overlap alignment (on the model's device), and return the
    concatenated numpy arrays (overlap frames appear once per chunk).

    ``dedup_overlap=True`` drops each non-initial chunk's leading overlap
    frames (``anchor + 1`` of them: more than ``overlap`` for the widened
    tail) before concatenation, so every physical frame appears exactly
    once.  Weighted consumers want this: duplicated overlap observations
    double-weight chunk seams in a running average.

    The tail chunk is re-anchored to keep the full chunk size
    (:func:`make_chunk_indices`), which widens its overlap with its
    predecessor: ``anchor = prev_end - 1 - tail_start`` keeps the alignment
    pairing on the same physical frame.

    Returns dict(depth [T', H, W], conf, intrinsics, extrinsics_global,
    images (when requested), ranges).
    """
    from da3slam_tpu_torch.slam.alignment import AlignmentConfig, align_chunk_single_overlap

    device = getattr(model, "device", "cpu")

    def dev(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    ranges = make_chunk_indices(len(paths), chunk_size, overlap)
    depths, confs, Ks, Es, imgs = [], [], [], [], []
    prev = None
    prev_overlap = None
    for k, (a, b) in enumerate(ranges):
        cur = model.inference(image=list(paths[a:b]), process_res=process_res)
        anchor = -1
        if k == 0:
            ext_global = np.asarray(cur.extrinsics, np.float32)
        else:
            anchor = ranges[k - 1][1] - 1 - a  # index of prev chunk's last frame
            out = align_chunk_single_overlap(
                prev_depth=dev(prev.depth[-1]),
                prev_conf=dev(prev.conf[-1]),
                prev_K=dev(prev.intrinsics[-1]),
                cur_depth=dev(cur.depth),
                cur_conf=dev(cur.conf),
                cur_K=dev(cur.intrinsics),
                cur_extrinsics=dev(cur.extrinsics),
                prev_overlap_global=dev(prev_overlap),
                config=align_config or AlignmentConfig(),
                anchor_idx=int(anchor),
            )
            ext_global = out.extrinsics_global.cpu().numpy()
            cur.depth = out.depth_scaled.cpu().numpy()
        # first frame kept of this chunk
        s = anchor + 1 if dedup_overlap else 0
        depths.append(np.asarray(cur.depth)[s:])
        confs.append(np.asarray(cur.conf)[s:])
        Ks.append(np.asarray(cur.intrinsics)[s:])
        Es.append(ext_global[s:])
        if collect_images:
            imgs.append(np.asarray(cur.processed_images)[s:])
        prev, prev_overlap = cur, ext_global[-1]
        if verbose:
            print(f"chunk {k + 1}/{len(ranges)} done")

    out = {
        "depth": np.concatenate(depths),
        "conf": np.concatenate(confs),
        "intrinsics": np.concatenate(Ks),
        "extrinsics_global": np.concatenate(Es),
        "ranges": ranges,
    }
    if collect_images:
        out["images"] = np.concatenate(imgs)
    return out
