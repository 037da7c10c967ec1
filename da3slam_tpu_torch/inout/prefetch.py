"""Background image decoding and device staging for the SLAM loop
(counterpart of ``da3slam_tpu/inout/prefetch.py:ImagePrefetcher``).

Worker threads walk the frame list ahead of the consumer, decoding into a
bounded cache, so image decode overlaps the previous chunk's device work
(PIL's decode releases the GIL).

Device staging: when the consumer's chunk partition is known upfront
(``stage_chunks``), ``stage_next()``, which the consumer calls right after it
has queued a chunk's device work, stacks the next decoded chunk into pinned
host memory and starts its upload on a side CUDA stream, so the transfer
runs under that compute.  ``get_batch`` then hands out the device tensor
after making the consumer's stream wait for the copy's event.  With a CPU
``device`` staging stacks the frames and uploads nothing.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from da3slam_tpu_torch.inout.images import decode_image
from da3slam_tpu_torch.utils.profiling import span


def _decode(path: str) -> np.ndarray:
    with span("ingest.decode"):
        return decode_image(path)


def upload_pinned(frames, device: torch.device, stream: "torch.cuda.Stream"):
    """Stack ``frames`` (a list of equal ``[H, W, 3]`` uint8 arrays, or one
    ``[N, H, W, 3]`` array) into pinned host memory and start the upload on the
    side stream ``stream``.  Returns ``(device tensor, copy-done event)``;
    :func:`claim_upload` makes a consumer's stream wait for the event."""
    first = frames[0]
    host = torch.empty((len(frames), *first.shape), dtype=torch.uint8, pin_memory=True)
    if isinstance(frames, np.ndarray):
        np.copyto(host.numpy(), frames)
    else:
        np.stack(frames, out=host.numpy())
    with torch.cuda.stream(stream):
        batch = host.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return batch, done


def claim_upload(batch: torch.Tensor, done, device: torch.device) -> torch.Tensor:
    """Make the current stream of ``device`` wait for an upload that
    :func:`upload_pinned` started, and hand the tensor to that stream."""
    consumer = torch.cuda.current_stream(device)
    consumer.wait_event(done)
    batch.record_stream(consumer)  # allocated on the side stream
    return batch


class ImagePrefetcher:
    def __init__(
        self,
        paths: list[str],
        lookahead: int = 32,
        workers: int = 4,
        stage_chunks: list[list[str]] | None = None,
        stage_ahead: int = 2,
        device: str | torch.device = "cpu",
    ):
        self.paths = list(paths)
        self._index = {p: i for i, p in enumerate(self.paths)}
        self.lookahead = lookahead
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._cursor = 0  # consumer position (frames before it may be evicted)
        self._next = 0  # next index a worker will claim
        self._pending: set[int] = set()  # claimed, decode in flight
        self._cond = threading.Condition()
        self._stop = False
        # staging runs on the caller's thread: stage_next() is called when the
        # device queue is already full, so the copy overlaps without a thread
        self.stage_ahead = stage_ahead
        self.device = torch.device(device)
        self._stage_chunks = [list(c) for c in stage_chunks] if stage_chunks else None
        self._stage_keys = {tuple(c): k for k, c in enumerate(self._stage_chunks or [])}
        self._staged: dict[tuple, tuple] = {}  # chunk -> (batch, copy-done event or None)
        self._stage_pos = 0  # next partition index stage_next() will upload
        self._copy_stream = None  # the side stream, made at the first CUDA upload
        self._threads = [
            threading.Thread(target=self._worker, daemon=True) for _ in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._stop and (
                    self._next >= len(self.paths)
                    or self._next - self._cursor >= self.lookahead
                ):
                    if self._next >= len(self.paths):
                        return
                    self._cond.wait(timeout=0.2)
                if self._stop:
                    return
                i = self._next
                self._next = i + 1
                self._pending.add(i)
                path = self.paths[i]
            frame = _decode(path)
            with self._cond:
                self._cache[path] = frame
                self._pending.discard(i)
                self._cond.notify_all()

    def _wait_for_frame(self, path: str) -> np.ndarray:
        """The decoded frame: waits for a worker when the frame is inside the
        prefetch window, decodes inline otherwise.  Never evicts."""
        idx = self._index.get(path, -1)
        with self._cond:
            frame = self._cache.get(path)
            # a worker will produce idx iff it is unclaimed inside the
            # lookahead window, or its decode is in flight
            while (
                frame is None
                and not self._stop
                and (self._next <= idx < self._cursor + self.lookahead
                     or idx in self._pending)
                and any(t.is_alive() for t in self._threads)
            ):
                self._cond.wait(timeout=0.1)
                frame = self._cache.get(path)
        return frame if frame is not None else _decode(path)

    def _stage_chunk(self, pos: int):
        """Stack partition chunk ``pos`` (waiting on its decodes) and start its
        upload; returns the stacked array (CPU) or the uploading device tensor."""
        chunk = self._stage_chunks[pos]
        frames = [self._wait_for_frame(p) for p in chunk]
        if self.device.type != "cuda":
            batch, done = np.stack(frames), None
        else:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            batch, done = upload_pinned(frames, self.device, self._copy_stream)
        self._staged[tuple(chunk)] = (batch, done)
        return batch

    def stage_next(self) -> bool:
        """Upload the next not-yet-staged partition chunk (caller's thread).

        The SLAM solver calls this right after queuing a chunk's forward: the
        upload of the next chunk's images then runs beside that compute.
        Keeps at most ``stage_ahead`` chunks resident beyond the consumer.
        Returns False when the partition is exhausted or staging is off.
        """
        if self._stage_chunks is None or self._stage_pos >= len(self._stage_chunks):
            return False
        if len(self._staged) >= self.stage_ahead:
            return False
        self._stage_chunk(self._stage_pos)
        self._stage_pos += 1
        return True

    def _consumed(self, paths: list[str]) -> None:
        """Advance the cursor and evict the consumed frames (the overlap
        frame stays cached)."""
        with self._cond:
            self._cursor = max(self._cursor, self._index.get(paths[-1], -1))
            for p in paths[:-1]:
                self._cache.pop(p, None)
            self._cond.notify_all()

    def get_batch(self, paths: list[str]):
        """Decoded ``[N, H, W, 3]`` uint8 frames.  A chunk of the staging
        partition comes back as staged: on CUDA the device tensor whose
        upload began up to ``stage_ahead`` chunks ago, the current stream
        made to wait for that copy.  Any other batch is a numpy array."""
        with span("ingest.get_batch", frames=len(paths)):
            return self._get_batch(paths)

    def _get_batch(self, paths: list[str]):
        key = tuple(paths)
        pos = self._stage_keys.get(key)
        if pos is None:
            out = np.stack([self._wait_for_frame(p) for p in paths])
            self._consumed(paths)
            return out
        if key not in self._staged:
            # not staged ahead (the first chunk, or the consumer outran
            # stage_next): stack and upload it now
            self._stage_chunk(pos)
        batch, done = self._staged.pop(key)
        self._stage_pos = max(self._stage_pos, pos + 1)
        if done is not None:
            claim_upload(batch, done, self.device)
        self._consumed(paths)
        return batch

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=1.0)
        self._staged.clear()
