"""Background image decoding for the SLAM loop (counterpart of
``da3slam_tpu/inout/prefetch.py:ImagePrefetcher`` without device staging).

Worker threads walk the frame list ahead of the consumer, decoding into a
bounded cache, so image decode overlaps the previous chunk's device work
(PIL's decode releases the GIL).  Staging the next chunk's upload on a side
CUDA stream is not ported yet.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from da3slam_tpu_torch.inout.images import decode_image


class ImagePrefetcher:
    def __init__(self, paths: list[str], lookahead: int = 32, workers: int = 4):
        self.paths = list(paths)
        self._index = {p: i for i, p in enumerate(self.paths)}
        self.lookahead = lookahead
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._cursor = 0  # consumer position (frames before it may be evicted)
        self._next = 0  # next index a worker will claim
        self._pending: set[int] = set()  # claimed, decode in flight
        self._cond = threading.Condition()
        self._stop = False
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
            frame = decode_image(path)
            with self._cond:
                self._cache[path] = frame
                self._pending.discard(i)
                self._cond.notify_all()

    def get_batch(self, paths: list[str]) -> np.ndarray:
        """Decoded ``[N, H, W, 3]`` uint8 frames: waits for a worker when the
        frame is inside the prefetch window, decodes inline otherwise."""
        out = []
        for p in paths:
            idx = self._index.get(p, -1)
            with self._cond:
                frame = self._cache.get(p)
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
                    frame = self._cache.get(p)
            out.append(frame if frame is not None else decode_image(p))
        with self._cond:
            self._cursor = max(self._cursor, self._index.get(paths[-1], -1))
            for p in paths[:-1]:  # keep the overlap frame cached
                self._cache.pop(p, None)
            self._cond.notify_all()
        return np.stack(out)

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=1.0)
