"""SLAMSolver — the in-memory streaming SLAM orchestrator (counterpart of
``da3slam_tpu/slam/solver.py``).

A frame-path deque feeds fixed-size chunks into the model; each chunk is
aligned to the global frame through the single-overlap path (scale +
registration + pose chaining); trailing frames run as a re-anchored
full-size tail window.  Alignment runs on ``device``.

With ``Model.device_resident`` the dense maps stay on the device, alignment
consumes them there, and per-chunk poses and stats stay device tensors until
one fetch at the end of the run: the loop never waits on the device.
Otherwise every chunk's prediction is fetched to numpy (and uploaded again
for alignment), as the reference does.

Loop closure and the viewer are not ported: a config or argument that
enables either is rejected.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from da3slam_tpu_torch.core.transforms import se3_inverse, se3_to_4x4
from da3slam_tpu_torch.inout.images import extract_keyframes, load_image_paths
from da3slam_tpu_torch.slam.alignment import AlignmentConfig, align_chunk_single_overlap
from da3slam_tpu_torch.utils.profiling import StageTimer


class SLAMSolver:
    def __init__(self, image_dir: str, config: dict, model: Any = None, viewer: Any = None,
                 device: str | torch.device = "cuda"):
        if viewer is not None:
            raise NotImplementedError("the viewer is not ported yet: pass viewer=None "
                                      "(main_slam --headless)")
        if (config.get("Loop", {}) or {}).get("enable", False):
            raise NotImplementedError("loop closure is not ported yet: set Loop.enable false")
        self.config = config
        self.device = torch.device(device)
        model_cfg = config.get("Model", {})
        self.chunk_size = model_cfg.get("chunk_size", 15)
        self.overlap_size = model_cfg.get("overlap_size", 1)
        self.keyframe_interval = model_cfg.get("keyframe_interval", 1)
        self.sleep_between_chunk = model_cfg.get("sleep_between_chunk", 0)
        self.prefetch = model_cfg.get("prefetch", None)
        self.device_resident = model_cfg.get("device_resident", False)
        self._prefetcher = None
        # (tag, depth_scale, fitness, rmse) device scalars awaiting the single
        # end-of-run fetch (device-resident mode)
        self._deferred_stats: List[tuple] = []
        self.image_dir = image_dir

        self.chunk_count = 0
        self.frame_buffer: deque = deque(maxlen=self.chunk_size * 2)
        self.results: List[Dict] = []  # per-chunk outputs incl. extrinsics_global
        self.prev_chunk_prediction: Optional[Dict] = None
        self.prev_overlap_aligned_3x4: Optional[torch.Tensor] = None
        self.align_config = AlignmentConfig.from_config(config)

        self.model = model if model is not None else self._load_model()
        if self.prefetch is None:
            # only the port's own model is known to take pre-decoded arrays;
            # other models (e.g. path-keyed test doubles) keep paths
            from da3slam_tpu_torch.models.da3 import DepthAnything3

            self.prefetch = isinstance(self.model, DepthAnything3)
        self.viewer = None
        self.timer = StageTimer(sync=False)

    def _load_model(self):
        from da3slam_tpu_torch.models.da3 import DepthAnything3

        model_path = self.config.get("Weights", {}).get("DA3", "small")
        print(f"Loading DA3 model from {model_path}...")
        return DepthAnything3.from_pretrained(model_path, device=self.device)

    # -- chunk plumbing ----------------------------------------------------
    def should_run_chunk_prediction(self) -> bool:
        return len(self.frame_buffer) >= self.chunk_size

    def load_chunk_image_paths(self) -> List[str]:
        return list(self.frame_buffer)[: self.chunk_size]

    def update_buffer_after_chunk_processed(self) -> None:
        if len(self.frame_buffer) > self.overlap_size:
            for _ in range(self.chunk_size - self.overlap_size):
                if self.frame_buffer:
                    self.frame_buffer.popleft()

    def run_single_chunk_prediction(self, chunk_image_paths: List[str]) -> Dict:
        if self._prefetcher is not None:
            image = self._prefetcher.get_batch(chunk_image_paths)
        else:
            image = chunk_image_paths
        kwargs = {"keep_on_device": True} if self.device_resident else {}
        pred = self.model.inference(image=image, process_res_method="upper_bound_resize",
                                    **kwargs)
        if self._prefetcher is not None:
            # this chunk's forward is queued (device-resident mode) or done:
            # start the next chunk's image upload now
            self._prefetcher.stage_next()
        dense = (lambda a: a) if self.device_resident else np.asarray
        out = {
            "chunk_idx": self.chunk_count,
            "image_paths": chunk_image_paths,
            "processed_images": dense(pred.processed_images),
            "depth": dense(pred.depth),
            "conf": dense(pred.conf),
            "extrinsics": dense(pred.extrinsics),
            "intrinsics": dense(pred.intrinsics),
        }
        fd = getattr(pred, "frame_desc", None)
        if fd is not None:
            out["frame_desc"] = dense(fd)
        return out

    # -- alignment ---------------------------------------------------------
    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def process_chunk_alignment(self, prev: Dict, cur: Dict, anchor_idx: int | None = None):
        """Scale + register + chain.  ``anchor_idx`` is the index within
        ``cur`` of the frame shared with the previous chunk's last frame:
        ``overlap_size - 1`` in the steady state, ``chunk_size - 1 - n_new``
        for the re-anchored tail window."""
        if anchor_idx is None:
            anchor_idx = self.overlap_size - 1
        out = align_chunk_single_overlap(
            prev_depth=self._dev(prev["depth"][-1]),
            prev_conf=self._dev(prev["conf"][-1]),
            prev_K=self._dev(prev["intrinsics"][-1]),
            cur_depth=self._dev(cur["depth"]),
            cur_conf=self._dev(cur["conf"]),
            cur_K=self._dev(cur["intrinsics"]),
            cur_extrinsics=self._dev(cur["extrinsics"]),
            prev_overlap_global=self._dev(self.prev_overlap_aligned_3x4),
            config=self.align_config,
            anchor_idx=anchor_idx,
        )
        if self.device_resident:
            # nothing leaves the device: stats and poses are fetched once,
            # at the end of run()
            cur["depth"] = out.depth_scaled
            self.prev_overlap_aligned_3x4 = out.prev_overlap_for_next
            cur["extrinsics_global"] = out.extrinsics_global
            return out.depth_scale, out.transform.R, out.transform.t, out.fitness, out.inlier_rmse
        cur["depth"] = out.depth_scaled.cpu().numpy()
        cur["extrinsics_global"] = out.extrinsics_global.cpu().numpy()
        self.prev_overlap_aligned_3x4 = out.prev_overlap_for_next.cpu().numpy()
        return (
            float(out.depth_scale),
            out.transform.R.cpu().numpy(),
            out.transform.t.cpu().numpy(),
            float(out.fitness),
            float(out.inlier_rmse),
        )

    def _report(self, tag: str, s, fitness, rmse) -> None:
        if isinstance(s, float):
            print(f"  {tag}: depth_scale={s:.4f} fitness={fitness:.4f} inlier_rmse={rmse:.5f}")
        else:
            # device scalars: printing them now would wait on the device
            self._deferred_stats.append((tag, s, fitness, rmse))

    def _first_chunk_globals(self, cur: Dict) -> None:
        """The first chunk defines the global frame."""
        ext = cur["extrinsics"]
        if isinstance(ext, torch.Tensor):
            cur["extrinsics_global"] = ext.to(torch.float64)
            self.prev_overlap_aligned_3x4 = ext[-1].to(torch.float32)
        else:
            cur["extrinsics_global"] = np.asarray(ext).astype(np.float64)
            self.prev_overlap_aligned_3x4 = cur["extrinsics_global"][-1].astype(np.float32)

    # -- main loop ---------------------------------------------------------
    def process_frame(self, image_path: str) -> None:
        self.frame_buffer.append(image_path)
        if not self.should_run_chunk_prediction():
            return

        chunk_paths = self.load_chunk_image_paths()
        with self.timer("inference"):
            cur = self.run_single_chunk_prediction(chunk_paths)

        if self.chunk_count == 0:
            self._first_chunk_globals(cur)
        else:
            with self.timer("align"):
                s, _R, _t, fitness, rmse = self.process_chunk_alignment(
                    self.prev_chunk_prediction, cur
                )
            self._report(f"chunk {self.chunk_count}", s, fitness, rmse)

        self.results.append({
            "chunk_idx": cur["chunk_idx"],
            "image_paths": cur["image_paths"],
            "extrinsics_global": cur["extrinsics_global"],
            "intrinsics": cur["intrinsics"],
            # leading frames duplicated from the previous chunk
            "dedup_skip": 0 if self.chunk_count == 0 else self.overlap_size,
        })
        self.prev_chunk_prediction = cur
        self.update_buffer_after_chunk_processed()
        self.chunk_count += 1
        if self.sleep_between_chunk:
            time.sleep(self.sleep_between_chunk)

    def _flush_tail(self, image_paths: List[str]) -> None:
        """Process trailing keyframes that never filled a chunk, as a
        re-anchored window of the last ``chunk_size`` frames (so every
        keyframe gets a global pose)."""
        step = self.chunk_size - self.overlap_size
        processed = 0 if self.chunk_count == 0 else self.chunk_size + (self.chunk_count - 1) * step
        n_new = len(image_paths) - processed
        if n_new <= 0:
            return

        if self.chunk_count == 0:
            # fewer frames than one chunk: run them all as chunk 0
            chunk_paths = list(image_paths)
            with self.timer("inference"):
                cur = self.run_single_chunk_prediction(chunk_paths)
            self._first_chunk_globals(cur)
            dedup_skip = 0
        else:
            # the previous chunk's last frame sits at index chunk_size - 1 - n_new
            chunk_paths = list(image_paths[-self.chunk_size:])
            with self.timer("inference"):
                cur = self.run_single_chunk_prediction(chunk_paths)
            with self.timer("align"):
                s, _R, _t, fitness, rmse = self.process_chunk_alignment(
                    self.prev_chunk_prediction, cur, anchor_idx=self.chunk_size - 1 - n_new
                )
            self._report(f"tail chunk ({n_new} new frames)", s, fitness, rmse)
            dedup_skip = self.chunk_size - n_new

        self.results.append({
            "chunk_idx": self.chunk_count,
            "image_paths": chunk_paths,
            "extrinsics_global": cur["extrinsics_global"],
            "intrinsics": cur["intrinsics"],
            "dedup_skip": dedup_skip,
        })
        self.prev_chunk_prediction = cur
        self.frame_buffer.clear()
        self.chunk_count += 1

    def _materialize(self) -> None:
        """End of run: one device→host transfer for every deferred stat and
        every chunk's global poses + intrinsics (device-resident mode)."""
        if self._deferred_stats:
            vals = torch.stack([
                torch.stack([s.float(), f.float(), r.float()])
                for _, s, f, r in self._deferred_stats
            ]).cpu().numpy()
            for (tag, *_), (s, f, r) in zip(self._deferred_stats, vals):
                print(f"  {tag}: depth_scale={s:.4f} fitness={f:.4f} inlier_rmse={r:.5f}")
            self._deferred_stats.clear()
        for r in self.results:
            for key in ("extrinsics_global", "intrinsics"):
                if isinstance(r[key], torch.Tensor):
                    r[key] = r[key].cpu().numpy()

    def run(self) -> None:
        image_paths = load_image_paths(self.image_dir)
        if not image_paths:
            print(f"Warning: No images found in {self.image_dir}")
            return
        image_paths = extract_keyframes(image_paths, self.keyframe_interval)
        print(f"Running SLAM over {len(image_paths)} keyframes "
              f"(chunk_size={self.chunk_size}, overlap={self.overlap_size})")
        if self.prefetch:
            from da3slam_tpu_torch.inout.prefetch import ImagePrefetcher
            from da3slam_tpu_torch.slam.chunks import make_chunk_indices

            # the chunk partition is known upfront (steady windows, then the
            # re-anchored tail), so the prefetcher can stage each chunk's
            # upload ahead of its dispatch
            stage = [image_paths[a:b] for a, b in
                     make_chunk_indices(len(image_paths), self.chunk_size, self.overlap_size)]
            self._prefetcher = ImagePrefetcher(
                image_paths, lookahead=2 * self.chunk_size, stage_chunks=stage,
                device=self.model.device,
            )
        try:
            for img_path in image_paths:
                self.process_frame(img_path)
            self._flush_tail(image_paths)
            self._materialize()
        finally:
            if self._prefetcher is not None:
                self._prefetcher.close()
                self._prefetcher = None
        print("SLAM process completed")
        if self.timer.totals:
            print("per-stage timing:\n" + self.timer.report())

    # -- export ------------------------------------------------------------
    def trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """Global (c2w) poses + intrinsics for every processed frame,
        deduplicating overlap frames between consecutive chunks."""
        poses, intrs = [], []
        for k, res in enumerate(self.results):
            start = res.get("dedup_skip", 0 if k == 0 else self.overlap_size)
            for i in range(start, len(res["image_paths"])):
                w2c = torch.as_tensor(np.asarray(res["extrinsics_global"][i]), dtype=torch.float32)
                poses.append(se3_to_4x4(se3_inverse(w2c)).numpy())
                intrs.append(np.asarray(res["intrinsics"][i]))
        return np.stack(poses), np.stack(intrs)
