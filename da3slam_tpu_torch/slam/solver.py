"""SLAMSolver — the in-memory streaming SLAM orchestrator (counterpart of
``da3slam_tpu/slam/solver.py``).

A frame-path deque feeds fixed-size chunks into the model; each chunk is
aligned to the global frame through the single-overlap path (scale +
registration + pose chaining); trailing frames run as a re-anchored
full-size tail window.  Alignment runs on ``device``.

With ``Model.device_resident`` the dense maps stay on the device, alignment
consumes them there, and per-chunk poses and stats stay device tensors until
one packed fetch at the end of the run (``_materialize``).  Measured on an
H100 over 31 frames (``chip_smoke.py``, ``solver_split``): with ICP the loop
makes the host wait 0 times and the fetch once; IRLS adds 20 waits, all at
``torch.linalg.svd`` in ``ops/registration.py``.  The one wait-heavy part is
outside the loop: building the model moves each parameter tensor to the
device with a blocking copy (249 for SMALL).  Otherwise every chunk's
prediction is fetched to numpy (and uploaded again for alignment), as the
reference does, apart from the registration's R and t, which nothing reads
and which stay on the device.  The mode is read at each step
(``device_resident``, and whether a loop closer runs), never from the type
of a value: in device-resident mode every dense field of a prediction is a
tensor on ``device``.

``Loop.enable`` adds online loop closure (``slam/online_loop.py``): each
chunk is enrolled for retrieval, and a gated loop edge re-anchors the
trajectory so far through the pose graph.  It consumes host poses and
descriptors every chunk, so device-resident mode then fetches them (with the
chunk's stats, once aligned) in one packed transfer a chunk.

``viewer="auto"`` (the default, as in the JAX package) opens a
``viz/viewer.py:SLAMViewer`` on ``Model.port``, or runs headless with a
message where ``viser`` is missing; ``viewer=None`` is headless, and any
other object is used as the viewer.  Each chunk's new frames (the overlap
with the previous chunk skipped) go to it as one batch on the solver's
device: backprojected, strided and masked where the chunk lives, then one
device→host transfer (``SLAMViewer.add_frames``).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from da3slam_tpu_torch.core.transforms import se3_inverse, se3_to_4x4
from da3slam_tpu_torch.inout.images import extract_keyframes, load_image_paths
from da3slam_tpu_torch.slam.alignment import AlignmentConfig, align_chunk_single_overlap
from da3slam_tpu_torch.utils.profiling import StageTimer, nbytes, span
from da3slam_tpu_torch.utils.transfer import fetch_packed


class SLAMSolver:
    # each solver's number: a chunk's spans carry (serial, chunk index)
    _serials = itertools.count()

    def __init__(self, image_dir: str, config: dict, model: Any = None, viewer: Any = "auto",
                 device: str | torch.device = "cuda"):
        self.config = config
        self.serial = next(SLAMSolver._serials)
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
            # a model that says it takes pre-decoded arrays (the port's own)
            # gets them; others (e.g. path-keyed test doubles) keep paths
            self.prefetch = bool(getattr(self.model, "takes_arrays", False))
        self.viewer = self._init_viewer() if viewer == "auto" else viewer

        # optional online loop closure (off by default; slam/online_loop.py)
        self.loop_closer = None
        loop_cfg = config.get("Loop", {}) or {}
        if loop_cfg.get("enable", False):
            from da3slam_tpu_torch.slam.online_loop import OnlineLoopCloser

            self.loop_closer = OnlineLoopCloser(
                self.model, loop_cfg,
                inference_kwargs={"process_res_method": "upper_bound_resize"},
                device=self.device,
            )
        self.timer = StageTimer(sync=False)

    def _load_model(self):
        """The model ``Weights.DA3`` names (``models.load_model``)."""
        from da3slam_tpu_torch.models import load_model

        return load_model(self.config.get("Weights", {}).get("DA3", "small"), device=self.device)

    def _init_viewer(self):
        port = self.config.get("Model", {}).get("port", 8080)
        try:
            from da3slam_tpu_torch.viz.viewer import SLAMViewer

            viewer = SLAMViewer(port=port, device=self.device)
            print(f"Viewer initialized on port {port}")
            return viewer
        except ImportError as e:
            print(f"Viewer unavailable ({e}); running headless")
            return None

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
        fields = {k: getattr(pred, k) for k in
                  ("processed_images", "depth", "conf", "extrinsics", "intrinsics")}
        fd = getattr(pred, "frame_desc", None)
        if fd is not None:
            fields["frame_desc"] = fd
        if self.device_resident:
            # the port's models keep their fields on the device already; a
            # host-only double (utils/synthetic.py) gets its one upload here
            fields = {k: torch.as_tensor(a, device=self.device) for k, a in fields.items()}
        return {"chunk_idx": self.chunk_count, "image_paths": chunk_image_paths, **fields}

    @property
    def _defers(self) -> bool:
        """Device-resident without a loop closer: a chunk's stats, poses and
        intrinsics stay on the device until ``_materialize``."""
        return self.device_resident and self.loop_closer is None

    # -- alignment ---------------------------------------------------------
    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def process_chunk_alignment(self, prev: Dict, cur: Dict, anchor_idx: int | None = None):
        """Scale + register + chain.  ``anchor_idx`` is the index within
        ``cur`` of the frame shared with the previous chunk's last frame:
        ``overlap_size - 1`` in the steady state, ``chunk_size - 1 - n_new``
        for the re-anchored tail window.  Returns ``(depth_scale, fitness,
        inlier_rmse)``: floats, or device scalars where the mode defers."""
        if anchor_idx is None:
            anchor_idx = self.overlap_size - 1
        host = {"prev_depth": prev["depth"][-1], "prev_conf": prev["conf"][-1],
                "prev_K": prev["intrinsics"][-1], "cur_depth": cur["depth"],
                "cur_conf": cur["conf"], "cur_K": cur["intrinsics"],
                "cur_extrinsics": cur["extrinsics"],
                "prev_overlap_global": self.prev_overlap_aligned_3x4}
        with span("align.upload") as attrs:
            inputs = {k: self._dev(a) for k, a in host.items()}
            # what crossed: the inputs that were not already device tensors
            attrs["bytes"] = nbytes(*(t for k, t in inputs.items() if t is not host[k]))
        out = align_chunk_single_overlap(**inputs, config=self.align_config,
                                         anchor_idx=anchor_idx)
        held = (out.depth_scaled, out.extrinsics_global, out.prev_overlap_for_next)
        stats = (out.depth_scale, out.fitness, out.inlier_rmse)
        if not self.device_resident:
            with span("align.fetch", bytes=nbytes(*held, *stats)):
                self._hold(cur, *(t.cpu().numpy() for t in held))
                return tuple(float(x) for x in stats)
        self._hold(cur, *held)
        if self._defers:
            # nothing leaves the device: stats and poses are fetched once,
            # at the end of run()
            return stats
        with span("align.fetch") as attrs:
            return self._fetch_for_loop(cur, attrs, *stats)

    def _hold(self, cur: Dict, depth, extrinsics_global, carry) -> None:
        """Keep an aligned chunk's scaled depth and global poses, and the
        carry: the global pose of the frame the next chunk chains from."""
        cur["depth"], cur["extrinsics_global"] = depth, extrinsics_global
        self.prev_overlap_aligned_3x4 = carry

    def _fetch_for_loop(self, cur: Dict, attrs: Dict, *stats) -> tuple:
        """Device-resident with a loop closer, which reads a chunk's global
        poses and descriptors on the host: those and ``stats`` in ONE packed
        transfer (its bytes into ``attrs``).  Returns the stats as floats."""
        fd = cur.get("frame_desc")
        fetched = [cur["extrinsics_global"], *stats] + ([] if fd is None else [fd])
        attrs["bytes"] = 8 * sum(t.numel() for t in fetched)  # one f64 buffer
        cur["extrinsics_global"], *host = fetch_packed(fetched)
        if fd is not None:
            cur["frame_desc"] = host.pop()
        return tuple(float(x) for x in host)

    def _report(self, tag: str, s, fitness, rmse) -> None:
        if self._defers:
            # device scalars: printing them now would wait on the device
            self._deferred_stats.append((tag, s, fitness, rmse))
        else:
            print(f"  {tag}: depth_scale={s:.4f} fitness={fitness:.4f} inlier_rmse={rmse:.5f}")

    def _first_chunk_globals(self, cur: Dict) -> None:
        """The first chunk defines the global frame."""
        ext = cur["extrinsics"]
        if not self.device_resident:
            cur["extrinsics_global"] = ext.astype(np.float64)
            self.prev_overlap_aligned_3x4 = cur["extrinsics_global"][-1].astype(np.float32)
            return
        cur["extrinsics_global"] = ext.to(torch.float64)
        self.prev_overlap_aligned_3x4 = ext[-1].to(torch.float32)
        if self.loop_closer is not None:
            self._fetch_for_loop(cur, {})

    # -- online loop closure -------------------------------------------------
    def _loop_stage(self, cur: Dict, new_start: int, depth_scale: float) -> None:
        """Enroll the chunk, detect/gate loops, and on a new gated edge
        re-anchor the whole trajectory so far from the optimised pose graph.
        The carry (the previous overlap frame's global pose) is re-anchored
        too, so every later chunk chains from the corrected trajectory."""
        self.loop_closer.add_chunk(cur, new_start, frame_desc=cur.get("frame_desc"),
                                   depth_scale=depth_scale)
        updated = self.loop_closer.maybe_close([r["extrinsics_global"] for r in self.results])
        if updated is None:
            return
        for r, E in zip(self.results, updated):
            r["extrinsics_global"] = E
        cur["extrinsics_global"] = updated[-1]
        self.prev_overlap_aligned_3x4 = np.asarray(updated[-1][-1], np.float32)
        print(f"  [loop] trajectory re-anchored over {len(updated)} chunks")

    # -- viewer ------------------------------------------------------------
    def update_viewer(self, chunk_prediction: Dict, start: int = 0) -> None:
        """Send the chunk's frames from ``start`` on (the overlap with the
        previous chunk is skipped) with their global poses, as one batch:
        the viewer's geometry runs where the chunk lives and costs one
        device→host transfer."""
        if self.viewer is None:
            return
        ext_global = chunk_prediction.get("extrinsics_global")
        if ext_global is None:
            print("warn: no extrinsics_global; falling back to local extrinsics")
            ext_global = chunk_prediction["extrinsics"]
        n = len(chunk_prediction["image_paths"])
        if start >= n:
            return
        self.viewer.add_frames(
            images=chunk_prediction["processed_images"][start:n],
            depth=chunk_prediction["depth"][start:n],
            conf=chunk_prediction["conf"][start:n],
            extrinsics=ext_global[start:n],
            intrinsics=chunk_prediction["intrinsics"][start:n],
        )

    # -- main loop ---------------------------------------------------------
    def _process_chunk(self, paths: List[str], anchor_idx: int | None, dedup_skip: int,
                       tag: str) -> None:
        """One chunk, a steady or a tail window: inference; the first chunk's
        globals or the alignment to the previous chunk; the loop stage and
        the viewer.  ``dedup_skip``: the leading frames the previous chunk
        already holds."""
        with span("chunk", chunk=(self.serial, self.chunk_count)):
            with self.timer("inference"):
                cur = self.run_single_chunk_prediction(paths)
            depth_scale = 1.0
            if self.chunk_count == 0:
                self._first_chunk_globals(cur)
            else:
                with self.timer("align"):
                    depth_scale, fitness, rmse = self.process_chunk_alignment(
                        self.prev_chunk_prediction, cur, anchor_idx)
                self._report(tag, depth_scale, fitness, rmse)
            self.results.append({
                "chunk_idx": self.chunk_count,
                "image_paths": paths,
                "extrinsics_global": cur["extrinsics_global"],
                "intrinsics": cur["intrinsics"],
                "dedup_skip": dedup_skip,
            })
            if self.loop_closer is not None:
                with self.timer("loop"):
                    self._loop_stage(cur, dedup_skip, depth_scale)
            with self.timer("viewer"):
                self.update_viewer(cur, start=dedup_skip)
            self.prev_chunk_prediction = cur
            self.chunk_count += 1

    def process_frame(self, image_path: str) -> None:
        self.frame_buffer.append(image_path)
        if not self.should_run_chunk_prediction():
            return
        self._process_chunk(self.load_chunk_image_paths(), None,
                            0 if self.chunk_count == 0 else self.overlap_size,
                            f"chunk {self.chunk_count}")
        self.update_buffer_after_chunk_processed()
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
        tag = f"tail chunk ({n_new} new frames)"
        if self.chunk_count == 0:
            # fewer frames than one chunk: run them all as chunk 0
            self._process_chunk(list(image_paths), None, 0, tag)
        else:
            # the previous chunk's last frame sits at index chunk_size - 1 - n_new
            self._process_chunk(list(image_paths[-self.chunk_size:]), self.chunk_size - 1 - n_new,
                                self.chunk_size - n_new, tag)
        self.frame_buffer.clear()

    def _materialize(self) -> None:
        """End of run (device-resident mode): every deferred stat and what
        the results still hold on the device (the intrinsics, and the global
        poses where no loop closer fetched them a chunk) in ONE device→host
        transfer (``fetch_packed``: each array comes back bit for bit in its
        dtype)."""
        if not self.device_resident:
            return
        keys = ("extrinsics_global", "intrinsics") if self._defers else ("intrinsics",)
        stats = [x.float() for _, s, f, r in self._deferred_stats for x in (s, f, r)]
        slots = [(r, key) for r in self.results for key in keys]
        tensors = stats + [r[key] for r, key in slots]
        if not tensors:
            return
        parts = fetch_packed(tensors)
        for i, (tag, *_) in enumerate(self._deferred_stats):
            s, f, r = (p.item() for p in parts[3 * i: 3 * i + 3])
            print(f"  {tag}: depth_scale={s:.4f} fitness={f:.4f} inlier_rmse={r:.5f}")
        self._deferred_stats.clear()
        for (r, key), arr in zip(slots, parts[len(stats):]):
            r[key] = arr

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
            print("per-stage host time (enqueue and waits, not device time):\n"
                  + self.timer.report())

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
