"""Long-sequence disk-spilling streaming SLAM (counterpart of
``da3slam_tpu/slam/streaming.py``).

Two passes:

PASS 1 — per chunk: model inference (conf shifted by −1.0), spill the
prediction to ``_tmp_results_unaligned/chunk_<i>.npz`` (with ``resume`` the
spill doubles as a checkpoint), and estimate the chunk-to-previous Sim(3) from
the world-coordinate overlap point maps with confidence-weighted IRLS
(threshold = 0.1 · min of the two conf medians).

(optionally) LOOP CLOSURE — appearance retrieval over the frames → joint
re-inference of loop chunk pairs → gated Sim(3) constraints → pose-graph LM.

PASS 2 — accumulate the Sim(3)s to the chunk-0 frame, re-load each chunk,
apply its accumulated transform, write the aligned npz and a confident
point-cloud PLY (threshold = mean·coef, sampled), then export
``camera_poses.txt`` / ``intrinsic.txt`` / ``camera_poses.ply`` (and the
TUM/KITTI files asked for) and the merged cloud; with ``Model.export_mesh``
also ``scene_mesh.ply``, every chunk TSDF-fused into one grid.

The registrations, the pose graph, the point maps and the TSDF fusion run on
``device``; the spills, PLYs, trajectory files and the mesh extraction are
numpy on the host.
"""

from __future__ import annotations

import shutil
import warnings
from pathlib import Path

import numpy as np
import torch

from da3slam_tpu_torch.core.geometry import backproject_depth, median
from da3slam_tpu_torch.core.transforms import (
    Sim3,
    highest_precision,
    sim3_accumulate,
    sim3_apply,
    sim3_to_matrix,
)
from da3slam_tpu_torch.inout.images import load_image_paths
from da3slam_tpu_torch.inout.ply import merge_ply_files, write_ply
from da3slam_tpu_torch.inout.trajectory import save_camera_poses, validate_extra_formats
from da3slam_tpu_torch.ops.posegraph import add_loop_edges, optimize_sim3_pose_graph, sequential_edges
from da3slam_tpu_torch.ops.registration import irls_sim3
from da3slam_tpu_torch.slam.chunks import make_chunk_indices
from da3slam_tpu_torch.slam.loop import (
    LoopDetector,
    gate_loop_constraint,
    loop_sim3_from_joint_prediction,
)


class DA3Streaming:
    def __init__(self, image_dir: str, save_dir: str, config: dict, model=None,
                 device: str | torch.device = "cuda"):
        self.image_dir = image_dir
        self.output_dir = Path(save_dir)
        self.device = torch.device(device)
        mcfg = config.get("Model", {})
        self.chunk_size = mcfg.get("chunk_size", 16)
        self.overlap = mcfg.get("overlap", mcfg.get("overlap_size", 4))
        self.overlap_s = self.overlap // 2
        self.overlap_e = self.overlap - self.overlap_s
        self.loop_enable = config.get("Loop", {}).get("enable", mcfg.get("loop_enable", False))
        # the joint loop re-inference may use fewer frames a chunk to bound
        # the 2-chunk attention cost
        self.loop_chunk_size = mcfg.get("loop_chunk_size", self.chunk_size)
        self.delete_temp_files = mcfg.get("delete_temp_files", True)
        self.resume = mcfg.get("resume", False)
        # per-frame npz export of image/depth/conf/intrinsics
        self.save_depth_conf_result = mcfg.get("save_depth_conf_result", False)
        # the raw and accumulated Sim(3) chains, for offline debugging
        self.save_debug_info = mcfg.get("save_debug_info", False)
        # "tum" / "kitti" beside camera_poses.txt, checked here so a typo
        # fails before the run
        self.traj_formats = validate_extra_formats(mcfg.get("traj_formats", ()) or ())
        # the TSDF mesh beside combined_pcd.ply (ops/tsdf.py + inout/mesh.py)
        self.export_mesh = mcfg.get("export_mesh", False)
        self.mesh_resolution = mcfg.get("mesh_resolution", 192)
        # block-sparse band-only fusion; False takes the dense every-voxel
        # update (which also carves free space in front of surfaces)
        self.mesh_sparse = mcfg.get("mesh_sparse", True)
        # free-space carving of occupied blocks on the sparse path, so
        # spurious early surfaces contradicted by later chunks get erased
        self.mesh_carve = mcfg.get("mesh_carve", False)
        self._mesh_bounds: list = []
        # the sparse fusion's block budget shared by every chunk, set from
        # the first chunk's true counts (saves the later chunks' counting pass)
        self._mesh_block_budget: int | None = None
        pcfg = config.get("Pointcloud_Save", mcfg.get("Pointcloud_Save", {})) or {}
        self.conf_threshold_coef = pcfg.get("conf_threshold_coef", 1.0)
        self.sample_ratio = pcfg.get("sample_ratio", 0.3)
        icfg = config.get("IRLS", {}) or {}
        self.irls_delta = icfg.get("delta", 0.1)
        self.irls_iters = icfg.get("max_iters", 5)
        self.irls_tol = icfg.get("tol")  # convergence early exit; None = fixed count
        loop_cfg = config.get("Loop", {}) or {}
        lcfg = loop_cfg.get("SIM3_Optimizer", {}) or {}
        self.loop_max_iterations = lcfg.get("max_iterations", 30)
        self.loop_lambda_init = lcfg.get("lambda_init", 1e-6)
        self.loop_huber_delta = lcfg.get("huber_delta", 0.1)
        # loop edges weigh less than odometry and must pass the quality gate
        # before entering the graph
        self.loop_edge_weight = loop_cfg.get("edge_weight", 0.5)
        gcfg = loop_cfg.get("Gate", {}) or {}
        self.loop_max_rmse = gcfg.get("max_rmse", 0.05)
        self.loop_min_n_effective = gcfg.get("min_n_effective", 200)
        self.loop_max_reciprocal_err = gcfg.get("max_reciprocal_err", 0.1)

        self.result_unaligned_dir = self.output_dir / "_tmp_results_unaligned"
        self.result_aligned_dir = self.output_dir / "_tmp_results_aligned"
        self.result_loop_dir = self.output_dir / "_tmp_results_loop"
        self.pcd_dir = self.output_dir / "pcd"
        for d in (self.result_unaligned_dir, self.result_aligned_dir,
                  self.result_loop_dir, self.pcd_dir):
            d.mkdir(parents=True, exist_ok=True)

        if model is None:
            from da3slam_tpu_torch.models.da3 import DepthAnything3

            model = DepthAnything3.from_pretrained(config.get("Weights", {}).get("DA3", "small"),
                                                   device=self.device)
        self.model = model
        self.process_res = mcfg.get("process_res", 504)
        self.ref_view_strategy = mcfg.get("ref_view_strategy", "first")
        self.ref_view_strategy_loop = mcfg.get("ref_view_strategy_loop", "middle")

        self.img_list: list[str] = []
        self.chunk_ranges: list[tuple[int, int]] = []
        self.sim3_list: list[Sim3] = []  # entry k: chunk k+1 coords → chunk k, on device
        self.all_camera_poses: list[tuple[tuple[int, int], np.ndarray]] = []
        self.all_camera_intrinsics: list[np.ndarray] = []
        rcfg = config.get("Loop", {}).get("Retrieval", {}) or {}
        # learned descriptors are batch-centred at detection, so the threshold
        # is on the frame-distinctive part; the geometric gate rejects false
        # positives downstream
        self.loop_detector = LoopDetector(
            threshold=rcfg.get("threshold", 0.92),
            min_gap=rcfg.get("min_gap", 30),
            max_loops=rcfg.get("max_loops", 10),
            device=self.device,
        ) if self.loop_enable else None
        self.loop_edges: list[tuple[int, int, Sim3]] = []
        # every estimated constraint: (a, b, similarity, LoopConstraint, accepted)
        self.loop_attempts: list[tuple] = []
        self.n_pose_filled = 0

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # -- pass 1 ------------------------------------------------------------
    def process_single_chunk(self, chunk_range: tuple[int, int], chunk_idx: int) -> dict:
        spill = self.result_unaligned_dir / f"chunk_{chunk_idx}.npz"
        if self.resume and spill.exists():
            chunk = dict(np.load(spill))
            self.all_camera_poses.append((chunk_range, chunk["extrinsics"]))
            self.all_camera_intrinsics.append(chunk["intrinsics"])
            self._feed_loop_detector(chunk)
            return chunk
        paths = self.img_list[chunk_range[0]: chunk_range[1]]
        pred = self.model.inference(image=paths, process_res=self.process_res,
                                    ref_view_strategy=self.ref_view_strategy)
        chunk = {
            "depth": np.squeeze(np.asarray(pred.depth)),
            "conf": np.asarray(pred.conf) - 1.0,  # shifted like the reference
            "extrinsics": np.asarray(pred.extrinsics),
            "intrinsics": np.asarray(pred.intrinsics),
            "images": np.asarray(pred.processed_images),
        }
        if getattr(pred, "frame_desc", None) is not None:
            chunk["frame_desc"] = np.asarray(pred.frame_desc, np.float32)
        np.savez(spill, **chunk)
        if self.save_depth_conf_result:
            frame_dir = self.output_dir / "frames"
            frame_dir.mkdir(exist_ok=True)
            for i, idx in enumerate(range(chunk_range[0], chunk_range[1])):
                np.savez(frame_dir / f"frame_{idx:06d}.npz",
                         image=chunk["images"][i], depth=chunk["depth"][i],
                         conf=chunk["conf"][i], intrinsics=chunk["intrinsics"][i])
        self.all_camera_poses.append((chunk_range, chunk["extrinsics"]))
        self.all_camera_intrinsics.append(chunk["intrinsics"])
        self._feed_loop_detector(chunk)
        return chunk

    def _feed_loop_detector(self, chunk: dict) -> None:
        if self.loop_detector is None:
            return
        # the model's learned descriptors when the chunk has them, else
        # thumbnails.  A detector that holds thumbnails stays on them (a
        # resumed run over spills without descriptors must not switch kinds);
        # one that holds learned descriptors enrolls zero vectors for a chunk
        # without them (they match nothing but keep frame indices aligned).
        descs = chunk.get("frame_desc")
        if self.loop_detector.kind == "thumbnail":
            descs = None
        elif self.loop_detector.kind == "learned" and descs is None:
            n_frames = len(chunk["images"][: self.chunk_size - self.overlap])
            descs = np.zeros((n_frames, self.loop_detector.dim), np.float32)
        n = self.chunk_size - self.overlap
        for i, img in enumerate(chunk["images"][:n]):
            self.loop_detector.add_frame(img, desc=None if descs is None else descs[i])

    def load_chunk(self, chunk_idx: int, aligned: bool = False) -> dict:
        d = self.result_aligned_dir if aligned else self.result_unaligned_dir
        return dict(np.load(d / f"chunk_{chunk_idx}.npz"))

    @highest_precision()
    def align_2pcds(self, prev: dict, cur: dict, overlap: int | None = None) -> Sim3:
        """Confidence-weighted Sim(3) from the world-coordinate overlap point
        maps.  Returns cur→prev.  ``overlap`` is the actual number of shared
        frames (the re-anchored tail chunk shares more than ``self.overlap``
        with its predecessor, and pairing must stay on the same frames)."""
        o = self.overlap if overlap is None else overlap
        T = self._dev
        pts_prev = backproject_depth(T(prev["depth"][-o:]), T(prev["intrinsics"][-o:]),
                                     T(prev["extrinsics"][-o:])).reshape(-1, 3)
        pts_cur = backproject_depth(T(cur["depth"][:o]), T(cur["intrinsics"][:o]),
                                    T(cur["extrinsics"][:o])).reshape(-1, 3)
        c_prev = T(prev["conf"][-o:]).reshape(-1)
        c_cur = T(cur["conf"][:o]).reshape(-1)
        conf = torch.sqrt(c_prev.clamp_min(0) * c_cur.clamp_min(0))
        threshold = 0.1 * torch.minimum(median(c_prev), median(c_cur))
        conf = torch.where((c_prev > threshold) & (c_cur > threshold), conf,
                           torch.zeros_like(conf))
        res = irls_sim3(pts_cur, pts_prev, conf=conf, delta=self.irls_delta,
                        max_iters=self.irls_iters, tol=self.irls_tol)
        s, rmse, n_eff = torch.stack([res.transform.s, res.rmse,
                                      res.n_effective.to(res.rmse.dtype)]).tolist()
        print(f"  sim3: s={s:.4f} rmse={rmse:.5f} n_eff={int(n_eff)}")
        return res.transform

    # -- loop closure ------------------------------------------------------
    def _chunk_of_frame(self, frame_idx: int) -> int:
        step = self.chunk_size - self.overlap
        return min(frame_idx // step, len(self.chunk_ranges) - 1)

    def detect_and_close_loops(self) -> None:
        pairs = self.loop_detector.detect()
        seen: set[tuple[int, int]] = set()
        for p in pairs:
            a, b = self._chunk_of_frame(p.frame_a), self._chunk_of_frame(p.frame_b)
            if a == b or (a, b) in seen or abs(a - b) < 2:
                continue
            seen.add((a, b))
            chunk_a, chunk_b = self.load_chunk(a), self.load_chunk(b)
            ra, rb = self.chunk_ranges[a], self.chunk_ranges[b]
            lcs = self.loop_chunk_size
            if lcs < self.chunk_size:
                # bound the joint 2-chunk attention: the first lcs frames of
                # each chunk (and the stored chunks sliced to match)
                ra = (ra[0], ra[0] + lcs)
                rb = (rb[0], rb[0] + lcs)
                chunk_a = {k_: v_[:lcs] for k_, v_ in chunk_a.items()}
                chunk_b = {k_: v_[:lcs] for k_, v_ in chunk_b.items()}
            joint_paths = self.img_list[ra[0]: ra[1]] + self.img_list[rb[0]: rb[1]]
            # loop pairs use their own reference-view strategy
            joint = self.model.inference(image=joint_paths, process_res=self.process_res,
                                         ref_view_strategy=self.ref_view_strategy_loop)
            joint.conf = joint.conf - 1.0
            lc = loop_sim3_from_joint_prediction(
                chunk_a, chunk_b, joint, irls_delta=self.irls_delta,
                irls_iters=max(self.irls_iters, 10), irls_tol=self.irls_tol,
                device=self.device,
            )
            accepted = gate_loop_constraint(
                lc, max_rmse=self.loop_max_rmse, min_n_effective=self.loop_min_n_effective,
                max_reciprocal_err=self.loop_max_reciprocal_err)
            self.loop_attempts.append((a, b, p.similarity, lc, accepted))
            if not accepted:
                print(f"  loop edge REJECTED: chunk {b} → chunk {a} "
                      f"(sim {p.similarity:.3f}, rmse {lc.rmse:.4f}, "
                      f"n_eff {lc.n_effective}, recip {lc.reciprocal_err:.4f})")
                continue
            self.loop_edges.append((a, b, lc.transform))
            print(f"  loop edge: chunk {b} → chunk {a} (sim {p.similarity:.3f}, "
                  f"rmse {lc.rmse:.4f}, n_eff {lc.n_effective}, "
                  f"recip {lc.reciprocal_err:.4f})")

    def _optimize_pose_graph(self, accumulated: Sim3) -> Sim3:
        edges = add_loop_edges(sequential_edges(self.sim3_list), self.loop_edges,
                               weight=self.loop_edge_weight)
        return optimize_sim3_pose_graph(
            accumulated, edges, max_iterations=self.loop_max_iterations,
            lambda_init=self.loop_lambda_init, huber_delta=self.loop_huber_delta)

    # -- pass 2 ------------------------------------------------------------
    def process_long_sequence(self) -> None:
        self.chunk_ranges = make_chunk_indices(len(self.img_list), self.chunk_size, self.overlap)
        print(f"{len(self.img_list)} frames → {len(self.chunk_ranges)} chunks")

        prev = None
        for k, rng in enumerate(self.chunk_ranges):
            print(f"[pass1] chunk {k + 1}/{len(self.chunk_ranges)}")
            cur = self.process_single_chunk(rng, k)
            if prev is not None:
                actual_overlap = self.chunk_ranges[k - 1][1] - rng[0]
                self.sim3_list.append(self.align_2pcds(prev, cur, actual_overlap))
            prev = cur

        if self.loop_enable and self.loop_detector is not None:
            print("[loop] detecting loop closures")
            self.detect_and_close_loops()

        if self.sim3_list:
            stacked = Sim3(*(torch.stack(parts) for parts in zip(*self.sim3_list)))
        else:
            stacked = Sim3(torch.zeros((0,), device=self.device),
                           torch.zeros((0, 3, 3), device=self.device),
                           torch.zeros((0, 3), device=self.device))
        with highest_precision():
            accumulated = sim3_accumulate(stacked)  # [K] chunk k → chunk 0
        if self.loop_edges:
            print(f"[loop] optimising pose graph with {len(self.loop_edges)} loop edges")
            accumulated = self._optimize_pose_graph(accumulated)
        self.accumulated = accumulated

        for k in range(len(self.chunk_ranges)):
            print(f"[pass2] aligning chunk {k + 1}/{len(self.chunk_ranges)}")
            chunk = self.load_chunk(k)
            T = Sim3(accumulated.s[k], accumulated.R[k], accumulated.t[k])
            with highest_precision():
                pts = backproject_depth(self._dev(chunk["depth"]), self._dev(chunk["intrinsics"]),
                                        self._dev(chunk["extrinsics"]))
                pts_aligned = sim3_apply(T, pts.reshape(-1, 3)).reshape(pts.shape).cpu().numpy()
            np.savez(self.result_aligned_dir / f"chunk_{k}.npz",
                     points=pts_aligned, conf=chunk["conf"], images=chunk["images"])
            self._save_confident_pointcloud(k, pts_aligned, chunk)
            if self.export_mesh:
                self._collect_mesh_bounds(pts_aligned, chunk)

        self.save_camera_poses()
        if self.export_mesh:
            self.save_mesh()
        if self.save_debug_info:
            rel = [torch.stack(parts).cpu().numpy() for parts in zip(*self.sim3_list)]
            np.savez(
                self.output_dir / "sim3_debug.npz",
                relative_s=rel[0].astype(np.float64) if rel else np.zeros((0,)),
                relative_R=rel[1] if rel else np.zeros((0, 3, 3)),
                relative_t=rel[2] if rel else np.zeros((0, 3)),
                accumulated_s=accumulated.s.cpu().numpy(),
                accumulated_R=accumulated.R.cpu().numpy(),
                accumulated_t=accumulated.t.cpu().numpy(),
                n_loop_edges=len(self.loop_edges),
            )
        n = merge_ply_files(self.pcd_dir, self.output_dir / "combined_pcd.ply")
        print(f"merged cloud: {n} points → {self.output_dir / 'combined_pcd.ply'}")

    def _save_confident_pointcloud(self, k: int, pts: np.ndarray, chunk: dict) -> None:
        conf = chunk["conf"]
        threshold = conf.mean() * self.conf_threshold_coef
        keep = (conf > threshold).reshape(-1)
        pts_flat = pts.reshape(-1, 3)[keep]
        cols_flat = chunk["images"].reshape(-1, 3)[keep]
        if self.sample_ratio < 1.0 and len(pts_flat) > 0:
            n_keep = max(int(len(pts_flat) * self.sample_ratio), 1)
            idx = np.random.default_rng(k).choice(len(pts_flat), n_keep, replace=False)
            pts_flat, cols_flat = pts_flat[idx], cols_flat[idx]
        write_ply(self.pcd_dir / f"chunk_{k}.ply", pts_flat, cols_flat)

    def _collect_mesh_bounds(self, pts: np.ndarray, chunk: dict) -> None:
        """The TSDF scene bounds of one chunk: 1%/99% quantiles of a ~10k-point
        strided sample, gated by the exported cloud's confidence threshold
        (low-confidence outliers would inflate the box and coarsen the
        voxels)."""
        conf_flat = np.asarray(chunk["conf"]).reshape(-1)
        confident = conf_flat > conf_flat.mean() * self.conf_threshold_coef
        if not confident.any():
            # uniform confidence empties the strict gate: take every point
            confident = np.ones_like(confident)
        flat = pts.reshape(-1, 3)[confident]
        samp = flat[:: max(flat.shape[0] // 10000, 1)]
        ok = np.isfinite(samp).all(axis=1)
        if ok.any():
            self._mesh_bounds.append((np.quantile(samp[ok], 0.01, axis=0),
                                      np.quantile(samp[ok], 0.99, axis=0)))

    # -- exports -----------------------------------------------------------
    def save_camera_poses(self) -> None:
        """Compose each chunk's accumulated Sim(3) with its c2w poses,
        normalising the rotation by the scale."""
        n_frames = len(self.img_list)
        all_poses = [None] * n_frames
        all_intr = [None] * n_frames
        chunk_of_frame = np.zeros(n_frames, np.int32)
        with highest_precision():
            S_all = sim3_to_matrix(self.accumulated).cpu().numpy()
        s_all = self.accumulated.s.cpu().numpy()

        for k, (rng, ext) in enumerate(self.all_camera_poses):
            S, s = S_all[k], float(s_all[k])
            start = rng[0] + (self.overlap_s if k > 0 else 0)
            end = rng[1] - (self.overlap_e if k < len(self.all_camera_poses) - 1 else 0)
            for i, idx in enumerate(range(start, end)):
                local_i = i + (self.overlap_s if k > 0 else 0)
                w2c = np.eye(4)
                w2c[:3] = ext[local_i]
                c2w = S @ np.linalg.inv(w2c)
                c2w[:3, :3] /= s  # normalise the rotation
                all_poses[idx] = c2w
                all_intr[idx] = self.all_camera_intrinsics[k][local_i]
                chunk_of_frame[idx] = k

        # frames no chunk covers (possible with the re-anchored tail) take
        # their nearest covered predecessor's pose: wrong but plausible, so the
        # fill is warned and written down
        last = np.eye(4)
        last_K = np.eye(3)
        filled = []
        for idx in range(n_frames):
            if all_poses[idx] is None:
                all_poses[idx] = last
                all_intr[idx] = last_K
                filled.append(idx)
            else:
                last, last_K = all_poses[idx], all_intr[idx]
        self.n_pose_filled = len(filled)
        if filled:
            shown = ", ".join(map(str, filled[:10])) + ("…" if len(filled) > 10 else "")
            warnings.warn(
                f"{len(filled)} frame(s) not covered by any chunk; their poses were filled "
                f"with the previous frame's pose (frames: {shown}). Trajectory metrics over "
                "these frames are not meaningful.", stacklevel=2)
            (self.output_dir / "pose_filled_frames.txt").write_text(
                "\n".join(map(str, filled)) + "\n")

        save_camera_poses(self.output_dir, np.stack(all_poses), np.stack(all_intr),
                          chunk_indices=chunk_of_frame, extra_formats=self.traj_formats)

    def save_mesh(self) -> None:
        """TSDF-fuse every chunk (scaled depth, global w2c poses) on the device
        and write ``scene_mesh.ply`` with per-vertex colours and normals.
        Chunks integrate one at a time (bounded memory)."""
        from da3slam_tpu_torch.core.transforms import sim3_transform_w2c
        from da3slam_tpu_torch.inout.mesh import tsdf_to_mesh, tsdf_vertex_normals, write_mesh_ply
        from da3slam_tpu_torch.ops.tsdf import (
            grid_from_bounds,
            integrate_frames,
            integrate_frames_sparse,
            vertex_colors,
        )

        if not self._mesh_bounds:
            print("[mesh] no aligned chunks — skipping mesh export")
            return
        lo = np.min([b[0] for b in self._mesh_bounds], axis=0)
        hi = np.max([b[1] for b in self._mesh_bounds], axis=0)
        # pad past the truncation band (wall-facing cameras put the surface
        # on the quantile box edge, see ops/tsdf.py:estimate_bounds)
        pad = max(0.05, 4.0 * float(np.max(hi - lo, initial=1e-6)) / self.mesh_resolution)
        grid = grid_from_bounds(lo - pad, hi + pad, self.mesh_resolution, with_color=True,
                                device=self.device)

        for k, (_rng, ext) in enumerate(self.all_camera_poses):
            chunk = self.load_chunk(k)
            T = Sim3(self.accumulated.s[k], self.accumulated.R[k], self.accumulated.t[k])
            # global w2c per frame: the change of world frame of
            # save_camera_poses; sim3_transform_w2c keeps the chunk's camera
            # coordinates and the fused depth is scaled by s, so the whole
            # 3x4 scales by s too
            with highest_precision():
                E_glob = T.s * sim3_transform_w2c(self._dev(ext), T)
            # the spilled conf is already floor-shifted (conf - 1 >= 0)
            fuse_args = (grid, self._dev(chunk["depth"]) * T.s,
                         self._dev(np.maximum(chunk["conf"], 0.0)),
                         self._dev(chunk["intrinsics"]), E_glob)
            images = self._dev(chunk["images"])
            if self.mesh_sparse:
                # The first chunk auto-sizes the budget (with headroom) and
                # later chunks skip the counting pass.  The counts are TRUE
                # counts, so an over-budget chunk is found exactly and re-fused
                # from the grid before it: no observation is dropped.
                grid, counts = integrate_frames_sparse(
                    *fuse_args, images=images, active_blocks=self._mesh_block_budget,
                    carve=self.mesh_carve)
                peak = int(counts.max()) if counts.size else 0
                if self._mesh_block_budget is not None and peak > self._mesh_block_budget:
                    print(f"[mesh] chunk {k + 1}: {peak} active blocks exceed budget "
                          f"{self._mesh_block_budget}; re-fusing with auto-sized budget")
                    grid, counts = integrate_frames_sparse(
                        *fuse_args, images=images, active_blocks=None, carve=self.mesh_carve)
                    peak = int(counts.max()) if counts.size else 0
                if self._mesh_block_budget is None or peak > self._mesh_block_budget:
                    # 25% headroom, rounded to a multiple of 128
                    self._mesh_block_budget = -(-(peak * 5 // 4 + 1) // 128) * 128
            else:
                grid = integrate_frames(*fuse_args, images=images)
            print(f"[mesh] fused chunk {k + 1}/{len(self.all_camera_poses)}")

        verts, faces = tsdf_to_mesh(grid)
        if len(verts) == 0:
            print("[mesh] TSDF produced an empty mesh — nothing written")
            return
        out = self.output_dir / "scene_mesh.ply"
        write_mesh_ply(out, verts, faces, colors=vertex_colors(grid, verts),
                       normals=tsdf_vertex_normals(grid, verts))
        print(f"[mesh] {len(verts)} vertices, {len(faces)} faces → {out}")

    # -- public API --------------------------------------------------------
    def run(self) -> None:
        self.img_list = load_image_paths(self.image_dir)
        if not self.img_list:
            raise ValueError(f"[DIR EMPTY] No images found in {self.image_dir}!")
        print(f"Found {len(self.img_list)} images")
        self.process_long_sequence()

    def close(self) -> None:
        """Delete the temporary spill files, reporting the space reclaimed."""
        if not self.delete_temp_files:
            return
        total = 0
        for d in (self.result_unaligned_dir, self.result_aligned_dir, self.result_loop_dir):
            for f in Path(d).iterdir():
                if f.is_file():
                    total += f.stat().st_size
            shutil.rmtree(d, ignore_errors=True)
        print(f"Saved disk space: {total / 1024**3:.4f} GiB")
