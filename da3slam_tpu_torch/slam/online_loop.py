"""Online loop closure for the live solver (counterpart of
``da3slam_tpu/slam/online_loop.py``).

Wires learned-descriptor retrieval (:class:`slam.loop.LoopDetector`), the
joint-re-inference Sim(3) constraint
(:func:`slam.loop.loop_sim3_from_joint_prediction`) and the LM pose graph
(:mod:`ops.posegraph`) into the chunk loop of :class:`slam.solver.SLAMSolver`,
so a revisit re-anchors the trajectory while the sequence streams in.

- Descriptors: each chunk enrolls only its NEW frames (``Prediction.frame_desc``,
  or grayscale thumbnails for models without it), so detector indices are
  global keyframe indices.
- Memory: per chunk a ``stride``-d copy of depth/conf (1/stride² of the
  pixels), kept on ``device``, plus poses and image paths: the registration
  estimates 7 DoF, for which the strided cloud is enough.
- The pose graph runs over per-chunk nodes ``N_k`` (chunk-local → global
  Sim(3)): the solver's chaining gives ``E_global = E_local ∘ N_k^{-1}``, so
  ``N_k = E_global_0^{-1} ∘ E_local_0``, recovered from stored poses.
- A gated loop edge triggers one LM solve on ``device``; the caller rewrites
  its stored ``extrinsics_global`` from the optimised nodes and re-anchors its
  carry, so every later chunk chains from the corrected trajectory.

Config block (all optional)::

    Loop:
      enable: true           # default false — no cost when off
      stride: 4              # stored-geometry pixel stride
      chunk_size: 0          # 0 = full chunks in the joint re-inference
      min_chunk_gap: 2       # ignore near-adjacent chunk pairs
      edge_weight: 0.5
      Retrieval: {threshold: 0.92, min_gap: 30, max_loops: 10}
      Gate: {max_rmse: 0.05, min_n_effective: 200, max_reciprocal_err: 0.1}
      SIM3_Optimizer: {max_iterations: 30, lambda_init: 1.e-6, huber_delta: 0.1}
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from da3slam_tpu_torch.core.transforms import (
    Sim3,
    highest_precision,
    se3_compose,
    se3_inverse,
    sim3_transform_w2c,
)
from da3slam_tpu_torch.ops.posegraph import (
    PoseGraphEdges,
    add_loop_edges,
    optimize_sim3_pose_graph,
)
from da3slam_tpu_torch.slam.loop import (
    LoopDetector,
    gate_loop_constraint,
    loop_sim3_from_joint_prediction,
)


def _strided_K(K: torch.Tensor, stride: int) -> torch.Tensor:
    """Intrinsics of the ``::stride`` pixel grid (strided pixel (u, v) is
    original (stride·u, stride·v), so the first two rows scale down)."""
    return torch.cat([K[..., :2, :] / float(stride), K[..., 2:, :]], dim=-2)


class OnlineLoopCloser:
    """Per-chunk loop stage for the live solver (see module docstring)."""

    def __init__(self, model: Any, config: dict | None = None,
                 inference_kwargs: dict | None = None,
                 device: str | torch.device = "cuda"):
        cfg = dict(config or {})
        self.model = model
        self.device = torch.device(device)
        self.inference_kwargs = dict(inference_kwargs or {})
        self.stride = int(cfg.get("stride", 4))
        self.joint_chunk_size = int(cfg.get("chunk_size", 0))  # 0 = full
        self.min_chunk_gap = int(cfg.get("min_chunk_gap", 2))
        self.edge_weight = float(cfg.get("edge_weight", 0.5))
        rcfg = cfg.get("Retrieval", {}) or {}
        self.detector = LoopDetector(
            threshold=rcfg.get("threshold", 0.92),
            min_gap=rcfg.get("min_gap", 30),
            max_loops=rcfg.get("max_loops", 10),
            device=self.device,
        )
        gcfg = cfg.get("Gate", {}) or {}
        self.gate_kwargs = dict(
            max_rmse=gcfg.get("max_rmse", 0.05),
            min_n_effective=gcfg.get("min_n_effective", 200),
            max_reciprocal_err=gcfg.get("max_reciprocal_err", 0.1),
        )
        ocfg = cfg.get("SIM3_Optimizer", {}) or {}
        self.opt_kwargs = dict(
            max_iterations=ocfg.get("max_iterations", 30),
            lambda_init=ocfg.get("lambda_init", 1e-6),
            huber_delta=ocfg.get("huber_delta", 0.1),
        )
        icfg = cfg.get("IRLS", {}) or {}
        self.irls_delta = icfg.get("delta", 0.1)
        self.irls_iters = icfg.get("max_iters", 10)
        self.irls_tol = icfg.get("tol")

        self.chunks: list[dict] = []  # strided geometry + paths per chunk
        self.frame_chunk: list[int] = []  # enrolled frame idx → chunk idx
        self.loop_edges: list[tuple[int, int, Sim3]] = []
        self._attempted: set[tuple[int, int]] = set()
        # every estimated constraint: (a, b, similarity, LoopConstraint, accepted)
        self.attempts: list[tuple] = []

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # -- per-chunk ingestion -------------------------------------------------
    def add_chunk(self, cur: dict, new_start: int, frame_desc=None,
                  depth_scale: float = 1.0) -> None:
        """Enroll a processed chunk: descriptors for its NEW frames (from
        ``new_start``, the solver's dedup skip; ``frame_desc`` on the host)
        and the strided geometry the constraint estimator needs later.
        ``cur`` is the solver's chunk dict (depth already prescaled, conf raw
        with the 1.0 floor); ``depth_scale`` is the prescale the aligner
        applied — the stored local extrinsic translations carry it too, so
        the stored cloud and poses live in the same chunk-local frame."""
        st = self.stride
        E_local = self._dev(cur["extrinsics"]).clone()
        E_local[:, :, 3] *= float(depth_scale)
        self.chunks.append({
            "image_paths": list(cur["image_paths"]),
            # conf shifted like the streaming/loop convention (floor at 0)
            "depth": self._dev(cur["depth"])[:, ::st, ::st].clone(),
            "conf": self._dev(cur["conf"])[:, ::st, ::st] - 1.0,
            "intrinsics": _strided_K(self._dev(cur["intrinsics"]), st),
            "extrinsics": E_local,
        })
        k = len(self.chunks) - 1
        n = len(cur["image_paths"])
        images = None
        for i in range(new_start, n):
            desc = None
            if frame_desc is not None and self.detector.kind != "thumbnail":
                desc = np.asarray(frame_desc)[i]
            if desc is None and self.detector.kind == "learned":
                # keep indices aligned when a chunk lacks descriptors
                desc = np.zeros(self.detector.dim, np.float32)
            if desc is not None:
                self.detector.add_frame(None, desc=desc)
            else:
                if images is None:
                    pi = cur["processed_images"]
                    images = pi.cpu().numpy() if isinstance(pi, torch.Tensor) else np.asarray(pi)
                self.detector.add_frame(images[i])
            self.frame_chunk.append(k)

    # -- constraint estimation -------------------------------------------------
    def _estimate_constraint(self, a: int, b: int):
        """Joint re-inference over both chunks (bounded by ``chunk_size``) →
        strided Sim(3) registration of each stored chunk to the joint frame →
        composed loop constraint (``slam/loop.py``)."""
        ca, cb = self.chunks[a], self.chunks[b]
        lcs = self.joint_chunk_size
        if lcs and lcs < min(len(ca["image_paths"]), len(cb["image_paths"])):
            ca = {key: v[:lcs] for key, v in ca.items()}
            cb = {key: v[:lcs] for key, v in cb.items()}
        joint = self.model.inference(image=ca["image_paths"] + cb["image_paths"],
                                     **self.inference_kwargs)
        st = self.stride

        class _J:  # strided view matching the stored chunks' pixel grid
            depth = self._dev(joint.depth)[:, ::st, ::st]
            conf = self._dev(joint.conf)[:, ::st, ::st] - 1.0
            extrinsics = self._dev(joint.extrinsics)
            intrinsics = _strided_K(self._dev(joint.intrinsics), st)

        return loop_sim3_from_joint_prediction(
            ca, cb, _J, irls_delta=self.irls_delta, irls_iters=self.irls_iters,
            irls_tol=self.irls_tol, device=self.device,
        )

    # -- pose graph ------------------------------------------------------------
    def maybe_close(self, extrinsics_global: list):
        """Detect → gate → optimize.  ``extrinsics_global``: the caller's
        current per-chunk [N, 3, 4] global w2c (same order as ``add_chunk``
        calls).  Returns the re-anchored per-chunk arrays (numpy f32) when a
        new gated loop edge landed, else None."""
        if len(self.chunks) < self.min_chunk_gap + 1:
            return None
        pairs = self.detector.detect()
        new_edges = 0
        for p in pairs:
            a = self.frame_chunk[p.frame_a]
            b = self.frame_chunk[p.frame_b]
            if a > b:
                a, b = b, a
            if b - a < self.min_chunk_gap or (a, b) in self._attempted:
                continue
            self._attempted.add((a, b))
            lc = self._estimate_constraint(a, b)
            accepted = gate_loop_constraint(lc, **self.gate_kwargs)
            self.attempts.append((a, b, p.similarity, lc, accepted))
            if not accepted:
                print(f"  [loop] edge REJECTED: chunk {b} → {a} "
                      f"(rmse={lc.rmse:.4f}, n_eff={lc.n_effective}, "
                      f"recip={lc.reciprocal_err:.4f})")
                continue
            print(f"  [loop] edge ACCEPTED: chunk {b} → {a} "
                  f"(sim={p.similarity:.3f}, rmse={lc.rmse:.4f})")
            self.loop_edges.append((a, b, lc.transform))
            new_edges += 1
        if new_edges == 0 or not self.loop_edges:
            return None
        return self._optimize(extrinsics_global)

    @highest_precision()
    def _optimize(self, extrinsics_global: list) -> list[np.ndarray]:
        K = len(self.chunks)
        dev = self.device
        # nodes: N_k maps chunk-local → global; E_global = E_local ∘ N_k^{-1}
        # ⇒ N_k = E_global_0^{-1} ∘ E_local_0 (rigid; scale is folded into
        # the chunk-local coords by the depth prescale)
        N = torch.stack([se3_compose(se3_inverse(self._dev(Eg[0])), self.chunks[k]["extrinsics"][0])
                         for k, Eg in enumerate(extrinsics_global)])  # [K, 3, 4]
        nodes_init = Sim3(torch.ones(K, device=dev), N[:, :3, :3], N[:, :3, 3])
        # odometry edges from the same chained poses the nodes came from
        rel = se3_compose(se3_inverse(N[:-1]), N[1:])  # [K-1, 3, 4]
        edges = PoseGraphEdges(
            i=torch.arange(K - 1, device=dev),
            j=torch.arange(1, K, device=dev),
            measurement=Sim3(torch.ones(K - 1, device=dev), rel[:, :3, :3], rel[:, :3, 3]),
            weight=torch.ones(K - 1, device=dev),
        )
        edges = add_loop_edges(edges, self.loop_edges, weight=self.edge_weight)
        opt = optimize_sim3_pose_graph(nodes_init, edges, **self.opt_kwargs)
        # rigid renormalisation: sim3_transform_w2c leaves the rotation rows at
        # norm 1/s; scaling the whole 3x4 by s keeps the camera center and
        # orientation while restoring orthonormality
        updated = [opt.s[k] * sim3_transform_w2c(self.chunks[k]["extrinsics"],
                                                 Sim3(opt.s[k], opt.R[k], opt.t[k]))
                   for k in range(K)]
        # one transfer for all chunks
        flat = torch.cat([E.reshape(-1) for E in updated]).cpu().numpy()
        return [part.reshape(E.shape) for part, E in
                zip(np.split(flat, np.cumsum([E.numel() for E in updated])[:-1]), updated)]
