"""Loop-closure detection + loop Sim(3) constraint estimation (counterpart of
``da3slam_tpu/slam/loop.py``).

Detection: appearance retrieval — per-frame descriptors (the model's pooled
encoder tokens, or L2-normalised grayscale thumbnails); candidate pairs need
cosine similarity above ``threshold`` and temporal separation of at least
``min_gap``; non-maximum suppression keeps the best pair per neighbourhood.

Constraint: the joint re-inference — run the model once over [chunk_a frames,
chunk_b frames] so cross-view attention places both in one frame, register
each chunk's stored geometry to the joint prediction (confidence-weighted
IRLS, pixelwise correspondence) and compose T(b→a) = T_a^{-1} ∘ T_b.

The retrieval product and the registrations run on ``device`` at full f32
(``highest_precision``: a TF32 product could move a pair across the
threshold); a constraint's quality numbers come back to the host in one
transfer.  Exact revisits tie at a similarity of 1, and the order of such
ties, which non-maximum suppression keeps, follows the device's summation
order, as it does in the JAX package: two devices can attempt different
pairs there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from da3slam_tpu_torch.core.geometry import backproject_depth, median
from da3slam_tpu_torch.core.transforms import (
    Sim3,
    highest_precision,
    sim3_compose,
    sim3_inverse,
    so3_log,
)
from da3slam_tpu_torch.ops.registration import irls_sim3


class LoopPair(NamedTuple):
    frame_a: int
    frame_b: int
    similarity: float


class LoopConstraint(NamedTuple):
    """A loop Sim(3) measurement plus the quality evidence it is gated on
    before it may touch the pose graph (one false loop edge otherwise
    corrupts the whole trajectory)."""

    transform: Sim3  # chunk_b coords → chunk_a coords
    rmse: float  # worst weighted registration RMS of the two chunk fits
    n_effective: int  # smallest effective point count of the two fits
    reciprocal_err: float  # ‖T_fwd ∘ T_bwd − I‖ chart norm, worst of the two


def gate_loop_constraint(
    lc: LoopConstraint,
    max_rmse: float = 0.05,
    min_n_effective: int = 200,
    max_reciprocal_err: float = 0.1,
) -> bool:
    """True iff the loop constraint is trustworthy enough for the graph: a
    low residual (the geometry registered), enough effective points (the fit
    did not ride on a sliver of confident pixels) and forward/backward
    consistency (the two IRLS directions landed in one basin)."""
    return bool(
        np.isfinite(lc.rmse)
        and lc.rmse <= max_rmse
        and lc.n_effective >= min_n_effective
        and lc.reciprocal_err <= max_reciprocal_err
    )


def frame_descriptor(image: np.ndarray, size: int = 16) -> np.ndarray:
    """L2-normalised grayscale thumbnail descriptor."""
    img = np.asarray(image, np.float32)
    if img.ndim == 3:
        img = img.mean(-1)
    H, W = img.shape
    ys = (np.arange(size) * H // size).clip(0, H - 1)
    xs = (np.arange(size) * W // size).clip(0, W - 1)
    thumb = img[np.ix_(ys, xs)].reshape(-1)
    thumb = thumb - thumb.mean()
    n = np.linalg.norm(thumb)
    return thumb / n if n > 0 else thumb


class LoopDetector:
    """Appearance retrieval over the whole sequence.

    Descriptors come from the caller, one kind per sequence: learned
    (``desc=``, the model's ``Prediction.frame_desc``) or the grayscale
    thumbnail of ``image``.  Retrieval is a dense cosine matrix computed on
    ``device`` in ``[block_rows, T]`` panels (blocking bounds the memory of
    the ``[T, T]`` matrix, one host transfer a panel)."""

    def __init__(self, threshold: float = 0.92, min_gap: int = 30,
                 max_loops: int = 10, block_rows: int = 4096,
                 device: str | torch.device = "cuda"):
        self.threshold = threshold
        self.min_gap = min_gap
        self.max_loops = max_loops
        self.block_rows = block_rows
        self.device = torch.device(device)
        self._descs: list[np.ndarray] = []
        self._kind: str | None = None

    @property
    def kind(self) -> str | None:
        """Descriptor source enrolled so far: "learned" | "thumbnail" | None.
        Callers with mixed sources check this and down-convert to the
        enrolled kind (mixing raises)."""
        return self._kind

    @property
    def dim(self) -> int | None:
        """Descriptor dimensionality enrolled so far (None before the first
        frame), for callers that enroll placeholder descriptors."""
        return self._descs[0].shape[0] if self._descs else None

    def add_frame(self, image: np.ndarray | None, desc: np.ndarray | None = None) -> None:
        if desc is not None:
            d = np.asarray(desc, np.float32).reshape(-1)
            n = np.linalg.norm(d)
            d = d / n if n > 0 else d
            kind = "learned"
        else:
            d = frame_descriptor(image)
            kind = "thumbnail"
        if self._kind is None:
            self._kind = kind
        elif self._kind != kind:
            raise ValueError(
                f"mixed descriptor kinds: detector holds {self._kind!r}, "
                f"got {kind!r} — pass desc= for every frame or for none"
            )
        self._descs.append(d)

    def _candidates(self, D: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """All (i, j, sim) with j - i ≥ min_gap and sim > threshold, from
        ``[block, T]`` panels of the cosine matrix."""
        T = D.shape[0]
        Dj = torch.as_tensor(D, dtype=torch.float32, device=self.device)
        rows, cols, sims = [], [], []
        for r0 in range(0, T, self.block_rows):
            r1 = min(r0 + self.block_rows, T)
            with highest_precision():
                panel = (Dj[r0:r1] @ Dj.T).cpu().numpy()  # [r, T]
            jj = np.arange(T)[None, :]
            ii = np.arange(r0, r1)[:, None]
            hit = (jj - ii >= self.min_gap) & (panel > self.threshold)
            r, c = np.nonzero(hit)
            rows.append(r + r0)
            cols.append(c)
            sims.append(panel[r, c])
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        return np.stack([r, c], -1), np.concatenate(sims)

    def detect(self) -> list[LoopPair]:
        if len(self._descs) < self.min_gap + 2:
            return []
        D = np.stack(self._descs)  # [T, d]
        if self._kind == "learned":
            # batch-center: pooled encoder tokens of self-similar footage share
            # a large common component that pushes every cosine toward 1;
            # without the corpus mean the cosines measure the frame-distinctive
            # part, as the mean-subtracted thumbnails do.  Zero rows
            # (placeholder frames) stay zero: centred, they would all alias to
            # -mean and match each other.
            nonzero = np.linalg.norm(D, axis=1) > 0
            if not nonzero.any():
                return []
            D = np.where(nonzero[:, None], D - D[nonzero].mean(axis=0, keepdims=True), 0.0)
            n = np.linalg.norm(D, axis=1, keepdims=True)
            D = D / np.maximum(n, 1e-12)
        cand, sim = self._candidates(D)
        if cand.shape[0] == 0:
            return []
        # greedy NMS: best-similarity pairs first, suppress neighbours
        order = np.argsort(-sim)
        chosen: list[LoopPair] = []
        for k in order:
            a, b = int(cand[k, 0]), int(cand[k, 1])
            if any(abs(a - p.frame_a) < self.min_gap // 2 and
                   abs(b - p.frame_b) < self.min_gap // 2 for p in chosen):
                continue
            chosen.append(LoopPair(a, b, float(sim[k])))
            if len(chosen) >= self.max_loops:
                break
        return chosen


def _chart_norm(T: Sim3) -> torch.Tensor:
    """Distance of a Sim(3) from the identity in the [log s, so3_log, t] chart."""
    return (torch.abs(torch.log(T.s)) + torch.linalg.vector_norm(so3_log(T.R))
            + torch.linalg.vector_norm(T.t))


@highest_precision()
def loop_sim3_from_joint_prediction(
    chunk_a: dict,
    chunk_b: dict,
    joint_prediction,
    irls_delta: float = 0.1,
    irls_iters: int = 10,
    irls_tol: float | None = None,
    device: str | torch.device = "cuda",
) -> LoopConstraint:
    """Register two stored chunks through one joint model prediction.

    ``chunk_a``/``chunk_b``: depth [N,H,W], conf, extrinsics, intrinsics
    (numpy arrays or tensors).  ``joint_prediction``: the model's output over
    chunk_a's frames followed by chunk_b's.  Returns a :class:`LoopConstraint`
    whose transform maps chunk_b coordinates into chunk_a's, on ``device``,
    with the registration-quality numbers callers gate on."""
    dev = torch.device(device)
    na = chunk_a["depth"].shape[0]

    def T(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    joint = {f: T(getattr(joint_prediction, f))
             for f in ("depth", "conf", "extrinsics", "intrinsics")}

    def register(chunk, sl):
        pts_chunk = backproject_depth(
            T(chunk["depth"]), T(chunk["intrinsics"]), T(chunk["extrinsics"])).reshape(-1, 3)
        pts_joint = backproject_depth(
            joint["depth"][sl], joint["intrinsics"][sl], joint["extrinsics"][sl]).reshape(-1, 3)
        conf = torch.sqrt(T(chunk["conf"]).reshape(-1).clamp_min(0)
                          * joint["conf"][sl].reshape(-1).clamp_min(0))
        conf = torch.where(conf > 0.1 * median(conf), conf, torch.zeros_like(conf))
        fwd = irls_sim3(pts_chunk, pts_joint, conf=conf,
                        delta=irls_delta, max_iters=irls_iters, tol=irls_tol)
        # reciprocal consistency: the reverse registration must invert the
        # forward one; disagreement means the fit is not geometrically stable
        bwd = irls_sim3(pts_joint, pts_chunk, conf=conf,
                        delta=irls_delta, max_iters=irls_iters, tol=irls_tol)
        recip = _chart_norm(sim3_compose(fwd.transform, bwd.transform))
        return fwd.transform, torch.stack([fwd.rmse, fwd.n_effective.to(fwd.rmse.dtype), recip])

    T_a, q_a = register(chunk_a, slice(0, na))  # a → joint
    T_b, q_b = register(chunk_b, slice(na, None))  # b → joint
    (rmse_a, n_a, rec_a), (rmse_b, n_b, rec_b) = torch.stack([q_a, q_b]).tolist()
    return LoopConstraint(
        transform=sim3_compose(sim3_inverse(T_a), T_b),
        rmse=max(rmse_a, rmse_b),
        n_effective=int(min(n_a, n_b)),
        reciprocal_err=max(rec_a, rec_b),
    )
