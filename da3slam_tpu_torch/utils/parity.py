"""Parity harness: the model against reference golden outputs (mini_npz)
(counterpart of ``da3slam_tpu/utils/parity.py``).

The reference exports golden predictions with
``model.inference(..., export_format="mini_npz")``; this module replays each
golden's images through the port's model and compares, so parity is one
command (``python -m da3slam_tpu_torch.cli.parity``) once real weights and
goldens are at hand.

Golden layout under a parity directory:

    <parity_dir>/checkpoint/     torch DA3 checkpoint (config.json +
                                 model.safetensors or pytorch_model.bin;
                                 a nested one too)
    <parity_dir>/golden/*.npz    mini_npz exports with keys
                                 processed_images [N,H,W,3] u8 (or images),
                                 depth [N,H,W], conf [N,H,W],
                                 extrinsics [N,3,4], intrinsics [N,3,3]

Depth is compared scale-invariantly (the output's scale is ambiguous per
chunk): one median-ratio scale is factored out before the absolute relative
error.  The metrics are numpy in f64, as in the JAX package.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

# Same-weights parity is numerical noise; these bounds allow bf16 matmul
# accumulation at 504² and fail on any structural mismatch.
DEFAULT_THRESHOLDS = {
    "depth_absrel": 0.02,  # scale-normalised |d - d_gt| / d_gt, mean
    "conf_corr": 0.98,  # Pearson correlation of confidence maps
    "rot_deg": 1.0,  # per-frame geodesic rotation error, max
    "trans_rel": 0.05,  # translation error / trajectory extent, max
    "focal_rel": 0.02,  # |f - f_gt| / f_gt, max
}


def load_mini_npz(path: str | Path) -> dict[str, np.ndarray]:
    """Read a reference mini_npz export, normalising key aliases."""
    z = np.load(str(path))
    aliases = {
        "processed_images": ["processed_images", "images", "image"],
        "depth": ["depth", "depths"],
        "conf": ["conf", "confidence", "conf_map"],
        "extrinsics": ["extrinsics", "extrinsic", "poses_w2c"],
        "intrinsics": ["intrinsics", "intrinsic", "K"],
    }
    out: dict[str, np.ndarray] = {}
    for ours, names in aliases.items():
        for n in names:
            if n in z:
                out[ours] = np.asarray(z[n])
                break
    missing = {"processed_images", "depth"} - set(out)
    if missing:
        raise ValueError(f"{path}: golden npz missing required keys {missing}")
    if out["depth"].ndim == 4:  # [N, H, W, 1]
        out["depth"] = out["depth"][..., 0]
    return out


def depth_parity(depth: np.ndarray, depth_gt: np.ndarray) -> dict[str, float]:
    """Scale-invariant depth agreement (median ratio factored out)."""
    valid = (depth_gt > 1e-6) & np.isfinite(depth_gt) & np.isfinite(depth)
    d, g = depth[valid], depth_gt[valid]
    s = float(np.median(g / np.maximum(d, 1e-12)))
    absrel = float(np.mean(np.abs(d * s - g) / g))
    rmse_log = float(np.sqrt(np.mean((np.log(np.maximum(d * s, 1e-12)) - np.log(g)) ** 2)))
    return {"depth_scale": s, "depth_absrel": absrel, "depth_rmse_log": rmse_log}


def pose_parity(ext: np.ndarray, ext_gt: np.ndarray) -> dict[str, float]:
    """Per-frame w2c agreement after anchoring both chunks at frame 0."""

    def anchor(E):
        M = np.tile(np.eye(4), (len(E), 1, 1))
        M[:, :3] = E
        return np.einsum("nij,jk->nik", M, np.linalg.inv(M[0]))

    A, B = anchor(np.asarray(ext, np.float64)), anchor(np.asarray(ext_gt, np.float64))
    R_err = np.einsum("nij,nkj->nik", A[:, :3, :3], B[:, :3, :3])  # A R_gtᵀ
    cos = (np.trace(R_err, axis1=1, axis2=2) - 1) / 2
    rot_deg = float(np.max(np.degrees(np.arccos(np.clip(cos, -1, 1)))))
    extent = float(np.max(np.linalg.norm(B[:, :3, 3], axis=-1)))
    trans = float(np.max(np.linalg.norm(A[:, :3, 3] - B[:, :3, 3], axis=-1)))
    return {"rot_deg": rot_deg, "trans_rel": trans / max(extent, 1e-9)}


def compare_prediction(pred: Any, golden: dict[str, np.ndarray]) -> dict[str, float]:
    """Every parity metric of one prediction against one golden file."""
    m = depth_parity(np.asarray(pred.depth), golden["depth"])
    if "conf" in golden:
        # the streaming path subtracts 1.0 from conf; the correlation does
        # not see the offset
        c, g = np.asarray(pred.conf).ravel(), golden["conf"].ravel()
        m["conf_corr"] = float(np.corrcoef(c, g)[0, 1])
    if "extrinsics" in golden and len(golden["extrinsics"]) > 1:
        m.update(pose_parity(np.asarray(pred.extrinsics), golden["extrinsics"]))
    if "intrinsics" in golden:
        f = np.asarray(pred.intrinsics)[:, [0, 1], [0, 1]]
        fg = golden["intrinsics"][:, [0, 1], [0, 1]]
        m["focal_rel"] = float(np.max(np.abs(f - fg) / np.maximum(fg, 1e-9)))
    return m


def check_thresholds(metrics: dict[str, float],
                     thresholds: dict[str, float] | None = None) -> list[str]:
    """The violated thresholds, described (empty: parity)."""
    th = dict(DEFAULT_THRESHOLDS, **(thresholds or {}))
    failures = []
    for key, bound in th.items():
        if key not in metrics:
            continue
        ok = metrics[key] >= bound if key == "conf_corr" else metrics[key] <= bound
        if not ok:
            cmp = "<" if key == "conf_corr" else ">"
            failures.append(f"{key}={metrics[key]:.5f} {cmp} bound {bound}")
    return failures


def run_parity(
    checkpoint: str | Path,
    golden_paths: list[str | Path],
    thresholds: dict[str, float] | None = None,
    device: str | torch.device = "cuda",
) -> tuple[list[dict[str, float]], bool]:
    """Load the checkpoint on ``device``, replay every golden's images through
    it and compare.  Returns (per-file metrics, all passed)."""
    from da3slam_tpu_torch.models.da3 import DepthAnything3

    model = DepthAnything3.from_pretrained(str(checkpoint), device=device)
    results = []
    all_ok = True
    for gp in golden_paths:
        golden = load_mini_npz(gp)
        imgs = list(golden["processed_images"])
        # goldens hold model-resolution images: process_res to match, so the
        # resize is the identity and no second resampling is compared
        res = max(imgs[0].shape[0], imgs[0].shape[1])
        pred = model.inference(image=imgs, process_res=res,
                               process_res_method="upper_bound_resize")
        metrics = compare_prediction(pred, golden)
        failures = check_thresholds(metrics, thresholds)
        metrics["passed"] = float(not failures)
        results.append(metrics)
        status = "PASS" if not failures else "FAIL: " + "; ".join(failures)
        print(f"[parity] {Path(gp).name}: {status}")
        for k, v in metrics.items():
            print(f"    {k}: {v:.6f}")
        all_ok &= not failures
    return results, all_ok


def find_parity_dir() -> Path | None:
    """The parity data directory: ``$DA3_PARITY_DIR``, else ``parity_data/``
    at the repository's root."""
    for cand in (os.environ.get("DA3_PARITY_DIR"),
                 Path(__file__).resolve().parents[2] / "parity_data"):
        if cand and Path(cand).is_dir():
            return Path(cand)
    return None
