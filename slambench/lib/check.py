"""The comparison that decides ``correct``.

After the window, for a sample of the chunks it completed (drawn from the
seed before it), the plain reference of the configuration's kind
(``kinds/<kind>.py:reference_forward``; for ``da3`` and ``nested``
``slambench/reference``: float32 arithmetic with TF32 off, activations
stored in the configuration's dtype where the port stores them) recomputes
from the same frames and the same weights:

- the model's outputs: ``depth_rel``, ``conf_rel`` and ``desc_rel`` (relative
  L2 over the chunk of depth, confidence and the retrieval descriptors),
  ``pose_gap`` (max |Δ| of the chunk-local w2c over max(1, max |w2c|)), ``intrinsics_rel`` (max |ΔK|
  over max |K|) and, for the nested tier, ``metric_scale_rel``;
- the alignment: ``align_gap``, max |Δ| of the chunk's global w2c against the
  reference's alignment of the program's own inputs to it (the chunk's
  prediction, the previous chunk's overlap frame and the previous overlap
  pose), over max(1, max |t|).  A first chunk must carry its local poses as
  its global ones.

Each number is the worst over the sample; each has its limit in the cell's
file.  Controls (``tools/readings.py``): ``fp8`` puts the reference computed
with float8 (e4m3) activations in the program's place for the model's
numbers; ``tf32-align`` puts the reference's alignment in TF32 in its place
for ``align_gap``; the program's own W8A8 path is set up in ``lib/drive.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.lib.model import reference_forward
from slambench.reference import align as ref_align


def _rel_l2(a: np.ndarray, b: torch.Tensor) -> float:
    a = torch.as_tensor(a, dtype=torch.float64)
    b = b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def model_gaps(pred: dict, ref: dict) -> dict:
    E = torch.as_tensor(pred["extrinsics"], dtype=torch.float64)
    Er = ref["extrinsics"].double().cpu()
    K = torch.as_tensor(pred["intrinsics"], dtype=torch.float64)
    Kr = ref["intrinsics"].double().cpu()
    out = {
        "depth_rel": _rel_l2(pred["depth"], ref["depth"]),
        "conf_rel": _rel_l2(pred["conf"], ref["conf"]),
        "pose_gap": float((E - Er).abs().max() / max(1.0, float(Er.abs().max()))),
        "intrinsics_rel": float((K - Kr).abs().max() / Kr.abs().max()),
        "desc_rel": _rel_l2(pred["frame_desc"], ref["frame_desc"]),
    }
    if "metric_scale" in ref:
        s = float(ref["metric_scale"])
        out["metric_scale_rel"] = abs(pred["metric_scale"] - s) / s
    return out


def align_gap(cap, solver_cfg: dict, device, tf32: bool = False) -> float:
    """The chunk's global poses against the reference's alignment of the
    program's inputs (``tf32``: the reference's alignment in TF32 in the
    program's place, against the reference's)."""
    eg = np.asarray(cap.extrinsics_global, np.float64)
    if cap.align_in is None:
        # a sequence's first chunk defines the global frame
        return float(np.abs(eg - cap.pred["extrinsics"].astype(np.float64)).max())
    a = cap.align_in
    dev = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)  # noqa: E731
    args = (dev(a["prev_depth"]), dev(a["prev_conf"]), dev(a["prev_K"]), dev(cap.pred["depth"]),
            dev(cap.pred["conf"]), dev(cap.pred["intrinsics"]), dev(cap.pred["extrinsics"]),
            dev(a["prev_overlap_global"]), a["anchor_idx"], solver_cfg["Align"])
    _tf32(False)
    ref = ref_align.align_chunk(*args).double().cpu().numpy()
    if tf32:
        _tf32(True)
        eg = ref_align.align_chunk(*args).double().cpu().numpy()
        _tf32(False)
    scale = max(1.0, float(np.abs(ref[..., 3]).max()))
    return float(np.abs(eg - ref).max() / scale)


def _as_pred(ref: dict) -> dict:
    return {k: v.cpu().numpy() if v.ndim else float(v) for k, v in ref.items()}


def compare(run, built, device, control: str | None = None) -> dict:
    """Every number compared, the worst over the sample of captured chunks."""
    cell = run.cell
    captures = run.captures
    k = min(cell.settings["compare_chunks"], len(captures))
    rng = np.random.default_rng([run.seed, 7])
    sample = [captures[i] for i in sorted(rng.choice(len(captures), size=k, replace=False))]
    numbers: dict[str, float] = {}
    res = cell.traffic.get("process_res", 504)
    for cap in sample:
        raw = torch.as_tensor(np.stack(cap.frames), device=device)
        _tf32(False)
        with torch.no_grad():
            ref = reference_forward(built, raw, res, built.act)
            pred = cap.pred
            if control == "fp8":
                pred = _as_pred(reference_forward(built, raw, res, torch.float8_e4m3fn))
        gaps = model_gaps(pred, ref)
        gaps["align_gap"] = align_gap(cap, cell.settings["solver"], device, control == "tf32-align")
        for name, v in gaps.items():
            numbers[name] = max(numbers.get(name, 0.0), v) if np.isfinite(v) else float("inf")
        del ref, raw
    numbers["compared_chunks"] = float(len(sample))
    for extra in cell.checks:
        numbers.update(extra.compare(run, built, device, control))
    return numbers


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and ``{name: {"value", "limit"}}`` for each limited number;
    a run that compared no chunk is not correct."""
    checks = {name: {"value": numbers.get(name, float("inf")), "limit": lim}
              for name, lim in limits.items()}
    ok = numbers.get("compared_chunks", 0) > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
