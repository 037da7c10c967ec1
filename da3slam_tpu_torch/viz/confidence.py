"""Confidence-map inspection (counterpart of ``da3slam_tpu/viz/confidence.py``):
per-frame statistics over equal-width bins, 3-panel comparison PNGs
(original | viridis heatmap | thresholded keep-mask) and an all-frames
heatmap grid.  The figures import matplotlib (Agg backend) when drawn, so
the statistics need nothing beyond numpy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def conf_stats(conf: np.ndarray, n_bins: int = 5) -> dict:
    """Equal-width bin histogram over ``[min, max]`` of one confidence map."""
    conf = np.asarray(conf)
    lo, hi = float(conf.min()), float(conf.max())
    if hi <= lo:  # a constant map: keep the bins monotone
        hi = lo + 1e-6
    bins = np.linspace(lo, hi, n_bins + 1)
    counts, _ = np.histogram(conf, bins=bins)
    return {
        "min": lo,
        "max": hi,
        "mean": float(conf.mean()),
        "median": float(np.median(conf)),
        "bins": bins,
        "counts": counts,
        "fractions": counts / conf.size,
    }


def print_conf_stats(conf: np.ndarray, frame_idx: int, n_bins: int = 5) -> dict:
    s = conf_stats(conf, n_bins)
    print(f"Frame {frame_idx}: conf min={s['min']:.3f} max={s['max']:.3f} "
          f"mean={s['mean']:.3f} median={s['median']:.3f}")
    for k in range(n_bins):
        print(f"  bin [{s['bins'][k]:.3f}, {s['bins'][k+1]:.3f}): "
              f"{s['counts'][k]} px ({100*s['fractions'][k]:.1f}%)")
    return s


def create_confidence_comparison(
    image: np.ndarray, conf: np.ndarray, out_path: str | Path, threshold: float | None = None
) -> None:
    """3-panel PNG: original | conf heatmap | pixels above threshold.  The
    threshold defaults to the 3rd bin edge."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    conf = np.asarray(conf)
    if threshold is None:
        threshold = conf_stats(conf)["bins"][2]
    keep = conf > threshold
    masked = np.asarray(image).copy()
    masked[~keep] = 0

    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].imshow(image)
    axes[0].set_title("original")
    im = axes[1].imshow(conf, cmap="viridis")
    axes[1].set_title("confidence")
    fig.colorbar(im, ax=axes[1], fraction=0.046)
    axes[2].imshow(masked)
    axes[2].set_title(f"conf > {threshold:.3f} ({100*keep.mean():.1f}% kept)")
    for ax in axes:
        ax.axis("off")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def create_overall_heatmap(
    confs: np.ndarray, out_path: str | Path, max_cols: int = 4
) -> None:
    """Grid of all frames' confidence heatmaps on one colour scale."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    confs = np.asarray(confs)
    n = confs.shape[0]
    cols = min(n, max_cols)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows), squeeze=False)
    vmin, vmax = float(confs.min()), float(confs.max())
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i < n:
            im = ax.imshow(confs[i], cmap="viridis", vmin=vmin, vmax=vmax)
            ax.set_title(f"frame {i}", fontsize=9)
    fig.colorbar(im, ax=axes, fraction=0.02)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
