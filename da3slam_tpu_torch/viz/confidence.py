"""Confidence-map statistics (counterpart of the statistics half of
``da3slam_tpu/viz/confidence.py``): per-frame histograms over equal-width
bins.  The comparison and heatmap figures need matplotlib, which the CUDA
machine's installation lacks; they are not ported (ROADMAP queue 1, item 13).
"""

from __future__ import annotations

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
