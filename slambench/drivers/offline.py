"""Closed loop, one client: recorded sequences run back to back.

The traffic file's frames (``lib/frames.ordered``) are written once as JPEGs
at its ``jpeg_quality``, as ``cli/main_video.py`` writes extracted frames.
Sequences of them run back to back, each as
``SLAMSolver(dir, config, model, viewer=None).run()`` with a fresh solver and
the shared model: ``cli/main_slam.py``'s path without argument parsing and
export, decoding by the prefetcher included.  The window closes at the first
chunk whose global poses reach the host at or after ``--seconds``.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np

from slambench.lib import frames as fr
from slambench.lib.drive import WindowClosed, chunks_in_sequence, warm_frames


def source(cell, seed: int, device, workdir: Path) -> Path:
    """The folder of the sequence's JPEGs."""
    t = cell.traffic
    folder = workdir / "seq"
    fr.write_jpegs(fr.ordered(t, seed, device), folder, t["jpeg_quality"])
    return folder


def warm(model, cell, source: Path, workdir: Path, device) -> None:
    """One two-chunk sequence of the cell's own shapes, on a throwaway solver."""
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    warm_dir = workdir / "warm"
    warm_dir.mkdir()
    for p in sorted(source.glob("*.jpg"))[:warm_frames(cell)]:
        os.symlink(p, warm_dir / p.name)
    SLAMSolver(str(warm_dir), cell.settings["solver"], model=model, viewer=None,
               device=device).run()


def capture_plan(cell, seed: int, seconds: float):
    """Two chunks of each sequence, drawn from the seed and the sequence's number."""
    m = cell.settings["solver"]["Model"]
    n = chunks_in_sequence(len(fr.order_indices(cell.traffic)), m["chunk_size"], m["overlap_size"])
    picks: dict[int, set] = {}

    def plan(seq: int, idx: int) -> bool:
        if seq not in picks:
            rng = np.random.default_rng([seed, seq])
            picks[seq] = set(rng.choice(n, size=min(2, n), replace=False).tolist())
        return idx in picks[seq]
    return plan


def drive(model, cell, source: Path, run, inst, device) -> None:
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    cfg = cell.settings["solver"]
    inst.deadline = run.seconds
    run.t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        solver = SLAMSolver(str(source), cfg, model=model, viewer=None, device=device)
        inst.wrap_solver(solver)
        try:
            solver.run()
        except WindowClosed:
            run.sequences.append((inst.seq, t, run.t_close, False))
            break
        run.sequences.append((inst.seq, t, time.perf_counter(), True))
        inst.seq += 1
    run.attempted = len(run.chunks)


def report(run) -> list[str]:
    """Each sequence's frames and seconds, with the host seconds of the model's
    and the alignment's calls in it, and the rate over whole sequences only."""
    rows, whole_frames, whole_end = [], 0, run.t0
    for seq, t0, t1, whole in run.sequences:
        n = sum(c.n_new for c in run.chunks if c.seq == seq)
        model, _ = run.span_total("model", t0, t1)
        align, _ = run.span_total("align", t0, t1)
        rows.append(f"{n}/{t1 - t0:.3f} (model {model:.3f}, align {align:.3f})"
                    f"{'' if whole else ' cut'}")
        if whole:
            whole_frames, whole_end = whole_frames + n, t1
    lines = [f"sequences, frames/seconds: {', '.join(rows)}"]
    if whole_end > run.t0:
        lines.append(f"frames/s over whole sequences only: {whole_frames / (whole_end - run.t0)!r}")
    return lines
