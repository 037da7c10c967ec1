"""Open loop: a live camera.

The traffic file's frames (``lib/frames.ordered``), decoded, are pushed one
at a time into one solver's ``process_frame`` at the cell's ``rate_fps``,
each at its due time or at once when the solver is behind, as one continuous
session for ``--seconds``; the frames repeat from the start when they run
out.  A chunk's latency runs from the due time of its last frame to the
moment its global poses are on the host.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from slambench.lib import frames as fr
from slambench.lib.drive import warm_frames


def source(cell, seed: int, device, workdir: Path) -> list:
    """The decoded frames in the order they are pushed."""
    return fr.ordered(cell.traffic, seed, device)


def warm(model, cell, source: list, workdir: Path, device) -> None:
    """Two chunks of the cell's own shapes, pushed into a throwaway solver."""
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    solver = SLAMSolver("", cell.settings["solver"], model=model, viewer=None, device=device)
    for f in source[:warm_frames(cell)]:
        solver.process_frame(f)


def chunks_due(cell, seconds: float) -> int:
    m = cell.settings["solver"]["Model"]
    n_due = int(seconds * cell.settings["rate_fps"])
    return 0 if n_due < m["chunk_size"] else (
        1 + (n_due - m["chunk_size"]) // (m["chunk_size"] - m["overlap_size"]))


def capture_plan(cell, seed: int, seconds: float):
    """``compare_chunks`` of the session's chunks due in the window, drawn from the seed."""
    due = max(chunks_due(cell, seconds), 1)
    k = min(cell.settings["compare_chunks"], due)
    picked = set(np.random.default_rng(seed).choice(due, size=k, replace=False).tolist())
    return lambda seq, idx: idx in picked


def drive(model, cell, frames: list, run, inst, device) -> None:
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    solver = SLAMSolver("", cell.settings["solver"], model=model, viewer=None, device=device)
    inst.wrap_solver(solver)
    interval = 1.0 / cell.settings["rate_fps"]
    n_due = int(run.seconds * cell.settings["rate_fps"])
    run.t0 = time.perf_counter()
    for i in range(n_due):
        due = run.t0 + i * interval
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        run.lateness.append(time.perf_counter() - due)
        inst.live_due = due
        solver.process_frame(frames[i % len(frames)])
    run.t_close = time.perf_counter()
    run.attempted = chunks_due(cell, run.seconds)
    run.failed = run.attempted - len(run.chunks)


def report(run) -> list[str]:
    """How late the generator pushed the frames."""
    late = sorted(run.lateness)
    if not late:
        return []
    return [f"generator lateness: median {late[len(late) // 2] * 1e3:.3f} ms, "
            f"p95 {late[int(0.95 * (len(late) - 1))] * 1e3:.3f} ms, max {late[-1] * 1e3:.3f} ms "
            f"over {len(late)} frames"]
