"""The highest frame rate a live cell's solver sustains without a growing
backlog: the cell's session at each rate given, one line of JSON a rate on
standard output.  A rate is sustained when the
generator's lateness over the last quarter of the session is no more than
one chunk's worth of frames above that over the first quarter.

    python3 slambench/tools/sweep_live.py <cell> <seconds> <seed> <rate,...>
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main() -> None:
    import contextlib

    import numpy as np
    import torch

    from slambench.lib.drive import Instruments, Run
    from slambench.lib.model import build
    from slambench.lib.spec import load_cell

    name, seconds, seed = sys.argv[1], float(sys.argv[2]), int(sys.argv[3])
    rates = [float(r) for r in sys.argv[4].split(",")]
    cell = load_cell(name)
    drv = cell.driver
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="slambench-") as d, \
            contextlib.redirect_stdout(sys.stderr):
        model = build(cell.config, seed, device, cell.bench_dir).model
        frames = drv.source(cell, seed, device, Path(d))
        drv.warm(model, cell, frames, Path(d), device)
        step = cell.settings["solver"]["Model"]["chunk_size"] - cell.settings["solver"]["Model"]["overlap_size"]
        for rate in rates:
            cell.settings["rate_fps"] = rate
            run = Run(cell, seed, seconds, False, cell.traffic["driver"])
            drv.drive(model, cell, frames, run, Instruments(run, cell.settings, lambda s, i: False),
                      device)
            late = np.asarray(run.lateness)
            q = len(late) // 4
            growth = float(np.median(late[-q:]) - np.median(late[:q]))
            lat = sorted((c.t_done - c.due) * 1e3 for c in run.chunks)
            row = {"cell": name, "rate_fps": rate, "chunks": len(run.chunks),
                   "lateness_growth_s": growth, "sustained": growth <= step / rate,
                   "latency_ms_p50": lat[len(lat) // 2], "latency_ms_p95": lat[int(0.95 * (len(lat) - 1))],
                   "window_s": run.window_s}
            line = json.dumps(row)
            print(line, file=sys.__stdout__, flush=True)
            time.sleep(0.5)


if __name__ == "__main__":
    main()
