"""The readings that the limits of ``correct`` are set from: every number
compared, for the program and for each control, on each seed, in one
process (one line of JSON a run on standard output).

    python3 slambench/tools/readings.py <cell> <seconds> <seeds,...> [control,...]

Controls (each on the first three seeds): ``program`` (no control, every seed), ``w8a8`` (the program's own int8 path),
``fp8`` (the reference with float8 activations in the program's place),
``tf32-align`` (the reference's alignment in TF32 in the program's place).
A control that the configuration's kind does not list in its ``CONTROLS``
is skipped, with a line on standard error.  The benchmark's own runs do not
run them.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def plan(cell, seeds: list[int], controls: list[str]) -> list[tuple[str, int]]:
    """The runs to make, ``(control, seed)``: the program on every seed, each
    control that the cell's kind supports on the first three."""
    from slambench.lib.model import controls as kind_controls

    supported = kind_controls(cell.config, cell.bench_dir)
    runs = []
    for control in controls:
        if control != "program" and control not in supported:
            print(f"readings: skipped {control}: kinds/{cell.config['kind']}.py lists only "
                  f"{', '.join(supported) or 'none'}", file=sys.stderr)
            continue
        runs += [(control, seed) for seed in (seeds if control == "program" else seeds[:3])]
    return runs


def main() -> None:
    import torch

    import slambench.run as bench_run
    from slambench.lib.spec import load_cell

    name, seconds = sys.argv[1], float(sys.argv[2])
    seeds = [int(s) for s in sys.argv[3].split(",")]
    controls = sys.argv[4].split(",") if len(sys.argv) > 4 else ["program"]
    cell = load_cell(name)
    device = torch.device("cuda")
    for control, seed in plan(cell, seeds, controls):
        bench_run.T_START = time.perf_counter()
        result, run, numbers = bench_run.measure(
            cell, seed, seconds, False, device, None if control == "program" else control)
        row = {"cell": name, "control": control, "seed": seed, "seconds": seconds,
               "numbers": numbers, "correct": result["correct"],
               "metrics": {k: v["value"] for k, v in result["metrics"].items()},
               "chunks": len(run.chunks)}
        line = json.dumps(row)
        print(line, flush=True)
        del result, run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
