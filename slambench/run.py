"""Run one cell of the benchmark of ``da3slam_tpu_torch`` once.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; the numbers compared beside their limits come last there and
as the last lines of standard error.  Exits non-zero, printing no result,
without enough CUDA devices, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FORBIDDEN = ("jax", "jaxlib", "flax", "da3slam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN`` (whole names:
    ``da3slam_tpu_torch`` is the program, not the JAX package)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def measure(cell, seed: int, seconds: float, trace: bool, device, control: str | None = None):
    """One run: the window, the comparison, the metrics.  Returns the result
    dict (without the device's name) and the run."""
    import torch

    from slambench.lib import check
    from slambench.lib.drive import run_cell
    from slambench.lib.model import chunk_flops
    from slambench.lib.spec import metric_reader

    run, built = run_cell(cell, seed, seconds, trace, T_START, device, control)
    if trace:
        t = cell.traffic
        run.flops_per_chunk = chunk_flops(cell.config, cell.settings["solver"]["Model"]["chunk_size"],
                                          tuple(t["hw"]), t.get("process_res", 504), cell.bench_dir)
    numbers = check.compare(run, built, device, control)
    del built
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = check.verdict(numbers, cell.settings["limits"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": {"count": cell.chips,
                                             "memory_peak_bytes": run.memory_peak_bytes}}
    if trace and run.slice_trace is not None:
        result["device"]["busy_s"] = run.slice_trace.busy_s()
        result["device"]["window_s"] = run.slice_trace.window_s
        result["breakdown"] = {"device_ops": run.slice_trace.top_ops(),
                               "idle_gaps": run.slice_trace.idle_gaps()}
    result["checks"] = checks
    return result, run, numbers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from slambench.lib.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: {args.workload} needs {cell.chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    result, run, numbers = measure(cell, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"slambench: loaded {bad}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), **result["device"]}
    for line in getattr(cell.driver, "report", lambda _: [])(run):
        print(line, file=sys.stderr)
    if run.trace:
        print(f"host waits after the slice: {run.host_waits} at {run.host_waits_at}", file=sys.stderr)
    print(f"compared {int(numbers['compared_chunks'])} chunks; numbers {json.dumps(numbers)}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_finite(result)))
    return 0


def _finite(x):
    """JSON has no inf or nan: such a number is written as null."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return None if isinstance(x, float) and not math.isfinite(x) else x


if __name__ == "__main__":
    sys.exit(main())
