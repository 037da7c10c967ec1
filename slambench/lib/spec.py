"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cells and metrics, and each configuration, traffic
mix, cell and per-layer metric sits in a file of its own under ``slambench/``:

- ``configs/<config>.json``: the model's sizes, source and assumed values
  (and ``quantize``, where the configuration is served quantized), and its
  ``kind``;
- ``kinds/<kind>.py``: the network of a kind of configuration, its weights,
  its plain reference and its operation count (``lib/model.py`` says what
  it supplies);
- ``traffic/<traffic>.json``: the parameters of a traffic mix (frames, their
  order, size, rate of arrival) and its ``driver``;
- ``drivers/<driver>.py``: the code that turns a traffic file into frames and
  feeds them to the solver in the window (``lib/drive.py`` says what it
  supplies): ``offline`` (closed loop) and ``live`` (open loop);
- ``workloads/<cell>.json``: the cell's own settings (solver blocks, the
  live rate, the sample compared, the limits of ``correct``, and any further
  ``checks``);
- ``checks/<check>.py``: a ``compare(run, built, device, control)`` that
  returns further numbers for ``correct``, for the cells that name it;
- ``metrics/<metric>.py``: a ``read(run)`` that returns the metric's value
  from a finished run, or None where the run holds nothing to read.

Adding any of them takes new files only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: list[dict]
    driver: object  # the module drivers/<traffic's driver>.py
    checks: list  # the modules checks/<name>.py of the cell's "checks"
    bench_dir: Path  # the benchmark folder its files came from


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default), with its
    configuration, traffic and settings read from their files."""
    bench = load_benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config = json.loads((bench_dir / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())
    settings = json.loads((bench_dir / "workloads" / f"{name}.json").read_text())
    return Cell(name, entry["chips"], config, traffic, settings,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)],
                load_module(bench_dir / "drivers" / f"{traffic['driver']}.py"),
                [load_module(bench_dir / "checks" / f"{c}.py") for c in settings.get("checks", [])],
                bench_dir)


def load_module(path: Path):
    """The Python file ``path`` as a module of its own."""
    name = "slambench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``read`` of ``metrics/<name>.py``."""
    return load_module(bench_dir / "metrics" / f"{name}.py").read
