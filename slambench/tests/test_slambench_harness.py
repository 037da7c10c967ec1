"""The harness on the CPU: names resolve from ``BENCHMARK.json``, a cell added
as new files runs end to end, the reference agrees with the port, the
arithmetic of the metrics is right, and nothing loads JAX."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from slambench.lib import check, readers
from slambench.lib.drive import run_cell
from slambench.lib.roofline import PEAK_BYTES_PER_S, PEAK_FLOPS, attention_roofline_s
from slambench.lib.spec import BENCH_DIR, ROOT, load_benchmark, load_cell, metric_reader
from slambench.lib.trace import TraceSlice, union_length
from slambench.tests.conftest import ASSUMED, TINY_BACKBONE

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def run_tiny(bench, folder, name, seconds=2.0, control=None):
    cell = load_cell(name, bench, folder)
    run, built = run_cell(cell, 2**31 + 11, seconds, False, time.perf_counter(),
                          torch.device("cpu"), control)
    numbers = check.compare(run, built, torch.device("cpu"), control)
    return cell, run, numbers


# -- the layout -------------------------------------------------------------

def test_every_name_in_benchmark_json_resolves_to_its_files():
    bench = load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        blob = json.loads((ROOT / c["file"]).read_text())
        assert blob["name"] == c["name"] and blob["source"] == c["source"]
        assert blob["reduced"] == c["reduced"] == []
    for w in bench["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        cell = load_cell(w["name"], bench)
        for part in ("source", "warm", "capture_plan", "drive"):
            assert callable(getattr(cell.driver, part))
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metric_reader(m["name"]))
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    for w in bench["workloads"]:
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key])


def test_a_cell_added_as_new_files_is_found_and_runs(tiny_bench):
    bench, folder = tiny_bench
    cell, run, numbers = run_tiny(bench, folder, "tiny-offline")
    correct, checks = check.verdict(numbers, cell.settings["limits"])
    assert correct, checks
    assert run.frames > 0 and readers.frames_per_s(run) > 0
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "setup_s"}


def test_the_live_cell_runs_open_loop(tiny_bench):
    bench, folder = tiny_bench
    cell, run, numbers = run_tiny(bench, folder, "tiny-live", seconds=4.0)
    assert check.verdict(numbers, cell.settings["limits"])[0]
    assert run.attempted == len(run.chunks) + run.failed and run.attempted >= 2
    assert readers.chunk_latency_ms_p95(run) > 0
    assert len(run.lateness) == 16  # 4 frames/s over 4 s


# a traffic whose driver the harness does not have: closed loop over decoded
# frames pushed into process_frame, out along the path and back
THIRD_DRIVER = """
import time
from slambench.lib import frames as fr
from slambench.lib.drive import WindowClosed, warm_frames


def source(cell, seed, device, workdir):
    return fr.ordered(cell.traffic, seed, device)


def warm(model, cell, source, workdir, device):
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    solver = SLAMSolver("", cell.settings["solver"], model=model, viewer=None, device=device)
    for f in source[:warm_frames(cell)]:
        solver.process_frame(f)


def capture_plan(cell, seed, seconds):
    return lambda seq, idx: True


def drive(model, cell, frames, run, inst, device):
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    inst.deadline = run.seconds
    run.t0 = time.perf_counter()
    while True:
        solver = SLAMSolver("", cell.settings["solver"], model=model, viewer=None, device=device)
        inst.wrap_solver(solver)
        try:
            for f in frames:
                solver.process_frame(f)
        except WindowClosed:
            break
        inst.seq += 1
    run.attempted = len(run.chunks)
"""

# a comparison that the harness does not have: every kept chunk's global poses finite
THIRD_CHECK = """
import numpy as np


def compare(run, built, device, control):
    return {"nonfinite_poses": float(sum(not np.isfinite(c.extrinsics_global).all()
                                         for c in run.captures))}
"""


def test_a_traffic_with_a_driver_of_its_own_takes_new_files_only(tiny_bench):
    bench, folder = tiny_bench
    (folder / "drivers" / "tiny-closed.py").write_text(THIRD_DRIVER)
    (folder / "checks").mkdir()
    (folder / "checks" / "tiny-extra.py").write_text(THIRD_CHECK)
    (folder / "traffic" / "tiny-out-and-back.json").write_text(json.dumps(
        {"driver": "tiny-closed", "frames": 4, "order": [[0, 3], [3, 0]], "hw": [518, 518],
         "process_res": 504}))
    settings = json.loads((folder / "workloads" / "tiny-offline.json").read_text())
    settings["checks"] = ["tiny-extra"]
    settings["limits"]["nonfinite_poses"] = 0.0
    (folder / "workloads" / "tiny-loop.json").write_text(json.dumps(settings))
    bench["workloads"].append({"name": "tiny-loop", "config": "tiny",
                               "traffic": "tiny-out-and-back", "chips": 1, "why": "test size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-offline" in m.get("workloads", []):
            m["workloads"].append("tiny-loop")
    cell, run, numbers = run_tiny(bench, folder, "tiny-loop")
    correct, checks = check.verdict(numbers, cell.settings["limits"])
    assert correct, checks
    assert checks["nonfinite_poses"] == {"value": 0.0, "limit": 0.0}
    assert run.driver == "tiny-closed" and readers.frames_per_s(run) > 0
    # the 8 frames out and back make two chunks of 4 and a tail, each sequence
    assert all(c.n_new > 0 for c in run.chunks) and len(run.captures) == len(run.chunks)


def test_a_quantized_configuration_is_a_file_of_its_own(tiny_bench):
    bench, folder = tiny_bench
    config = json.loads((folder / "configs" / "tiny.json").read_text())
    (folder / "configs" / "tiny-w8a8.json").write_text(json.dumps(dict(config, quantize="w8a8")))
    (folder / "workloads" / "tiny-w8a8.json").write_text(
        (folder / "workloads" / "tiny-offline.json").read_text())
    bench["workloads"].append({"name": "tiny-w8a8", "config": "tiny-w8a8",
                               "traffic": "tiny-offline", "chips": 1, "why": "test size"})
    _, _, quantized = run_tiny(bench, folder, "tiny-w8a8")
    _, _, control = run_tiny(bench, folder, "tiny-offline", control="w8a8")
    assert quantized["depth_rel"] == control["depth_rel"] > 0


# -- the reference ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["da3", "nested"])
def test_reference_agrees_with_the_port_in_float32(kind):
    from slambench.lib import frames
    from slambench.lib.model import build, reference_forward

    config = {"kind": kind, "dtype": "bfloat16", "assumed": ASSUMED}
    if kind == "nested":
        config.update(anyview=TINY_BACKBONE, metric=dict(TINY_BACKBONE, embed_dim=48, num_heads=3))
    else:
        config["backbone"] = TINY_BACKBONE
    built = build(config, 5, torch.device("cpu"))
    raw = torch.from_numpy(frames.render_sequence(3, 5, (70, 70), "cpu"))
    pred = built.model.inference(image=raw, process_res=56)
    ref = reference_forward(built, raw, 56, torch.float32)
    got = {k: np.asarray(getattr(pred, k)) for k in
           ("depth", "conf", "extrinsics", "intrinsics", "frame_desc")}
    if kind == "nested":
        got["metric_scale"] = pred.metric_scale
    gaps = check.model_gaps(got, ref)
    assert max(gaps.values()) < 1e-5, gaps


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        tops |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert tops <= {"__future__", "math", "torch"}, (path.name, tops)
    code = ("import sys; import slambench.reference.model, slambench.reference.align; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert "da3slam_tpu_torch" not in out and "'jax'" not in out


def test_no_jax_after_the_harness_runs_a_cell(tiny_bench):
    bench, folder = tiny_bench
    (folder / "bench.json").write_text(json.dumps(bench))
    code = f"""
import json, sys, time, torch
from pathlib import Path
from slambench.lib.spec import load_cell
from slambench.lib.drive import run_cell
from slambench.lib import check
import slambench.run as r
folder = Path({str(folder)!r})
cell = load_cell("tiny-offline", json.loads((folder / "bench.json").read_text()), folder)
run, built = run_cell(cell, 7, 1.0, False, time.perf_counter(), torch.device("cpu"))
check.compare(run, built, torch.device("cpu"))
print("FORBIDDEN", r.forbidden_modules())
print("TOP", sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert "FORBIDDEN []" in out
    top = out.split("TOP ")[1]
    assert "'jax'" not in top and "'da3slam_tpu'" not in top and "'da3slam_tpu_torch'" in top


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import slambench.run as r

    monkeypatch.setitem(sys.modules, "da3slam_tpu_torch", sys)
    monkeypatch.setitem(sys.modules, "da3slam_tpu_like.sub", sys)
    found = r.forbidden_modules()
    assert "da3slam_tpu_torch" not in found and "da3slam_tpu_like" not in found
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in r.forbidden_modules()


# -- the arithmetic -------------------------------------------------------------

def test_flop_counter_and_attention_bound_at_a_hand_computed_shape():
    from torch.utils.flop_counter import FlopCounterMode

    from slambench.reference.model import attention

    B, S, H, D = 2, 300, 3, 64
    q, k, v = (torch.empty(B, S, H, D, device="meta") for _ in range(3))
    with FlopCounterMode(display=False) as counter:
        attention(q, k, v)
    assert counter.get_total_flops() == 4 * B * H * S * S * D  # Q·Kᵀ and P·V
    # (1, 19515, 6, 64) bf16: 5.850e11 operations, 59.9 MB moved: bound by operations
    flop = 4 * 6 * 19515**2 * 64
    assert attention_roofline_s(1, 19515, 6, 64, "bfloat16") == pytest.approx(flop / 989e12)
    # a short sequence is bound by bytes: q, k, v read, o written, 2 bytes each
    assert attention_roofline_s(64, 16, 16, 64, "bfloat16") == pytest.approx(
        4 * 64 * 16 * 16 * 64 * 2 / PEAK_BYTES_PER_S)
    assert PEAK_FLOPS["bfloat16"] == 989e12


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_idle_share_is_one_minus_the_union_of_device_intervals():
    events = [
        _x("user_annotation", "slambench.slice", 0, 100),
        _x("user_annotation", "slambench.model", 5, 30),
        _x("user_annotation", "slambench.align", 60, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 8, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=3),
        _x("kernel", "k1", 10, 20, correlation=1),  # [10, 30] on one stream
        _x("kernel", "k2", 20, 20, correlation=2),  # [20, 40] on another: overlaps
        _x("gpu_memcpy", "copy", 70, 10, correlation=3),
        _x("kernel", "late", 95, 10, correlation=9),  # clipped to the slice
    ]
    sl = TraceSlice(events)
    assert sl.window_s == pytest.approx(100e-6)
    assert sl.busy_s() == pytest.approx((30 + 10 + 5) * 1e-6)  # [10,40], [70,80], [95,100]
    assert sl.device_s_under("model") == pytest.approx(40e-6)  # k1 + k2, overlap counted apiece
    assert sl.device_s_under("align") == pytest.approx(10e-6)
    gaps = dict(sl.idle_gaps())
    # [0,10): no span at 0; [40,70): model closed at 35, align opens at 60 -> no span at 40;
    # [80,95): inside align until 90
    assert gaps["no span"] == pytest.approx(40e-6) and gaps["align"] == pytest.approx(15e-6)
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4


def test_latency_percentile_counts_chunks_not_completed_as_late():
    from slambench.lib.drive import Chunk, Run

    run = Run(None, 0, 1.0, False, "live")
    run.chunks = [Chunk(0, i, 1.0 + i, 15, due=0.9 + i) for i in range(19)]
    run.attempted, run.failed = 20, 1
    assert readers.chunk_latency_ms_p95(run) == pytest.approx(100.0)
    run.failed, run.attempted = 2, 21
    assert readers.chunk_latency_ms_p95(run) == float("inf")


# -- the card ----------------------------------------------------------------------

@pytest.mark.cuda
def test_small_offline_runs_correct_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", "small-offline",
                          "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
