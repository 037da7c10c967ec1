"""Configuration kinds (``kinds/<kind>.py``): the DA3 and nested kinds build
the same weights, reference outputs and operation counts as the harness did
before the kinds were split out, bit for bit, and a kind of network that the
harness does not have is added as new files only."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math

import pytest
import torch

from slambench.lib import check, frames
from slambench.lib.model import build, chunk_flops, kind, reference_forward
from slambench.lib.spec import BENCH_DIR, load_cell, load_module
from slambench.tests.conftest import ASSUMED, TINY_BACKBONE
from slambench.tests.test_slambench_harness import run_tiny

# Read from the harness before the kinds were split out (slambench/lib/model.py
# building every configuration itself), on the CPU: per role, the number of
# state-dict tensors and the SHA-256 of [role, name, shape, fsum, fsum of
# squares] of each tensor in float64, at seed 5 ...
WEIGHTS = {
    "da3": (137, "19b0c967f770b6497ccc03cc0a26c32d653cc63d877f4689af8ab286f1f9a97b"),
    "nested": (274, "9e17dddf8d7d5b72e6da3ae823e480343c941ecf7826ae6ff9776e580e6bc6ab"),
}
# ... the reference's outputs (shape, fsum, fsum of squares) over
# frames.render_sequence(3, 5, (70, 70)) at process_res 56, activations
# stored in float32 and in bfloat16 ...
REFERENCE = {
    "da3": {
        "float32": {
            "conf": ((3, 56, 56), 21083.20784163475, 47268.4653448994),
            "depth": ((3, 56, 56), 17720.64227104187, 33427.12511834629),
            "extrinsics": ((3, 3, 4), 8.99999961714478, 9.000000000001918),
            "frame_desc": ((3, 32), -5.634501576423645e-08, 3.0000000732085703),
            "intrinsics": ((3, 3, 3), 506.9987030029297, 23522.80091496856),
        },
        "bfloat16": {
            "conf": ((3, 56, 56), 21081.44157385826, 47260.59835639492),
            "depth": ((3, 56, 56), 17707.30014526844, 33376.242144402415),
            "extrinsics": ((3, 3, 4), 8.9999995666137, 9.00000000000152),
            "frame_desc": ((3, 32), 0.0011756853200495243, 3.000000003866777),
            "intrinsics": ((3, 3, 3), 506.99869537353516, 23522.800060502508),
        },
    },
    "nested": {
        "float32": {
            "conf": ((3, 56, 56), 21083.20784163475, 47268.4653448994),
            "depth": ((3, 56, 56), 13503.53542637825, 19410.426860323103),
            "extrinsics": ((3, 3, 4), 8.999999708250408, 9.000000000001892),
            "frame_desc": ((3, 32), -5.634501576423645e-08, 3.0000000732085703),
            "intrinsics": ((3, 3, 3), 506.9987030029297, 23522.80091496856),
            "metric_scale": ((), 0.7620229125022888, 0.5806789191784709),
        },
        "bfloat16": {
            "conf": ((3, 56, 56), 21081.44157385826, 47260.59835639492),
            "depth": ((3, 56, 56), 13500.087371826172, 19400.186210353),
            "extrinsics": ((3, 3, 4), 8.999999669594052, 9.000000000001476),
            "frame_desc": ((3, 32), 0.0011756853200495243, 3.000000003866777),
            "intrinsics": ((3, 3, 3), 506.99869537353516, 23522.800060502508),
            "metric_scale": ((), 0.762402355670929, 0.5812573519325817),
        },
    },
}
# ... and the operations of a chunk of 15 views of 518² at process_res 504
# (mfu's numerator), for the published configurations
FLOPS = {"da3-small": 5659316145738, "da3nested-giant-large": 104440685257892}


def _digest(t: torch.Tensor) -> tuple:
    """(shape, fsum, fsum of squares) in float64: exact sums, the same in
    any order of summation (a float32 value squared is exact in float64)."""
    x = t.detach().double().flatten().tolist()
    return tuple(t.shape), math.fsum(x), math.fsum(v * v for v in x)


def _tiny_config(name: str) -> dict:
    config = {"kind": name, "dtype": "bfloat16", "assumed": ASSUMED}
    if name == "nested":
        config.update(anyview=TINY_BACKBONE, metric=dict(TINY_BACKBONE, embed_dim=48, num_heads=3))
    else:
        config["backbone"] = TINY_BACKBONE
    return config


@pytest.mark.parametrize("name", ["da3", "nested"])
def test_a_kind_builds_the_weights_and_reference_it_built_before_the_split(name):
    built = build(_tiny_config(name), 5, torch.device("cpu"))
    rows = [[role, n, *_digest(t)] for role, sd in built.state_dicts.items() for n, t in sd.items()]
    assert (len(rows), hashlib.sha256(json.dumps(rows).encode()).hexdigest()) == WEIGHTS[name]
    raw = torch.from_numpy(frames.render_sequence(3, 5, (70, 70), "cpu"))
    for act, want in REFERENCE[name].items():
        ref = reference_forward(built, raw, 56, getattr(torch, act))
        got = {k: _digest(torch.as_tensor(v)) for k, v in sorted(ref.items())}
        assert got == want, act


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_a_kind_counts_the_operations_it_counted_before_the_split(name):
    config = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    assert chunk_flops(config, 15, (518, 518), 504) == FLOPS[name]


def test_a_missing_kind_or_part_names_its_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="kinds/none.py"):
        build({"kind": "none"}, 0, torch.device("cpu"))
    (tmp_path / "kinds").mkdir()
    (tmp_path / "kinds" / "half.py").write_text("CONTROLS = ()\n")
    with pytest.raises(AttributeError, match=r"kinds/half.py defines no chunk_flops"):
        chunk_flops({"kind": "half"}, 1, (14, 14), 14, tmp_path)


# a kind the harness does not have: DA3's tiny preset with weight scales of
# its own, its roles named apart, and a depth factor to plant a fault with
TOY_KIND = '''
import dataclasses

import torch

from slambench.lib.model import Built
from slambench.lib.weights import make_state_dict

CONTROLS = ("fp8", "tf32-align")
DEPTH_FACTOR = {factor}


def rule(name, shape):
    if name.endswith("gamma"):
        return 0.0, 0.3
    if name.endswith(".bias"):
        return 0.0, 0.0
    if len(shape) == 1:
        return 0.0, 1.0
    if len(shape) == 4:
        return 0.3 / (shape[1] * shape[2] * shape[3]) ** 0.5, 0.0
    return 0.05, 0.0


def _cfg(config):
    from da3slam_tpu_torch.models.config import PRESETS

    return PRESETS[config["preset"]]


def _ref_cfg(config):
    return {{**dataclasses.asdict(_cfg(config)), "base_grid": config["base_grid"]}}


def build(config, seed, device):
    from da3slam_tpu_torch.models.da3 import DA3Net, DepthAnything3

    cfg = _cfg(config)
    with torch.device("meta"):
        net = DA3Net(cfg)
    shapes = {{k: tuple(v.shape) for k, v in net.state_dict().items()}}
    sd = make_state_dict(shapes, rule, torch.Generator(device).manual_seed(seed), device)
    sd["camera_head.out.bias"][0].fill_(1.0)
    net.load_state_dict(sd, strict=True, assign=True)
    model = DepthAnything3(cfg, net)
    inner = model.inference

    def inference(*args, **kwargs):
        pred = inner(*args, **kwargs)
        return dataclasses.replace(pred, depth=pred.depth * DEPTH_FACTOR)

    model.inference = inference
    return Built(model, {{"net": sd}}, {{"net": _ref_cfg(config)}}, model.dtype)


def reference_forward(built, raw, process_res, act):
    from slambench.reference import model as ref

    return ref.forward(built.state_dicts["net"], built.ref_cfgs["net"], raw, process_res, act)


def chunk_flops(config, views, hw, process_res):
    from torch.utils.flop_counter import FlopCounterMode

    from da3slam_tpu_torch.models.da3 import DA3Net
    from slambench.reference import model as ref

    with torch.device("meta"):
        sd = DA3Net(_cfg(config)).state_dict()
    raw = torch.empty((views, *hw, 3), dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.forward(sd, _ref_cfg(config), raw, process_res)
    return float(counter.get_total_flops())
'''


@pytest.fixture
def toy_bench(tiny_bench):
    """``tiny_bench`` with a ``toy`` kind and a ``toy-fault`` kind (the toy's
    port with depth × 1.01), their configurations and an offline cell each,
    all new files."""
    bench, folder = tiny_bench
    for name, factor in (("toy", 1.0), ("toy-fault", 1.01)):
        (folder / "kinds" / f"{name}.py").write_text(TOY_KIND.format(factor=factor))
        (folder / "configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "source": "test size", "reduced": [], "kind": name,
             "dtype": "bfloat16", "preset": "tiny", "base_grid": 37}))
        (folder / "workloads" / f"{name}-offline.json").write_text(
            (folder / "workloads" / "tiny-offline.json").read_text())
        bench["workloads"].append({"name": f"{name}-offline", "config": name,
                                   "traffic": "tiny-offline", "chips": 1, "why": "test size"})
    return bench, folder


def test_a_kind_of_its_own_takes_new_files_only(toy_bench):
    bench, folder = toy_bench
    cell, run, numbers = run_tiny(bench, folder, "toy-offline")
    correct, checks = check.verdict(numbers, cell.settings["limits"])
    assert correct, checks
    assert run.frames > 0 and numbers["compared_chunks"] >= 2
    # its own weight rule: LayerScale 0.3, where DA3's rule gives the assumed 0.1
    built = build(cell.config, 3, torch.device("cpu"), folder)
    assert float(built.state_dicts["net"]["blocks.0.ls1.gamma"][0]) == pytest.approx(0.3)
    # the same network as DA3's kind at the same sizes: the same operations
    from da3slam_tpu_torch.models.config import PRESETS

    da3 = {"kind": "da3", "backbone": {**dataclasses.asdict(PRESETS["tiny"]), "base_grid": 37}}
    flops = chunk_flops(cell.config, 4, (518, 518), 504, folder)
    assert flops == chunk_flops(da3, 4, (518, 518), 504) > 0
    # a fault planted in the toy's port is caught
    cell, _, numbers = run_tiny(bench, folder, "toy-fault-offline")
    correct, checks = check.verdict(numbers, cell.settings["limits"])
    assert not correct and checks["depth_rel"]["value"] == pytest.approx(0.01, rel=1e-3)


def test_readings_skip_a_control_the_kind_does_not_list(toy_bench, capsys):
    bench, folder = toy_bench
    readings = load_module(BENCH_DIR / "tools" / "readings.py")
    runs = readings.plan(load_cell("toy-offline", bench, folder), [1, 2, 3, 4],
                         ["program", "w8a8", "fp8"])
    assert runs == [("program", s) for s in (1, 2, 3, 4)] + [("fp8", s) for s in (1, 2, 3)]
    assert "skipped w8a8: kinds/toy.py lists only fp8, tf32-align" in capsys.readouterr().err
    both = {"w8a8", "fp8", "tf32-align"}
    assert set(kind("da3").CONTROLS) == set(kind("nested").CONTROLS) == both
