"""``correct`` comes out false under the controls and under each fault the
cells can have, at the test size on the CPU: the harness's run with its look
for a card skipped, the timed path broken underneath."""

from __future__ import annotations

import time

import pytest
import torch

from slambench.lib import check
from slambench.lib.drive import run_cell
from slambench.lib.spec import load_cell


def verdict(bench, folder, name="tiny-offline", control=None, seconds=2.0):
    cell = load_cell(name, bench, folder)
    run, built = run_cell(cell, 2**31 + 23, seconds, False, time.perf_counter(),
                          torch.device("cpu"), control)
    numbers = check.compare(run, built, torch.device("cpu"), control)
    return check.verdict(numbers, cell.settings["limits"])


@pytest.mark.parametrize("control", ["w8a8", "fp8"])
def test_controls_come_out_not_correct(tiny_bench, control):
    correct, checks = verdict(*tiny_bench, control=control)
    assert not correct, checks


def _state_unchanged(original):
    def align(*args, **kwargs):
        out = original(*args, **kwargs)
        prev = kwargs["prev_overlap_global"]
        return out._replace(extrinsics_global=prev.expand_as(out.extrinsics_global).clone(),
                            prev_overlap_for_next=prev)
    return align


def _pose_altered(original):
    def align(*args, **kwargs):
        out = original(*args, **kwargs)
        eg = out.extrinsics_global.clone()
        eg[..., 3] += 1e-3
        return out._replace(extrinsics_global=eg)
    return align


def _half_the_views(original):
    def inference(self, *args, **kwargs):
        pred = original(self, *args, **kwargs)
        half = len(pred.depth) // 2
        for field in (pred.depth, pred.conf):  # the second half: the mean of the first
            field[half:] = field[:half].mean(axis=0)
        return pred
    return inference


def _depth_altered(original):
    def inference(self, *args, **kwargs):
        pred = original(self, *args, **kwargs)
        pred.depth[0] *= 1.01
        return pred
    return inference


@pytest.mark.parametrize("fault", ["state_unchanged", "pose_altered", "half_the_views",
                                   "depth_altered"])
def test_faults_come_out_not_correct(tiny_bench, monkeypatch, fault):
    from da3slam_tpu_torch.models.da3 import DepthAnything3
    from da3slam_tpu_torch.slam import solver

    if fault in ("state_unchanged", "pose_altered"):
        wrap = _state_unchanged if fault == "state_unchanged" else _pose_altered
        monkeypatch.setattr(solver, "align_chunk_single_overlap",
                            wrap(solver.align_chunk_single_overlap))
        name = "align_gap"
    else:
        wrap = _half_the_views if fault == "half_the_views" else _depth_altered
        monkeypatch.setattr(DepthAnything3, "inference", wrap(DepthAnything3.inference))
        name = "depth_rel"
    for cell in ("tiny-offline", "tiny-live"):
        correct, checks = verdict(*tiny_bench, name=cell, seconds=4.0 if "live" in cell else 2.0)
        assert not correct and checks[name]["value"] > checks[name]["limit"], (cell, checks)
