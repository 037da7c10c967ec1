"""The port's ``utils/profiling.py`` against ``da3slam_tpu.utils.profiling``:
``force_completion`` on nested structures, ``StageTimer``'s JAX signature
(``result=`` and the yielded box) with its report and reset, and
``profile_trace`` writing a Chrome trace on the CPU.  On the card,
``chip_smoke.py`` (phase profile_trace) holds the trace to naming the flash
forward kernel."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import pytest
import torch

from da3slam_tpu.utils import profiling as jprof
from da3slam_tpu_torch.utils import profiling as prof


class _Pair(NamedTuple):
    a: object
    b: object


@dataclass
class _Box:
    first: object
    second: object


@pytest.mark.parametrize("tree,path", [
    (torch.ones(2), ()),
    ({"x": [None, (3, torch.zeros(1))], "y": torch.ones(1)}, ("x", 1, 1)),
    ({"b": torch.ones(1), "a": torch.zeros(1)}, ("a",)),  # keys sorted, as JAX's leaves
    (_Pair(np.ones(2), torch.arange(3)), (1,)),
    (_Box(first={"k": 1.0}, second=[torch.full((2,), 7.0)]), ("second", 0)),
    ([1, "a", np.zeros(3)], None),
    ({}, None),
])
def test_force_completion_takes_the_first_tensor(tree, path, monkeypatch):
    """The first tensor of the structure; on the CPU nothing is waited for,
    and a structure without a tensor is a no-op."""
    got = prof._first_tensor(tree)
    if path is None:
        assert got is None
    else:
        want = tree
        for key in path:
            want = getattr(want, key) if isinstance(want, _Box) else want[key]
        assert got is want
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(a))
    prof.force_completion(tree)
    assert synced == []


def test_force_completion_waits_for_the_cuda_device(monkeypatch):
    """A tensor on a CUDA device: that device is synchronised (a stand-in
    tensor type, since this machine has no card)."""

    class Fake:
        device = torch.device("cuda", 1)

    monkeypatch.setattr(prof, "_first_tensor", lambda x: Fake())
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(d))
    prof.force_completion([1])
    assert synced == [torch.device("cuda", 1)]


class TestStageTimer:
    def test_accumulates_and_reports_as_jax(self):
        """``tests/test_misc.py::TestStageTimer``'s run in both packages."""
        reports = []
        for mod in (jprof, prof):
            t = mod.StageTimer(sync=False)
            for _ in range(3):
                with t("work"):
                    time.sleep(0.01)
            with t("other"):
                pass
            assert t.counts == {"work": 3, "other": 1}
            assert t.totals["work"] >= 0.03
            reports.append([ln.split()[0] for ln in t.report().splitlines()])
            t.reset()
            assert not t.totals and not t.counts and not t.firsts
            assert t.report() == "(no stages timed)"
        assert reports[0] == reports[1] == ["work", "other"]

    @pytest.mark.parametrize("how", ["argument", "box", "none"])
    def test_result_decides_what_is_waited_for(self, how, monkeypatch):
        """``result=`` or ``box["result"]`` (the box wins, as in JAX) is
        handed to ``force_completion``; without one, a CUDA-initialised
        process waits for the whole device (here: never initialised)."""
        seen = []
        monkeypatch.setattr(prof, "force_completion", seen.append)
        t = prof.StageTimer(sync=True)
        arg, boxed = torch.ones(1), torch.zeros(1)
        with t("s", result=arg if how == "argument" else None) as box:
            assert box == {}
            if how == "box":
                box["result"] = boxed
        assert seen == {"argument": [arg], "box": [boxed], "none": []}[how]
        with t("s", result=arg) as box:
            box["result"] = boxed
        assert seen[-1] is boxed
        assert t.counts["s"] == 2
        seen.clear()
        with prof.StageTimer(sync=False)("s", result=arg):
            pass
        assert seen == []


class TestProfileTrace:
    def test_writes_a_chrome_trace_on_the_cpu(self, tmp_path):
        d = tmp_path / "trace"
        with prof.profile_trace(d, device="cpu") as got:
            assert got == d
            x = torch.randn(64, 64)
            (x @ x).sum()
        trace = json.loads((d / prof.TRACE_FILE).read_text())
        names = {e.get("name", "") for e in trace["traceEvents"]}
        assert any("aten::mm" in n for n in names)

    def test_an_exception_in_the_block_propagates(self, tmp_path):
        with pytest.raises(ZeroDivisionError):
            with prof.profile_trace(tmp_path / "t", device="cpu"):
                1 / 0

    def test_a_profiler_that_cannot_start_runs_untraced_on_the_cpu(self, tmp_path, capsys,
                                                                    monkeypatch):
        import torch.profiler

        class Broken:
            def __init__(self, **kw):
                pass

            def __enter__(self):
                raise RuntimeError("no profiler here")

        monkeypatch.setattr(torch.profiler, "profile", Broken)
        with prof.profile_trace(tmp_path / "t", device="cpu") as got:
            ran = True
        assert ran and got is None
        assert capsys.readouterr().out == ("profiler unavailable (no profiler here); "
                                           "running without trace\n")
        assert not (tmp_path / "t").exists()
        with pytest.raises(RuntimeError, match="no profiler here"):
            with prof.profile_trace(tmp_path / "t", device="cuda"):
                pass
