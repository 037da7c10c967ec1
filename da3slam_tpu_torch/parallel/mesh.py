"""Mesh construction and the rank launcher (counterpart of
``da3slam_tpu/parallel/mesh.py``).

Every rank runs the same program (SPMD): ``make_mesh`` lays the ranks of the
initialised default process group out as a ``("dp", "tp")``
``DeviceMesh``, with the JAX package's rules for the default ``tp`` and its
errors.  ``run_ranks`` starts such a program: it spawns the ranks, meets
them through a ``FileStore`` in a temporary directory (no network port), and
returns rank 0's result or re-raises the first failing rank's traceback.  It
is what XLA's ``--xla_force_host_platform_device_count`` gives the JAX tests:
several devices on one machine.  ``one_rank_group`` runs such a program in
the calling process as a group of one.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def mesh_shape(n: int, tp: int | None = None) -> tuple[int, int]:
    """``(dp, tp)`` for ``n`` devices: tp defaults to 2 at >= 4 devices when
    the count is even (every DA3 tier's head count divides by 2), dp takes the
    rest."""
    if tp is None:
        tp = 2 if (n >= 4 and n % 2 == 0) else 1
    if n % tp != 0:
        raise ValueError(f"tp={tp} must divide device count {n}")
    return n // tp, tp


def make_mesh(n_devices: int | None = None, tp: int | None = None,
              device: str = "cuda") -> DeviceMesh:
    """A ``("dp", "tp")`` mesh over ranks ``0 .. n_devices - 1`` of the default
    process group (all of them by default), dp-major.  Call it on every rank;
    ``device`` is the mesh's device type."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(run the ranks with run_ranks, or call init_process_group)")
    world = dist.get_world_size()
    if n_devices is not None and world < n_devices:
        raise ValueError(
            f"make_mesh(n_devices={n_devices}) but only {world} devices are visible "
            f"({device}); a silently truncated mesh would validate nothing")
    n = world if n_devices is None else n_devices
    dp, tp = mesh_shape(n, tp)
    return DeviceMesh(device, torch.arange(n).reshape(dp, tp), mesh_dim_names=("dp", "tp"))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no {axis!r} axis (axes {mesh.mesh_dim_names})")
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _init_group(rank, world_size, backend, device, timeout_s, store_path, card=None) -> None:
    kw = {}
    if device == "cuda":
        card = torch.device("cuda", rank % torch.cuda.device_count()) if card is None else card
        torch.cuda.set_device(card)
        if backend == "nccl":
            kw["device_id"] = card  # NCCL binds its communicator to the card
    dist.init_process_group(backend, store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)


@contextlib.contextmanager
def one_rank_group(backend: str, device: str, timeout_s: float):
    """The default process group as a group of this process alone (on
    ``device="cuda"``, the current card), for the program a mesh of one runs."""
    card = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else None
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        _init_group(0, 1, backend, device, timeout_s, os.path.join(tmp, "store"), card)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank, world_size, backend, device, timeout_s, store_path, results, fn, args):
    """One spawned rank: join the group, run ``fn(*args)``, report, leave.  A
    failure is reported with its traceback before it ends the process."""
    torch.set_num_threads(1)
    try:
        _init_group(rank, world_size, backend, device, timeout_s, store_path)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    try:
        out = fn(*args)
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def _failures(results, failed: dict, world_size: int, grace_s: float = 2.0) -> str:
    """The first failure's report, with any other rank's that follows within
    ``grace_s`` (a peer of the failing rank often fails next, in a collective
    the failed rank left), in rank order."""
    end = time.monotonic() + grace_s
    while time.monotonic() < end:
        try:
            rank, ok, payload = results.get(timeout=max(end - time.monotonic(), 0.01))
        except queue.Empty:
            break
        if not ok:
            failed[rank] = payload
    return "\n".join(f"rank {r} of {world_size} failed:\n{failed[r]}" for r in sorted(failed))


def run_ranks(fn, world_size: int, backend: str, device: str, timeout_s: float, *args,
              whole_run_deadline: bool = True):
    """Run ``fn(*args)`` on ``world_size`` spawned ranks of one process group
    and return rank 0's result.

    ``fn`` must be importable by the spawned processes (a module-level
    function) and its arguments and rank 0's result picklable.  ``backend``
    (``"gloo"`` or ``"nccl"``) is passed as given.  On ``device="cuda"`` rank
    r takes card ``r % device_count``.  The group's collectives time out after
    ``timeout_s``; so does the whole run unless ``whole_run_deadline`` is
    False (a training run of any length): then, or as soon as one rank fails,
    every rank is killed and the failure (with the rank's traceback) is
    raised here.
    """
    ctx = multiprocessing.get_context("spawn")
    deadline = time.monotonic() + timeout_s if whole_run_deadline else math.inf
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world_size, backend, device, timeout_s,
                                   os.path.join(tmp, "store"), results, fn, args))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            done: dict[int, object] = {}
            while len(done) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world_size} ranks did not finish within {timeout_s} s "
                                       f"(finished: {sorted(done)})")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if not dead:
                        continue
                    try:  # a report the rank sent just before it ended
                        rank, ok, payload = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank {dead[0]} died with exit code "
                                           f"{procs[dead[0]].exitcode}") from None
                if not ok:
                    raise RuntimeError(_failures(results, {rank: payload}, world_size))
                done[rank] = payload
            for p in procs:
                p.join(min(max(deadline - time.monotonic(), 0.1), timeout_s))
            return done[0]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5)
            results.close()
