"""What each spawned rank of the multi-rank tests runs
(``tests/test_torch_parallel.py``, ``tests/test_torch_pipeline.py``).

Spawned ranks import this module by name, so it imports only numpy, torch
and the port: no rank may import JAX or the JAX package (each reports what
it imported).  The bodies return numpy from rank 0; what every rank computed
is gathered there first.  No tests here.
"""

import hashlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from da3slam_tpu_torch.models.config import get_preset
from da3slam_tpu_torch.models.da3 import DA3Net
from da3slam_tpu_torch.parallel import comm
from da3slam_tpu_torch.parallel.mesh import make_mesh
from da3slam_tpu_torch.parallel.pp_forward import make_pp_encode, split_encoder_params
from da3slam_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_flash
from da3slam_tpu_torch.parallel.sp_forward import make_sharded_forward
from da3slam_tpu_torch.slam.pipeline import run_streaming_slam, split_params_pp

CFG = get_preset("tiny")


def foreign_modules() -> list[str]:
    return sorted(m for m in sys.modules if m in ("jax", "da3slam_tpu")
                  or m.startswith(("jax.", "jaxlib", "da3slam_tpu.")))


def gather(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def net_from(state: dict) -> DA3Net:
    net = DA3Net(CFG)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return net.eval()


def axis_mesh(name: str) -> DeviceMesh:
    return DeviceMesh("cpu", torch.arange(dist.get_world_size()), mesh_dim_names=(name,))


def mesh_cases(cases: list[tuple]) -> list:
    """``make_mesh(n_devices, tp)`` for each case: ``(dim names, shape, this
    rank's dp and tp coordinates)`` or ``("ValueError", message)``."""
    out = []
    for n, tp in cases:
        try:
            m = make_mesh(n, tp, device="cpu")
        except ValueError as e:
            out.append(("ValueError", str(e)))
            continue
        coord = tuple(m.get_local_rank(a) for a in m.mesh_dim_names) \
            if dist.get_rank() < m.mesh.numel() else None
        out.append((m.mesh_dim_names, tuple(m.mesh.shape), coord))
    return out


def ring_cases(cases: dict) -> dict:
    """Each case's ``(q, k, v)`` ``[B, S, H, D]`` split on S over the ring:
    the whole output of the ring (plain online softmax) and of the card's
    schedule (bound forward per hop, folded by lse; its plain version here)."""
    r, n = dist.get_rank(), dist.get_world_size()
    group = axis_mesh("sp").get_group("sp")
    out = {}
    for name, (q, k, v) in cases.items():
        s = q.shape[1] // n
        shard = [torch.from_numpy(np.ascontiguousarray(t[:, r * s:(r + 1) * s])) for t in (q, k, v)]
        out[name] = {impl: np.concatenate(gather(fn(*shard, group).numpy()), axis=1)
                     for impl, fn in (("plain", ring_attention), ("flash", ring_attention_flash))}
    return out


def sp_forward(state: dict, images: np.ndarray) -> dict:
    """``make_sharded_forward`` on a ``("dp", "tp")`` mesh: the prediction,
    and each rank's digest of it (every rank returns the whole)."""
    fwd = make_sharded_forward(CFG, make_mesh(tp=1, device="cpu"))
    pred = {k: t.numpy() for k, t in fwd(net_from(state), torch.from_numpy(images)).items()}
    return {"pred": pred, "digests": gather(digest(pred.values()))}


def pp_encode(state: dict, images_mb: np.ndarray) -> dict:
    """``make_pp_encode`` over a ``("pp",)`` mesh of every rank: taps, final,
    each rank's digest of them and each rank's parameter count."""
    n = dist.get_world_size()
    net = net_from(state)
    blocks, rest = split_encoder_params(net, n, dist.get_rank())
    del net
    taps, final = make_pp_encode(CFG, axis_mesh("pp"))(blocks, rest, torch.from_numpy(images_mb))
    taps, final = taps.numpy(), final.numpy()
    params = sum(p.numel() for m in (blocks, rest) for p in m.parameters())
    return {"taps": taps, "final": final, "digests": gather(digest([taps, final])),
            "params": gather(params)}


def parallel_checks(mesh: list, ring: dict, state: dict, images: np.ndarray | None,
                    images_mb: np.ndarray) -> dict:
    """One spawn's worth of ``tests/test_torch_parallel.py``: the mesh cases,
    the ring cases, the pp encoder and (given images) the sp forward."""
    out = {"mesh": gather(mesh_cases(mesh)), "ring": ring_cases(ring),
           "pp": pp_encode(state, images_mb)}
    if images is not None:
        out["sp"] = sp_forward(state, images)
    out["foreign"] = gather(foreign_modules())
    out["host_bytes"] = gather(comm.host_bytes)
    return out


def slam_runs(state: dict, frames: np.ndarray, mesh_kind: str, runs: dict) -> dict:
    """``run_streaming_slam(parallel=mesh_kind)`` on every rank for each named
    keyword set of ``runs`` (``no_mesh``: ``mesh=None``; ``pp_share``: this
    rank's ``split_params_pp`` share in place of the network) over one mesh:
    ``"dp"`` is ``make_mesh(world, tp=1)``, ``"sp"`` and ``"pp"`` a one-axis
    mesh of that name.  Rank 0's outputs, every rank's
    digest of its outputs, and what each rank imported."""
    net = net_from(state)
    mesh = make_mesh(tp=1, device="cpu") if mesh_kind == "dp" else axis_mesh(mesh_kind)
    outs, digests = {}, {}
    for name, kw in runs.items():
        kw = dict(kw)
        if kw.pop("no_mesh", False):
            out = run_streaming_slam(net, frames, CFG, **kw)
        else:
            share = split_params_pp(net, dist.get_world_size(), mesh) \
                if kw.pop("pp_share", False) else net
            out = run_streaming_slam(share, frames, CFG, mesh=mesh, parallel=mesh_kind, **kw)
        outs[name] = [np.asarray(t) for t in out]
        digests[name] = gather(digest(outs[name]))
    return {"outs": outs, "digests": digests, "foreign": gather(foreign_modules())}


def rank_and_world() -> tuple[int, int]:
    return dist.get_rank(), dist.get_world_size()


def fail_on_rank(bad: int | None) -> None:
    """Rank ``bad`` raises while the others wait for a message from it;
    ``bad=None``: every rank hangs."""
    if bad is None:
        time.sleep(3600)
    if dist.get_rank() == bad:
        raise RuntimeError(f"boom on rank {bad}")
    dist.recv(torch.empty(1), src=bad)


def exit_on_rank(bad: int) -> None:
    """Rank ``bad`` dies without a report; the others hang."""
    if dist.get_rank() == bad:
        os._exit(3)
    time.sleep(3600)
