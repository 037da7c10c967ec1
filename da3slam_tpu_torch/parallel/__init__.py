"""Devices and training (counterpart of ``da3slam_tpu/parallel``): the
``(dp, tp)`` device mesh and the rank launcher (``mesh.py``), the
collectives of the multi-device paths (``comm.py``), ring attention, the
view-sharded (sp) forward and the pipeline-parallel (pp) encoder, which
``slam/pipeline.py``'s multi-device SLAM runs; the single-device train step
and its checkpoints.  The Megatron sharding rules and the dp×tp, sp and pp
train steps are not ported yet.
"""

from da3slam_tpu_torch.parallel.mesh import make_mesh, run_ranks  # noqa: F401
