"""Devices and training (counterpart of ``da3slam_tpu/parallel``): the
``(dp, tp)`` device mesh and the rank launcher (``mesh.py``), the
collectives and the differentiable Megatron operators (``comm.py``), the
tensor-parallel sharding rules (``sharding.py``), ring attention, the
view-sharded (sp) forward and the pipeline-parallel (pp) encoder, which
``slam/pipeline.py``'s multi-device SLAM runs; the train steps over them
(one device, dp×tp, sp and pp: ``train.py``) and their checkpoints.
"""

from da3slam_tpu_torch.parallel.mesh import make_mesh, run_ranks  # noqa: F401
from da3slam_tpu_torch.parallel.sharding import batch_sharding, param_shardings  # noqa: F401
from da3slam_tpu_torch.parallel.train import (  # noqa: F401
    TrainState,
    make_pp_train_step,
    make_sp_train_step,
    make_train_step,
    synthetic_batch,
)
