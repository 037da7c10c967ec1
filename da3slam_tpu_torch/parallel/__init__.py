"""Training (counterpart of ``da3slam_tpu/parallel``): the single-device
train step and its checkpoints.  The mesh, sharding, ring attention and the
sp/pp steps are not ported yet."""
