"""da3slam_tpu_torch — the PyTorch/CUDA port of ``da3slam_tpu``.

Same subpackage layout as the JAX package, which stays the reference the
port is tested against:

- ``core``   : SE(3)/Sim(3) algebra + pinhole geometry
- ``models`` : the DA3 multi-view ViT (encoder, DPT head, camera head)
- ``ops``    : attention (a hand-written CUDA kernel), resize, ICP, Umeyama
- ``slam``   : chunking, chunk alignment, the streaming solver
- ``inout``  : config / image / trajectory I/O
- ``cli``    : ``main_slam``

The package imports torch and never jax.
"""

__version__ = "0.1.0"
