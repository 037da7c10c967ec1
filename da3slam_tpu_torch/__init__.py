"""da3slam_tpu_torch — the PyTorch/CUDA port of ``da3slam_tpu``.

Same subpackage layout as the JAX package, which stays the reference the
port is tested against:

- ``core``   : SE(3)/Sim(3) algebra + pinhole geometry
- ``models`` : the DA3 multi-view ViT (encoder, DPT head, camera head), its
               W8A8 variant, checkpoint directories
- ``ops``    : attention and the probe kernels (hand-written CUDA), int8
               quantization, resize, ICP, registration
- ``slam``   : chunking, chunk alignment, the streaming solver, the
               device-resident pipeline
- ``inout``  : config / image / trajectory / PLY I/O, the prefetcher
- ``parallel``: the single-device train step and its checkpoints
- ``tools``  : kernel probes
- ``cli``    : ``main_slam``, ``main_align``, ``train``

The package imports torch and never jax.
"""

__version__ = "0.1.0"
