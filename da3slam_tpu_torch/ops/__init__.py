"""Attention and the probe kernels (CUDA kernels + plain versions), int8
quantization, resize, ICP and registration."""
