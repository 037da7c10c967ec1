"""Attention (CUDA kernel + plain version), resize, ICP and registration."""
