"""Tensor ops of the port: plain PyTorch, plus the CUDA kernels' wrappers."""
