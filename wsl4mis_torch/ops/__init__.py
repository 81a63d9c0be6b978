"""Kernels (CUDA, with plain PyTorch versions) and losses of the port."""
