"""Kernel wrappers: each launches its CUDA kernel (csrc/) on CUDA tensors and runs its plain PyTorch version on CPU tensors."""
