"""Kernels of the port: a CUDA C++ kernel and a plain PyTorch version each."""
