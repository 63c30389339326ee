"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), each
beside a plain PyTorch version with the same math."""
