"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each wrapper takes its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors; the kernel library is built on first launch
(``_build``), never at import.
"""
