"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel ported.

Each kernel module holds the wrapper (checks, allocation, launch count) and
the plain PyTorch version that the wrapper runs for CPU tensors.
"""
