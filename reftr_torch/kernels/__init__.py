"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

Sources live in ``csrc/``; ``_nvcc`` builds them on first use.
"""
