"""reftr_torch: the PyTorch/CUDA port of reftr_tpu, for one NVIDIA H100.

Imports torch and numpy only; nothing of JAX or of reftr_tpu.
"""
