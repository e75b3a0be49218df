"""Ops with hand-written CUDA kernels and their plain PyTorch versions.
Importing the package registers every kernel wrapper with ``kernels``."""
from . import flash_attention, fused_adamw, kernels, paged_attention

__all__ = ["flash_attention", "fused_adamw", "kernels", "paged_attention"]
