"""PyTorch + CUDA port of flash_attn_tpu for one NVIDIA H100.

The serving and training slices: ``flash_attn_func`` (differentiable),
``flash_attn_with_kvcache`` over a linear cache, and the modules, GPT
model, greedy generation, losses and single-GPU trainer above them. Imports
torch only; the CUDA kernels are built on first use.
"""

from flash_attn_tpu_torch.cache.kvcache import flash_attn_with_kvcache
from flash_attn_tpu_torch.interface import flash_attn_func

__all__ = ["flash_attn_func", "flash_attn_with_kvcache"]
