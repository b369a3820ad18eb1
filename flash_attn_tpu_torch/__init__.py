"""PyTorch + CUDA port of flash_attn_tpu for one NVIDIA H100.

The serving slice: ``flash_attn_func`` (forward), ``flash_attn_with_kvcache``
over a linear cache, and the modules, GPT model and greedy generation above
them. Imports torch only; the CUDA kernels are built on first use.
"""

from flash_attn_tpu_torch.cache.kvcache import flash_attn_with_kvcache
from flash_attn_tpu_torch.interface import flash_attn_func

__all__ = ["flash_attn_func", "flash_attn_with_kvcache"]
