"""PyTorch + CUDA port of flash_attn_tpu for one NVIDIA H100.

The serving, training and engine slices: ``flash_attn_func``
(differentiable), ``flash_attn_varlen_func`` over a paged cache,
``flash_attn_with_kvcache`` over a linear or paged cache, and the modules,
GPT model, greedy generation, continuous-batching engine, losses and
single-GPU trainer above them. Imports torch only; the CUDA kernels are
built on first use. Entry points build on the CUDA card unless given
``device="cpu"``.
"""

from flash_attn_tpu_torch.cache.kvcache import flash_attn_with_kvcache
from flash_attn_tpu_torch.interface import (
    flash_attn_func,
    flash_attn_varlen_func,
)

__all__ = ["flash_attn_func", "flash_attn_varlen_func",
           "flash_attn_with_kvcache"]
