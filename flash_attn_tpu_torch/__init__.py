"""PyTorch + CUDA port of flash_attn_tpu for one NVIDIA H100.

The serving, training, engine, varlen and absorbed-MLA slices:
``flash_attn_func`` and ``flash_attn_varlen_func`` (both differentiable;
the latter also over a paged cache, forward only, with the MLA second
query ``qv``) with their packed forms, ``get_scheduler_metadata``,
``flash_attn_with_kvcache`` over a linear or paged cache (with ``qv`` and
a value width that differs from the key width), and the modules, GPT and
BERT models, greedy generation, continuous-batching engine, losses and
single-GPU trainer above them.
Imports torch only; the CUDA kernels are built on first use. Entry points
build on the CUDA card unless given ``device="cpu"``.
"""

from flash_attn_tpu_torch.cache.kvcache import flash_attn_with_kvcache
from flash_attn_tpu_torch.dispatch.scheduler_metadata import (
    get_scheduler_metadata,
)
from flash_attn_tpu_torch.interface import (
    flash_attn_func,
    flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func,
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_varlen_qkvpacked_func,
)

__all__ = ["flash_attn_func", "flash_attn_kvpacked_func",
           "flash_attn_qkvpacked_func", "flash_attn_varlen_func",
           "flash_attn_varlen_kvpacked_func",
           "flash_attn_varlen_qkvpacked_func", "flash_attn_with_kvcache",
           "get_scheduler_metadata"]
