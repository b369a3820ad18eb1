"""Quantized KV caches: the 1-byte store, the cache types the kernels read,
and the descales as the kernels take them.

Port of the JAX package's quantized-cache serving (``GPTConfig.
kv_cache_dtype``, flash_attn_tpu/modules/mha.py:96-102): K/V are stored as
x / kv_cache_scale in a 1-byte type and attended with (b, h_k) fp32
descales, q·k scaled by q_descale · k_descale and the output by v_descale
(flash_attn_tpu/kernels/flash_decode.py:289-301,
flash_varlen_paged.py:437-445).

The store (:func:`quantize_kv`) departs from JAX's ``astype``
(flash_attn_tpu/cache/kvcache.py:62-63) where that cast is wrong
(ROADMAP.md queue C): float8_e4m3fn rounds to nearest even and saturates at
±448, where JAX's gives NaN past 464 (the two agree bitwise for |x| <= 464);
int8 rounds to nearest even and clamps to [-127, 127], as JAX's own test
quantizes (tests/test_fp8.py:72-75), where JAX's ``astype`` truncates toward
zero and saturates at -128.
"""

from typing import Optional

import torch

# The 1-byte cache types the decode kernel B4 (d = dv route) and the paged
# prefill B8 (through csrc/kv_dequant.cu) read on the card, and the code
# each C entry point takes for them (csrc/kv8.cuh; 0: the cache has q's
# 2-byte type).
KV_CODES = {torch.float8_e4m3fn: 1, torch.int8: 2}
KV_CACHE_DTYPES = tuple(KV_CODES)

E4M3_MAX = 448.0
INT8_MAX = 127.0


def is_quantized(dtype) -> bool:
    """Whether a cache of this type holds 1-byte codes the kernels convert."""
    return dtype in KV_CACHE_DTYPES


def quantize_kv(x, dtype):
    """x (any float type) as the cache type ``dtype``: float8_e4m3fn rounds
    to nearest even and saturates at ±448; int8 rounds to nearest even and
    clamps to [-127, 127]; any other type is a plain cast."""
    if dtype == torch.float8_e4m3fn:
        return x.clamp(-E4M3_MAX, E4M3_MAX).to(dtype)
    if dtype == torch.int8:
        return torch.round(x.float()).clamp_(-INT8_MAX, INT8_MAX).to(dtype)
    return x.to(dtype)


def as_store(cache):
    """A view of ``cache`` that an indexed assignment writes into: float8
    caches as uint8 (their bytes), others as they are."""
    return cache.view(torch.uint8) if cache.dtype == torch.float8_e4m3fn \
        else cache


def check_cache_dtype(kernel: str, cache_dtype, dtype) -> None:
    """Raise unless a kernel on the card can read a cache of
    ``cache_dtype`` beside activations of ``dtype``: the same 2-byte type,
    or a 1-byte type of KV_CACHE_DTYPES."""
    if cache_dtype != dtype and not is_quantized(cache_dtype):
        raise NotImplementedError(
            f"{kernel}: a {cache_dtype} KV cache beside {dtype} activations "
            f"is not ported yet on the card; the kernels read the model's "
            f"own type or {KV_CACHE_DTYPES} (others are ROADMAP.md queue A, "
            "item 7)")


def combined_descales(b: int, h_k: int, q_descale=None, k_descale=None,
                      v_descale=None, device=None):
    """(qk, v): the (b, h_k) fp32 descales of the scores (q_descale ·
    k_descale) and of the output, a missing one counting as ones, as JAX
    combines them (flash_decode.py:292-301); (None, None) without any."""
    if q_descale is None and k_descale is None and v_descale is None:
        return None, None

    def rows(x) -> Optional[torch.Tensor]:
        if x is None:
            return None
        x = torch.as_tensor(x, device=device).float()
        if x.shape != (b, h_k):
            raise ValueError(f"descales are (b, h_k) = {(b, h_k)}, got "
                             f"{tuple(x.shape)}")
        return x

    qd, kd, vd = rows(q_descale), rows(k_descale), rows(v_descale)
    if qd is None and kd is None:
        qk = torch.ones((b, h_k), dtype=torch.float32, device=device)
    elif qd is None or kd is None:
        qk = (kd if qd is None else qd).contiguous()
    else:
        qk = (qd * kd).contiguous()
    if vd is None:
        vd = torch.ones((b, h_k), dtype=torch.float32, device=device)
    return qk, vd.contiguous()
