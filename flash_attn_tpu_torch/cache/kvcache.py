"""KV-cache decode attention over a linear cache.

Port of flash_attn_tpu/cache/kvcache.py ``kv_cache_update`` (:30) and
``flash_attn_with_kvcache`` (:125). The caches keep the JAX layout
(batch_cache, kv_heads, seqlen_max, head_dim). Where the JAX functions
return new caches, these update the given caches in place and return only
the attention output.
"""

import math
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.config import (
    DECODE_BLOCK_K,
    normalize_window,
    num_splits_heuristic,
)
from flash_attn_tpu_torch.interface import reject_unsupported, require_no_grad
from flash_attn_tpu_torch.kernels.flash_decode import flash_attention_decode
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb

__all__ = ["flash_attn_with_kvcache", "kv_cache_update"]


def kv_cache_update(k_cache, v_cache, k_new, v_new, cache_seqlens):
    """Write k_new/v_new (b, s_new, h_k, d) into cache rows 0..b-1 at
    positions cache_seqlens[i] + [0, s_new), in place: one indexed
    assignment per cache, no copy of the cache and no host sync on the
    offsets. Returns the same (k_cache, v_cache)."""
    b, s_new = k_new.shape[:2]
    pos = (cache_seqlens.to(k_cache.device, torch.long)[:, None]
           + torch.arange(s_new, device=k_cache.device)[None, :])
    rows = torch.arange(b, device=k_cache.device)[:, None].expand(b, s_new)
    # Advanced indices on dims 0 and 2 around a slice: the indexed block
    # is (b, s_new, h_k, d), the layout of k_new.
    k_cache[rows, :, pos] = k_new.to(k_cache.dtype)
    v_cache[rows, :, pos] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def _default_num_splits(q, k_cache) -> int:
    """Enough splits to give every SM of the card a block (one split on the
    CPU, which has no such cores)."""
    if q.device.type != "cuda":
        return 1
    b, sq, h, d = q.shape
    h_k, s_max = k_cache.shape[1], k_cache.shape[2]
    rows = sq * (h // h_k)
    blocks = b * h_k * -(-rows // 8)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    kv_tiles = -(-s_max // DECODE_BLOCK_K)
    return num_splits_heuristic(blocks, sms, kv_tiles)


def flash_attn_with_kvcache(
    q,        # (b, sq, h, d)
    k_cache,  # (b_c, h_k, s_max, d), updated in place when k/v are given
    v_cache,
    k=None,   # (b, s_new, h_k, d) new keys to append
    v=None,
    qv=None,
    rotary_cos=None,  # (s_rot, rot_dim / 2)
    rotary_sin=None,
    cache_seqlens=None,  # (b,) int tensor or int: lengths before the append
    rotary_seqlens=None,
    cache_batch_idx=None,
    cache_leftpad=None,
    block_table=None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[Optional[int], Optional[int]] = (-1, -1),
    softcap: float = 0.0,
    attention_chunk: int = 0,
    rotary_interleaved: bool = False,
    alibi_slopes=None,
    q_descale=None,
    k_descale=None,
    v_descale=None,
    num_splits: int = 0,
    return_softmax_lse: bool = False,
):
    """Decode attention against a linear KV cache.

    With ``k``/``v`` given, they are rotated (when ``rotary_cos`` is given)
    at positions ``cache_seqlens`` and appended at those positions, IN
    PLACE: ``k_cache`` and ``v_cache`` are mutated, and the call returns
    only ``out`` (b, sq, h, d), or ``(out, lse)`` with
    ``return_softmax_lse``. q is rotated at the same positions. Attention
    runs over the first ``cache_seqlens + s_new`` keys of each row; causal
    masking is bottom-right aligned. ``num_splits`` <= 0 picks a split
    count that fills the card. The paged cache, cache_batch_idx,
    cache_leftpad, window, softcap, chunking, ALiBi, descales, qv and
    rotary_seqlens are not ported and raise NotImplementedError.
    """
    reject_unsupported(
        "flash_attn_with_kvcache", qv=qv, rotary_seqlens=rotary_seqlens,
        cache_batch_idx=cache_batch_idx, cache_leftpad=cache_leftpad,
        block_table=block_table,
        window_size=normalize_window(tuple(window_size)), softcap=softcap,
        attention_chunk=attention_chunk, alibi_slopes=alibi_slopes,
        q_descale=q_descale, k_descale=k_descale, v_descale=v_descale)
    require_no_grad("flash_attn_with_kvcache", q, k, v)
    b, sq, h, d = q.shape
    if cache_seqlens is None:
        cache_seqlens = torch.full((b,), k_cache.shape[2], dtype=torch.int32,
                                   device=q.device)
    elif isinstance(cache_seqlens, int):
        cache_seqlens = torch.full((b,), cache_seqlens, dtype=torch.int32,
                                   device=q.device)
    cache_seqlens = cache_seqlens.to(q.device, torch.int32)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)

    s_new = 0
    if k is not None:
        s_new = k.shape[1]
        if rotary_cos is not None:
            k = apply_rotary_emb(k, rotary_cos, rotary_sin,
                                 interleaved=rotary_interleaved,
                                 seqlen_offsets=cache_seqlens)
        kv_cache_update(k_cache, v_cache, k, v, cache_seqlens)
    if rotary_cos is not None:
        q = apply_rotary_emb(q, rotary_cos, rotary_sin,
                             interleaved=rotary_interleaved,
                             seqlen_offsets=cache_seqlens)
    if num_splits <= 0:
        num_splits = _default_num_splits(q, k_cache)
    out, lse = flash_attention_decode(
        q, k_cache, v_cache, cache_seqlens + s_new,
        softmax_scale=softmax_scale, causal=causal, num_splits=num_splits)
    return (out, lse) if return_softmax_lse else out
