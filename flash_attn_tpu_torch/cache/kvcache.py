"""KV-cache decode attention over a linear or a paged cache.

Port of flash_attn_tpu/cache/kvcache.py ``kv_cache_update`` (:30) and
``flash_attn_with_kvcache`` (:125). The caches keep the JAX layouts:
linear (batch_cache, kv_heads, seqlen_max, head_dim), paged (num_pages,
kv_heads, page_size, head_dim) with a (batch, max_pages) int32 block
table. Where the JAX functions return new caches, these update the given
caches in place and return only the attention output.
"""

from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.config import (
    DECODE_BLOCK_K,
    decode_rows_per_block,
    default_scale,
    normalize_window,
    num_splits_heuristic,
)
from flash_attn_tpu_torch.interface import reject_unsupported, require_no_grad
from flash_attn_tpu_torch.kernels.flash_decode import (
    cache_capacity,
    flash_attention_decode,
)
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb

__all__ = ["flash_attn_with_kvcache", "kv_cache_update"]


def kv_cache_update(k_cache, v_cache, k_new, v_new, cache_seqlens,
                    block_table=None, cache_batch_idx=None, new_lengths=None):
    """Write k_new (b, s_new, h_k, d) and v_new (b, s_new, h_k, dv) into the
    caches at positions
    cache_seqlens[i] + [0, s_new), in place, and return the same (k_cache,
    v_cache).

    Linear cache: row i writes cache row ``cache_batch_idx[i]`` (row i when
    None); like JAX's dynamic_update_slice, a start past s_max - s_new is
    moved back to it. Paged cache (``block_table`` (b, max_pages)):
    position p of row i is row p % page_size of page
    block_table[i, p // page_size], the column clamped to the table.
    ``new_lengths`` (b,) marks only the first new_lengths[i] tokens of a row
    as real; the paged path drops the padding tail's writes, as JAX's
    ``mode="drop"`` scatter does (a boolean selection, so one host sync: the
    admission path). Without it no write syncs: the one-token decode append
    is one indexed assignment per cache."""
    b, s_new = k_new.shape[:2]
    dev = k_cache.device
    offs = cache_seqlens.to(dev, torch.long)
    k_new = k_new.to(k_cache.dtype)
    v_new = v_new.to(v_cache.dtype)
    steps = torch.arange(s_new, device=dev)
    if block_table is not None:
        page_size = k_cache.shape[2]
        table = block_table.to(dev, torch.long)
        pos = offs[:, None] + steps[None, :]                     # (b, s_new)
        page = table.gather(1, (pos // page_size).clamp(max=table.shape[1] - 1))
        inpage = pos % page_size
        if new_lengths is not None:
            keep = steps[None, :] < new_lengths.to(dev, torch.long)[:, None]
            page, inpage = page[keep], inpage[keep]
            k_new, v_new = k_new[keep], v_new[keep]
        # Advanced indices on dims 0 and 2 around a slice: the indexed
        # block is (..., h_k, d), the layout of the new rows.
        k_cache[page, :, inpage] = k_new
        v_cache[page, :, inpage] = v_new
        return k_cache, v_cache
    rows = (torch.arange(b, device=dev) if cache_batch_idx is None
            else cache_batch_idx.to(dev, torch.long))
    start = offs.clamp(0, k_cache.shape[2] - s_new)
    pos = start[:, None] + steps[None, :]
    k_cache[rows[:, None], :, pos] = k_new
    v_cache[rows[:, None], :, pos] = v_new
    return k_cache, v_cache


def _default_num_splits(q, k_cache, v_cache, block_table, has_qv) -> int:
    """Enough splits to give every SM of the card a block (one split on the
    CPU, which has no such cores). A block holds 8 query rows on the d = dv
    route and a 64-row tile on the MLA route."""
    if q.device.type != "cuda":
        return 1
    b, sq, h, d = q.shape
    h_k = k_cache.shape[1]
    rows = sq * (h // h_k)
    per_block = decode_rows_per_block(d, v_cache.shape[-1], has_qv)
    blocks = b * h_k * -(-rows // per_block)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    kv_tiles = -(-cache_capacity(k_cache, block_table) // DECODE_BLOCK_K)
    return num_splits_heuristic(blocks, sms, kv_tiles)


def flash_attn_with_kvcache(
    q,        # (b, sq, h, d)
    k_cache,  # (b_c, h_k, s_max, d) or pages (num_pages, h_k, page_size, d)
    v_cache,
    k=None,   # (b, s_new, h_k, d) new keys to append
    v=None,   # (b, s_new, h_k, dv)
    qv=None,  # (b, sq, h, dv): the MLA second query, scored against V
    rotary_cos=None,  # (s_rot, rot_dim / 2)
    rotary_sin=None,
    cache_seqlens=None,  # (b,) int tensor or int: lengths before the append
    rotary_seqlens=None,
    cache_batch_idx=None,
    cache_leftpad=None,
    block_table=None,  # (b, max_pages) int32: the caches are paged
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
    pack_gqa: Optional[bool] = None,
    return_softmax_lse: bool = False,
):
    """Decode attention against a linear or a paged KV cache.

    With ``k``/``v`` given, they are rotated (when ``rotary_cos`` is given)
    at positions ``cache_seqlens`` and appended at those positions, IN
    PLACE: ``k_cache`` and ``v_cache`` are mutated, and the call returns
    only ``out`` (b, sq, h, dv), or ``(out, lse)`` with
    ``return_softmax_lse``. q is rotated at the same positions. Attention
    runs over the first ``cache_seqlens + s_new`` keys of each row; causal
    masking is bottom-right aligned. ``num_splits`` <= 0 picks a split
    count that fills the card. With ``qv`` the scores are q k^T + qv v^T
    and the scale defaults to 1/sqrt(d + dv) (DeepSeek's absorbed MLA:
    K the 64-wide rope key, V the 512-wide latent, one KV head); V may
    also be a view of K's first dv columns (the 576/512 latent cache).
    ``pack_gqa`` is accepted and changes nothing, as in JAX: the decode
    kernel always packs a KV head's query heads into one tile's rows.

    With ``block_table`` a row's capacity is max_pages * page_size. Lengths
    the host holds (an int, or a tensor on the CPU) that overflow it raise
    ValueError, as in JAX; on the card, where reading them back would stall
    the stream, the rows that overflow give NaN, as JAX's do under ``jit``.
    cache_batch_idx with a block table raises ValueError, as in JAX.
    cache_batch_idx, cache_leftpad, window, softcap, chunking, ALiBi,
    descales and rotary_seqlens are not ported and raise
    NotImplementedError.
    """
    if block_table is not None and cache_batch_idx is not None:
        raise ValueError("Paged KVcache does not support cache_batch_idx")
    reject_unsupported(
        "flash_attn_with_kvcache", rotary_seqlens=rotary_seqlens,
        cache_batch_idx=cache_batch_idx, cache_leftpad=cache_leftpad,
        window_size=normalize_window(tuple(window_size)), softcap=softcap,
        attention_chunk=attention_chunk, alibi_slopes=alibi_slopes,
        q_descale=q_descale, k_descale=k_descale, v_descale=v_descale)
    require_no_grad("flash_attn_with_kvcache", q, k, v, qv)
    b, sq, h, d = q.shape
    on_host = not torch.is_tensor(cache_seqlens) or \
        cache_seqlens.device.type == "cpu"
    if cache_seqlens is None:
        cache_seqlens = torch.full((b,), k_cache.shape[2], dtype=torch.int32,
                                   device=q.device)
    elif isinstance(cache_seqlens, int):
        cache_seqlens = torch.full((b,), cache_seqlens, dtype=torch.int32,
                                   device=q.device)
    cache_seqlens = cache_seqlens.to(q.device, torch.int32)
    if softmax_scale is None:
        softmax_scale = default_scale(d, v_cache.shape[-1], qv is not None)

    s_new = 0 if k is None else k.shape[1]
    sk_eff = cache_seqlens + s_new
    overflow = None
    if block_table is not None:
        block_table = block_table.to(q.device, torch.int32)
        capacity = cache_capacity(k_cache, block_table)
        if on_host:
            need = int(sk_eff.max()) if b else 0
            if need > capacity:
                raise ValueError(
                    f"cache_seqlens + seqlen_new (max {need}) exceeds "
                    f"block_table capacity {capacity} ({block_table.shape[1]} "
                    f"pages x {k_cache.shape[2]} tokens); the paged kernel "
                    "would index past the table")
        else:
            overflow = sk_eff > capacity
    if k is not None:
        if rotary_cos is not None:
            k = apply_rotary_emb(k, rotary_cos, rotary_sin,
                                 interleaved=rotary_interleaved,
                                 seqlen_offsets=cache_seqlens)
        kv_cache_update(k_cache, v_cache, k, v, cache_seqlens,
                        block_table=block_table)
    if rotary_cos is not None:
        q = apply_rotary_emb(q, rotary_cos, rotary_sin,
                             interleaved=rotary_interleaved,
                             seqlen_offsets=cache_seqlens)
    if num_splits <= 0:
        num_splits = _default_num_splits(q, k_cache, v_cache, block_table,
                                         qv is not None)
    out, lse = flash_attention_decode(
        q, k_cache, v_cache, sk_eff, softmax_scale=softmax_scale,
        causal=causal, num_splits=num_splits, block_table=block_table, qv=qv)
    if overflow is not None:
        out = out.masked_fill(overflow[:, None, None, None], float("nan"))
    return (out, lse) if return_softmax_lse else out
