"""The JAX package's paged kernels as the port tests' references, called at
a KV tile of one page: the paged varlen prefill (B8) and paged decode (B4).

``jax_varlen_paged`` does what ``flash_attn_tpu.interface.
flash_attn_varlen_func(block_table=...)`` does on its B8 route
(interface.py:499-546: the window normalised, ``qv`` through the
concatenation q || qv against K || V when d and dv are multiples of 128)
and calls ``flash_attention_varlen_paged_fwd`` itself with ``block_k`` set
to the page size: the same function at another tiling of its keys (the
online softmax merges the tiles in another order, ~1e-7 apart in fp32),
whose interpret-mode program lowers in half the time of the default tile
of eight pages. ``jax_kvcache_paged`` does what ``flash_attn_tpu.cache.
kvcache.flash_attn_with_kvcache(block_table=...)`` does (kvcache.py:168-268:
rotary at the cache lengths, the append inside the decode call, (h,)
slopes broadcast to (b, h)) and calls ``flash_attention_decode`` with
``block_k`` set to the page size (the default tile of up to 512 keys
fetches 32 pages of 16 a tile), for the tests that name their split count.
Not a test module: pytest collects ``test_*.py`` only.
"""

import contextlib
import math

import jax.numpy as jnp

from flash_attn_tpu.dispatch.config import normalize_window
from flash_attn_tpu.kernels.flash_decode import flash_attention_decode
from flash_attn_tpu.kernels.flash_varlen_paged import (
    flash_attention_varlen_paged_fwd,
)
from flash_attn_tpu.ops.rotary import apply_rotary_emb


def jax_varlen_paged(q, k_pages, v_pages, cu_seqlens_q, max_seqlen_q,
                     seqlens_k, block_table, seqused_q=None, qv=None,
                     causal=False, window_size=(-1, -1), softcap=0.0,
                     softmax_scale=None, q_descale=None, k_descale=None,
                     v_descale=None, learnable_sink=None):
    """(out (total_q, h, dv), lse (h, total_q)) of JAX's B8 route over jax
    arrays, as ``flash_attn_varlen_func(block_table=...,
    return_attn_probs=True)`` returns them."""
    kv_concat_dim = 0
    if qv is not None:
        d, dv = q.shape[-1], v_pages.shape[-1]
        assert d % 128 == 0 and dv % 128 == 0, "JAX takes B8p there"
        if softmax_scale is None:
            softmax_scale = 1.0 / math.sqrt(d + qv.shape[-1])
        q = jnp.concatenate([q, qv], axis=-1)
        kv_concat_dim = d
    return flash_attention_varlen_paged_fwd(
        q, k_pages, v_pages, cu_seqlens_q, int(max_seqlen_q),
        jnp.asarray(seqlens_k, jnp.int32), block_table, seqused_q=seqused_q,
        q_descale=q_descale, k_descale=k_descale, v_descale=v_descale,
        learnable_sink=learnable_sink, softmax_scale=softmax_scale,
        causal=causal,
        window_size=normalize_window(tuple(window_size)), softcap=softcap,
        kv_concat_dim=kv_concat_dim, block_k=k_pages.shape[2],
        interpret=True)


def jax_kvcache_paged(q, k_cache, v_cache, cache_seqlens, block_table,
                      num_splits, k=None, v=None, qv=None, rotary_cos=None,
                      rotary_sin=None, rotary_interleaved=False,
                      softmax_scale=None, causal=False, window_size=(-1, -1),
                      softcap=0.0, attention_chunk=0, alibi_slopes=None,
                      q_descale=None, k_descale=None, v_descale=None):
    """JAX's paged decode over jax arrays, returning as
    ``flash_attn_with_kvcache(..., return_softmax_lse=True)`` does: (out,
    k_cache, v_cache, lse) with ``k``/``v`` appended, else (out, lse)."""
    b, sq, h, d = q.shape
    cache_seqlens = cache_seqlens.astype(jnp.int32)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(
            d if qv is None else d + v_cache.shape[-1])
    if rotary_cos is not None:
        if k is not None:
            k = apply_rotary_emb(k, rotary_cos, rotary_sin,
                                 interleaved=rotary_interleaved,
                                 seqlen_offsets=cache_seqlens)
        q = apply_rotary_emb(q, rotary_cos, rotary_sin,
                             interleaved=rotary_interleaved,
                             seqlen_offsets=cache_seqlens)
    if alibi_slopes is not None and alibi_slopes.ndim == 1:
        alibi_slopes = jnp.broadcast_to(alibi_slopes[None],
                                        (b, alibi_slopes.shape[0]))
    res = flash_attention_decode(
        q, k_cache, v_cache, cache_seqlens + (0 if k is None else k.shape[1]),
        block_table=block_table, k_new=k, v_new=v, qv=qv,
        alibi_slopes=alibi_slopes, q_descale=q_descale, k_descale=k_descale,
        v_descale=v_descale, softmax_scale=softmax_scale, causal=causal,
        window_size=normalize_window(tuple(window_size)), softcap=softcap,
        attention_chunk=attention_chunk, num_splits=num_splits,
        block_k=k_cache.shape[2], interpret=True)
    if k is None:
        return res
    out, lse, k_cache, v_cache = res
    return out, k_cache, v_cache, lse


@contextlib.contextmanager
def one_page_tiles():
    """Within it, the JAX package's paged prefill (B8) and paged decode (B4)
    run at a KV tile of one page wherever the package calls them (its
    engines, its models and its interface functions), as the two functions
    above do; the names are restored on exit."""
    import flash_attn_tpu.cache.kvcache as kvcache
    import flash_attn_tpu.kernels.flash_varlen_paged as varlen_paged

    b8 = varlen_paged.flash_attention_varlen_paged_fwd
    b4 = kvcache.flash_attention_decode

    def b8_tiled(q, k_pages, *args, block_k=None, **kw):
        return b8(q, k_pages, *args, block_k=block_k or k_pages.shape[2],
                  **kw)

    def b4_tiled(q, k_cache, *args, block_table=None, block_k=None, **kw):
        if block_table is not None and block_k is None:
            block_k = k_cache.shape[2]
        return b4(q, k_cache, *args, block_table=block_table,
                  block_k=block_k, **kw)

    varlen_paged.flash_attention_varlen_paged_fwd = b8_tiled
    kvcache.flash_attention_decode = b4_tiled
    try:
        yield
    finally:
        varlen_paged.flash_attention_varlen_paged_fwd = b8
        kvcache.flash_attention_decode = b4
