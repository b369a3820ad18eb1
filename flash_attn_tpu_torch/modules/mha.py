"""Multi-head attention (port of flash_attn_tpu/modules/mha.py ``MHA`` and
``RotaryEmbedding``) over packed sequences (``cu_seqlens``: x is (total,
embed_dim), rotary by each token's position in its sequence, attention
through ``flash_attn_varlen_func``) or in three modes:

 - ``"train"``: causal or full attention over the sequence, differentiable
   (the rotary tables are cached constants, not parameters);
 - ``"prefill"``: the same, then the rotated keys and values are written
   into the cache; with ``prefix_lengths`` (prefix caching, paged cache
   only) x carries only each prompt's suffix, which is written after the
   cached prefix and attends to the whole cache through
   ``flash_attn_varlen_func(block_table=...)``;
 - ``"decode"``: the new token(s) are appended to the cache in place and
   attend to it through ``flash_attn_with_kvcache``.

The cache lives in a :class:`KVCache` the caller passes in (the JAX
module's flax "cache" collection), in the JAX layouts: linear (n_slots,
h_k, s_alloc, d) with s_alloc = max_decode_seqlen rounded up to a multiple
of 128, or pages (num_pages, h_k, page_size, d) when the module is built
with ``paged_kv_num_pages`` > 0. The serving engine's prefill writes only
the rows it admits (``slot_ids``) and the true prompt lengths
(``prefill_lengths``) of a padded batch.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from flash_attn_tpu_torch.cache.kvcache import (
    flash_attn_with_kvcache,
    kv_cache_update,
)
from flash_attn_tpu_torch.dispatch.config import KERNEL_HEAD_DIMS
from flash_attn_tpu_torch.interface import (
    flash_attn_func,
    flash_attn_varlen_func,
)
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb
from flash_attn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class KVCache:
    """One layer's decode state: the caches (linear or paged) and the
    lengths (n_slots,) int32 of every slot. Filled by a prefill, or
    allocated up front by :meth:`MHA.allocate_cache`."""
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    offset: Optional[torch.Tensor] = None


class RotaryEmbedding:
    """Rotary cos/sin tables (base theta), computed in fp32 and kept per
    (seqlen, device)."""

    def __init__(self, dim: int, base: float = 10000.0,
                 interleaved: bool = False):
        self.dim = dim
        self.base = base
        self.interleaved = interleaved
        self._tables: Dict[Tuple[int, torch.device], Tuple] = {}

    def cos_sin(self, seqlen: int, device=None):
        key = (seqlen, torch.device(device or "cpu"))
        if key not in self._tables:
            inv_freq = 1.0 / (self.base ** (
                torch.arange(0, self.dim, 2, dtype=torch.float32,
                             device=device) / self.dim))
            t = torch.arange(seqlen, dtype=torch.float32, device=device)
            freqs = torch.outer(t, inv_freq)
            self._tables[key] = (torch.cos(freqs), torch.sin(freqs))
        return self._tables[key]


class MHA(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 num_heads_kv: Optional[int] = None,
                 head_dim: Optional[int] = None, qkv_proj_bias: bool = True,
                 out_proj_bias: bool = True, causal: bool = False,
                 softmax_scale: Optional[float] = None,
                 rotary_emb_dim: int = 0, rotary_emb_base: float = 10000.0,
                 rotary_emb_interleaved: bool = False,
                 max_decode_seqlen: int = 2048, paged_kv_num_pages: int = 0,
                 paged_kv_page_size: int = 128, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_heads = num_heads
        self.num_heads_kv = num_heads_kv or num_heads
        self.head_dim = head_dim or embed_dim // num_heads
        self.causal = causal
        self.softmax_scale = softmax_scale
        self.max_decode_seqlen = max_decode_seqlen
        self.paged_kv_num_pages = paged_kv_num_pages
        self.paged_kv_page_size = paged_kv_page_size
        self.rotary = (RotaryEmbedding(rotary_emb_dim, rotary_emb_base,
                                       rotary_emb_interleaved)
                       if rotary_emb_dim > 0 else None)
        qkv_dim = (self.num_heads + 2 * self.num_heads_kv) * self.head_dim
        self.Wqkv = nn.Linear(embed_dim, qkv_dim, bias=qkv_proj_bias,
                              dtype=dtype, device=device)
        self.out_proj = nn.Linear(self.num_heads * self.head_dim, embed_dim,
                                  bias=out_proj_bias, dtype=dtype,
                                  device=device)

    @property
    def paged(self) -> bool:
        return self.paged_kv_num_pages > 0

    def allocate_cache(self, n_slots: int, dtype=None,
                       device=None) -> KVCache:
        """A zeroed cache for ``n_slots`` sequences: pages (num_pages, h_k,
        page_size, d) for a paged module, else (n_slots, h_k, s_alloc, d);
        the offsets (n_slots,) int32. Type and device default to the
        module's weights'."""
        w = self.out_proj.weight
        dtype, device = dtype or w.dtype, device or w.device
        h_k, d = self.num_heads_kv, self.head_dim
        if self.paged:
            shape = (self.paged_kv_num_pages, h_k, self.paged_kv_page_size, d)
        else:
            # 128-multiple allocation, as in the JAX module (mha.py:261)
            shape = (n_slots, h_k, -(-self.max_decode_seqlen // 128) * 128, d)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros((n_slots,), dtype=torch.int32,
                                   device=device))

    def _table_rows(self, block_table, slot_ids):
        if not self.paged:
            return None
        if block_table is None:
            raise ValueError("MHA: a paged cache needs a block_table")
        return block_table if slot_ids is None else block_table[slot_ids]

    def forward(self, x, mode: str = "train", cache: Optional[KVCache] = None,
                slot_ids=None, prefill_lengths=None, block_table=None,
                prefix_lengths=None, cu_seqlens=None, max_seqlen=None):
        """x (b, s, embed_dim), or (total, embed_dim) packed by
        ``cu_seqlens`` (b + 1,) with ``max_seqlen`` bounding the sequences
        (then, as in JAX, no cache is read or written, whatever the mode).
        ``cache`` is required in prefill (it is
        filled, and allocated when empty) and decode (it is updated in
        place). Prefill takes ``slot_ids`` (b,): the cache rows (or block-
        table rows) the batch rows fill; ``prefill_lengths`` (b,): the true
        lengths of right-padded rows; ``prefix_lengths`` (b,): tokens
        already cached in each slot's shared pages, x carrying only the
        rest. A paged cache needs ``block_table`` (n_slots, max_pages) in
        prefill and decode."""
        if x.is_cuda and self.head_dim not in KERNEL_HEAD_DIMS:
            raise NotImplementedError(
                f"MHA: head dim {self.head_dim} on the card; the kernels take "
                f"{KERNEL_HEAD_DIMS} (others, such as GPT-J's 256 and "
                "GPT-NeoX-20B's 96, are ROADMAP.md queue A, item 7; the CPU "
                "runs any head dim)")
        if cu_seqlens is not None:
            return self._forward_packed(x, cu_seqlens, max_seqlen)
        if mode not in ("train", "prefill", "decode"):
            raise NotImplementedError(f"MHA mode {mode!r}")
        if mode != "train" and cache is None:
            raise ValueError(f"MHA mode {mode!r} needs a KVCache")
        b, s = x.shape[:2]
        dev = x.device
        h, h_k, d = self.num_heads, self.num_heads_kv, self.head_dim
        q, k, v = self.Wqkv(x).split([h * d, h_k * d, h_k * d], dim=-1)
        q = q.unflatten(-1, (h, d))
        k = k.unflatten(-1, (h_k, d))
        v = v.unflatten(-1, (h_k, d))
        rope = self.rotary
        if mode == "decode":
            cos = sin = None
            if rope is not None:
                cos, sin = rope.cos_sin(self.max_decode_seqlen, dev)
            ctx = flash_attn_with_kvcache(
                q, cache.k, cache.v, k=k, v=v, rotary_cos=cos,
                rotary_sin=sin,
                rotary_interleaved=rope is not None and rope.interleaved,
                cache_seqlens=cache.offset, causal=self.causal,
                softmax_scale=self.softmax_scale,
                block_table=self._table_rows(block_table, None))
            cache.offset += s
            return self.out_proj(ctx.reshape(b, s, h * d))

        prefill = mode == "prefill"
        lengths = None
        if prefill:
            if cache.k is None:
                n_slots = (block_table.shape[0]
                           if self.paged and block_table is not None else b)
                fresh = self.allocate_cache(n_slots, k.dtype, dev)
                cache.k, cache.v, cache.offset = fresh.k, fresh.v, fresh.offset
            lengths = (torch.full((b,), s, dtype=torch.int32, device=dev)
                       if prefill_lengths is None
                       else prefill_lengths.to(dev, torch.int32))
        if prefill and prefix_lengths is not None:
            # prefix-cached chunked prefill: the suffix is written at offset
            # prefix (only full pages are ever shared, so the writes land
            # past them) and attends to [0, prefix + length) of the cache
            if not self.paged:
                raise ValueError("MHA: prefix_lengths needs a paged cache")
            pref = prefix_lengths.to(dev, torch.int32)
            if rope is not None:
                cos, sin = rope.cos_sin(self.max_decode_seqlen, dev)
                q = apply_rotary_emb(q, cos, sin, rope.interleaved,
                                     seqlen_offsets=pref)
                k = apply_rotary_emb(k, cos, sin, rope.interleaved,
                                     seqlen_offsets=pref)
            table = self._table_rows(block_table, slot_ids)
            kv_cache_update(cache.k, cache.v, k, v, pref, block_table=table,
                            new_lengths=lengths)
            total_k = pref + lengths
            self._set_offsets(cache, slot_ids, total_k)
            # the padded-flat layout: row i's queries at [i * s, i * s + s),
            # the first lengths[i] of them real
            cu = torch.arange(b + 1, dtype=torch.int32, device=dev) * s
            ctx = flash_attn_varlen_func(
                q.reshape(b * s, h, d), cache.k, cache.v, cu, None, s,
                self.max_decode_seqlen, causal=self.causal,
                softmax_scale=self.softmax_scale, block_table=table,
                seqused_k=total_k, seqused_q=lengths)
            return self.out_proj(ctx.reshape(b, s, h * d))

        if rope is not None:
            cos, sin = rope.cos_sin(
                self.max_decode_seqlen if prefill else s, dev)
            q = apply_rotary_emb(q, cos, sin, rope.interleaved)
            k = apply_rotary_emb(k, cos, sin, rope.interleaved)
        ctx = flash_attn_func(q, k, v, causal=self.causal,
                              softmax_scale=self.softmax_scale)
        if prefill:
            zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
            if self.paged:
                # padded rows must not write past their pages
                kv_cache_update(cache.k, cache.v, k, v, zeros,
                                block_table=self._table_rows(block_table,
                                                             slot_ids),
                                new_lengths=lengths)
            else:
                kv_cache_update(cache.k, cache.v, k, v, zeros,
                                cache_batch_idx=slot_ids)
            self._set_offsets(cache, slot_ids, lengths)
        return self.out_proj(ctx.reshape(b, s, h * d))

    def _forward_packed(self, x, cu_seqlens, max_seqlen: int):
        """The packed path of JAX mha.py:207-229."""
        total = x.shape[0]
        h, h_k, d = self.num_heads, self.num_heads_kv, self.head_dim
        q, k, v = self.Wqkv(x).split([h * d, h_k * d, h_k * d], dim=-1)
        q = q.unflatten(-1, (h, d))
        k = k.unflatten(-1, (h_k, d))
        v = v.unflatten(-1, (h_k, d))
        rope = self.rotary
        if rope is not None:
            cos, sin = rope.cos_sin(max_seqlen, x.device)
            q = apply_rotary_emb(q, cos, sin, rope.interleaved,
                                 cu_seqlens=cu_seqlens, max_seqlen=max_seqlen)
            k = apply_rotary_emb(k, cos, sin, rope.interleaved,
                                 cu_seqlens=cu_seqlens, max_seqlen=max_seqlen)
        ctx = flash_attn_varlen_func(
            q, k, v, cu_seqlens, cu_seqlens, max_seqlen, max_seqlen,
            causal=self.causal, softmax_scale=self.softmax_scale)
        return self.out_proj(ctx.reshape(total, h * d))

    @staticmethod
    def _set_offsets(cache: KVCache, slot_ids, lengths) -> None:
        """In place, so that the offsets keep their storage (a captured
        decode graph reads them there)."""
        if slot_ids is None:
            cache.offset.copy_(lengths)
        else:
            cache.offset[slot_ids.to(cache.offset.device, torch.long)] = lengths
