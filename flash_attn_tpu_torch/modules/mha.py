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

With ``dwconv`` a causal depthwise convolution of width 3 runs over the
pre-attention qkv in fp32 (JAX mha.py:154-203): train and prefill pad two
rows on the left, prefill keeps the last two pre-conv rows of each row's
true length in the cache's ``dwconv_state``, and decode convolves them with
the new rows and rolls them on, so that prefill then decode gives train
mode's outputs. JAX computes it with lax.conv_general_dilated, an XLA op
outside any Pallas kernel; here it is three fp32 multiply-adds over shifted
rows: conv1d(groups=qkv_dim)'s arithmetic, without the TF32 rounding that
a float32 convolution takes on the card by default. Not with packed
sequences or prefix caching, as in JAX.

``window_size`` (JAX mha.py:85; -1 for no bound) is passed to every
attention call, as JAX's :225, :289, :352 and :381 pass it: the dense
prefill and train mode (B1, and B3 or B2 for the gradient), decode (B4,
linear and paged), the prefix-cached admission (B8) and the packed path
(B7 forward, B6 backward), each on its kernels' band instantiation.

``softcap`` and ``use_alibi`` (JAX mha.py:86, :91) map the scores of every
attention call, as JAX's :226, :289 and :384 pass them: the dense prefill
and train mode (B1, and B3 or B2 for the gradient), decode (B4, linear and
paged, the speculative verify step too), for the cap the prefix-cached
admission (B8), and the packed path (:222-227: B7 forward, or B6's forward
with ALiBi, as JAX routes it, and B6 backward), each on its kernels' score
instantiation. The slopes are the standard ALiBi schedule
(:func:`alibi_slopes`), built once on the module's device as a buffer that
a captured decode program reads in place; they are not learned (no
gradient reaches them). A prefix-cached admission of an ALiBi
module raises too (the paged route refuses the slopes it is passed): JAX's
drops the slopes there (mha.py:372-386), so its suffix would attend without
positions (ROADMAP.md queue C).

``kv_cache_dtype`` and ``kv_cache_scale`` (JAX mha.py:96-102) keep K/V
in the cache as x / kv_cache_scale in a 1-byte type (float8_e4m3fn or int8
on the card; any type on the CPU), stored through the saturating
``dispatch/kvquant.py quantize_kv``, and attend with (b, h_k) descales of
kv_cache_scale, as JAX's :242-291, :328-355 and :379-428 do: decode
through ``flash_attn_with_kvcache(k_descale=, v_descale=)`` (B4 reading the
codes), the prefix-cached admission through the paged
``flash_attn_varlen_func`` with descales (B8 over the converted pages), and
the full prefill through B1 over the unquantized K/V before the store. The
descales are made once per cache (``KVCache.descale``); a call reads a
view of their first rows, so a captured decode program sees fixed
addresses. The attention output is cast back to the module's type before
``out_proj`` (under descales it is bf16, as JAX's).

The cache lives in a :class:`KVCache` the caller passes in (the JAX
module's flax "cache" collection), in the JAX layouts: linear (n_slots,
h_k, s_alloc, d) with s_alloc = max_decode_seqlen rounded up to a multiple
of 128, or pages (num_pages, h_k, page_size, d) when the module is built
with ``paged_kv_num_pages`` > 0. The serving engine's prefill writes only
the rows it admits (``slot_ids``) and the true prompt lengths
(``prefill_lengths``) of a padded batch.
"""

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from flash_attn_tpu_torch.cache.kvcache import (
    flash_attn_with_kvcache,
    kv_cache_update,
)
from flash_attn_tpu_torch.dispatch.config import HEAD_DIMS
from flash_attn_tpu_torch.dispatch.kvquant import check_cache_dtype
from flash_attn_tpu_torch.interface import (
    flash_attn_func,
    flash_attn_varlen_func,
)
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb
from flash_attn_tpu_torch.utils.device import resolve_device


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """The standard ALiBi slope schedule (JAX mha.py:120-130 ``_alibi_slopes``)
    as (num_heads,) fp32: 2^(-8 (i + 1) / n) for the n = 2^floor(log2 h)
    heads, then, for a head count that is not a power of two, every other
    slope of the 2n-head schedule for the rest."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** (i + 1) for i in range(closest)]
    if closest != num_heads:
        extra = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        slopes += [extra ** (i + 1)
                   for i in range(0, 2 * (num_heads - closest), 2)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


@dataclasses.dataclass
class KVCache:
    """One layer's decode state: the caches (linear or paged), the
    lengths (n_slots,) int32 of every slot, for a module with dwconv the
    last two pre-conv qkv rows of every slot (n_slots, 2, qkv_dim) and, for
    a quantized cache, the descales (n_slots, h_k) fp32 (kv_cache_scale
    throughout). Filled by a prefill, or allocated up front by
    :meth:`MHA.allocate_cache`; prefill and decode update them in place."""
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    offset: Optional[torch.Tensor] = None
    dwconv_state: Optional[torch.Tensor] = None
    descale: Optional[torch.Tensor] = None


class RotaryEmbedding:
    """Rotary cos/sin tables (base theta), computed in fp32 and kept per
    (seqlen, device): optional xPos decay (``scale_base``: cos_sin_scaled
    gives q's scaled pair and k's inverse-scaled one) and dynamic NTK base
    rescaling past ``ntk_orig_len`` (the base grows with the table's
    length, so each length's table has its own base; the cache is keyed by
    the length)."""

    def __init__(self, dim: int, base: float = 10000.0,
                 interleaved: bool = False,
                 scale_base: Optional[float] = None,
                 ntk_orig_len: Optional[int] = None):
        self.dim = dim
        self.base = base
        self.interleaved = interleaved
        self.scale_base = scale_base
        self.ntk_orig_len = ntk_orig_len
        self._tables: Dict[Tuple[int, torch.device], Tuple] = {}

    def _base_for(self, seqlen: int) -> float:
        """The base at a table of ``seqlen`` rows: past ntk_orig_len,
        base * (alpha * len / orig - (alpha - 1)) ** (d / (d - 2)) with
        alpha = len / orig, in float64 as the JAX package computes it."""
        if self.ntk_orig_len is not None and seqlen > self.ntk_orig_len:
            alpha = seqlen / self.ntk_orig_len
            return float(self.base * (
                (alpha * seqlen / self.ntk_orig_len - (alpha - 1))
                ** (self.dim / (self.dim - 2))))
        return self.base

    def cos_sin(self, seqlen: int, device=None):
        key = (seqlen, torch.device(device or "cpu"))
        if key not in self._tables:
            inv_freq = 1.0 / (self._base_for(seqlen) ** (
                torch.arange(0, self.dim, 2, dtype=torch.float32,
                             device=device) / self.dim))
            t = torch.arange(seqlen, dtype=torch.float32, device=device)
            freqs = torch.outer(t, inv_freq)
            self._tables[key] = (torch.cos(freqs), torch.sin(freqs))
        return self._tables[key]

    def cos_sin_scaled(self, seqlen: int, device=None):
        """(cos, sin, cos_k, sin_k): with xPos (scale_base) q's pair scaled
        by scale ** ((t - seqlen // 2) / scale_base) and k's by its inverse;
        without it, the plain pair twice."""
        cos, sin = self.cos_sin(seqlen, device)
        if self.scale_base is None:
            return cos, sin, cos, sin
        scale = ((torch.arange(0, self.dim, 2, dtype=torch.float32,
                               device=device) + 0.4 * self.dim)
                 / (1.4 * self.dim))
        t = torch.arange(seqlen, dtype=torch.float32, device=device)
        sc = scale[None, :] ** ((t - seqlen // 2) / self.scale_base)[:, None]
        return cos * sc, sin * sc, cos / sc, sin / sc


class MHA(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 num_heads_kv: Optional[int] = None,
                 head_dim: Optional[int] = None, qkv_proj_bias: bool = True,
                 out_proj_bias: bool = True, causal: bool = False,
                 softmax_scale: Optional[float] = None,
                 rotary_emb_dim: int = 0, rotary_emb_base: float = 10000.0,
                 rotary_emb_interleaved: bool = False, dwconv: bool = False,
                 max_decode_seqlen: int = 2048, paged_kv_num_pages: int = 0,
                 paged_kv_page_size: int = 128,
                 window_size: Tuple[int, int] = (-1, -1),
                 softcap: float = 0.0, use_alibi: bool = False,
                 kv_cache_dtype=None, kv_cache_scale: float = 1.0,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        if kv_cache_dtype is not None and softcap > 0.0:
            raise ValueError(
                "MHA: softcap with a quantized KV cache (kv_cache_dtype) "
                "fails at the first decode step in the JAX package, whose "
                "decode kernel asserts \"softcap + FP8 descale unsupported\" "
                "(flash_attn_tpu/kernels/flash_decode.py:554-555)")
        if kv_cache_dtype is not None and device.type == "cuda":
            check_cache_dtype("MHA", kv_cache_dtype, dtype)
        self.kv_cache_dtype = kv_cache_dtype
        self.kv_cache_scale = kv_cache_scale
        self.num_heads = num_heads
        self.num_heads_kv = num_heads_kv or num_heads
        self.head_dim = head_dim or embed_dim // num_heads
        self.causal = causal
        self.window_size = tuple(window_size)
        self.softcap = softcap
        self.use_alibi = use_alibi
        # not in the state dict: the schedule is recomputed, as JAX's is
        self.register_buffer(
            "alibi_slopes",
            alibi_slopes(num_heads, device) if use_alibi else None,
            persistent=False)
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
        self.dwconv = dwconv
        if dwconv:
            # conv1d's layout (qkv_dim, 1, 3) of flax's (3, 1, qkv_dim)
            # kernel, and its initial scales (normal 0.02, bias 0), in fp32
            self.dwconv_kernel = nn.Parameter(torch.empty(
                qkv_dim, 1, 3, dtype=torch.float32, device=device))
            self.dwconv_bias = nn.Parameter(torch.zeros(
                qkv_dim, dtype=torch.float32, device=device))
            with torch.no_grad():
                self.dwconv_kernel.normal_(0.0, 0.02)

    @property
    def paged(self) -> bool:
        return self.paged_kv_num_pages > 0

    def allocate_cache(self, n_slots: int, dtype=None,
                       device=None) -> KVCache:
        """A zeroed cache for ``n_slots`` sequences: pages (num_pages, h_k,
        page_size, d) for a paged module, else (n_slots, h_k, s_alloc, d);
        the offsets (n_slots,) int32; the descales (n_slots, h_k) of a
        quantized cache. The caches' type defaults to kv_cache_dtype, else
        the weights' (the dwconv state's to the weights'), the device to
        the weights'."""
        w = self.out_proj.weight
        cache_dtype = dtype or self.kv_cache_dtype or w.dtype
        dtype, device = dtype or w.dtype, device or w.device
        h_k, d = self.num_heads_kv, self.head_dim
        if self.paged:
            shape = (self.paged_kv_num_pages, h_k, self.paged_kv_page_size, d)
        else:
            # 128-multiple allocation, as in the JAX module (mha.py:261)
            shape = (n_slots, h_k, -(-self.max_decode_seqlen // 128) * 128, d)
        dw = None
        if self.dwconv:
            dw = torch.zeros((n_slots, 2, self.Wqkv.out_features),
                             dtype=dtype, device=device)
        descale = None
        if self.kv_cache_dtype is not None:
            descale = torch.full((n_slots, h_k), self.kv_cache_scale,
                                 dtype=torch.float32, device=device)
        return KVCache(torch.zeros(shape, dtype=cache_dtype, device=device),
                       torch.zeros(shape, dtype=cache_dtype, device=device),
                       torch.zeros((n_slots,), dtype=torch.int32,
                                   device=device), dw, descale)

    def _conv(self, x):
        """The width-3 causal depthwise conv over rows already padded by
        two on the left (b, s + 2, qkv_dim) -> (b, s, qkv_dim), in fp32,
        returned in x's type."""
        xf, w = x.float(), self.dwconv_kernel[:, 0].T  # (3, qkv_dim)
        s = x.shape[1] - 2
        y = xf[:, :s] * w[0] + xf[:, 1:s + 1] * w[1] + xf[:, 2:] * w[2]
        return (y + self.dwconv_bias).to(x.dtype)

    def _dwconv(self, qkv, mode: str, cache, slot_ids, lengths):
        """qkv after the conv; in prefill and decode the cache's
        dwconv_state is read and written in place (JAX mha.py:175-202)."""
        if mode == "decode":
            ext = torch.cat([cache.dwconv_state.to(qkv.dtype), qkv], 1)
            cache.dwconv_state.copy_(ext[:, -2:])
            return self._conv(ext)
        padded = F.pad(qkv, (0, 0, 2, 0))
        if mode == "prefill":
            # padded[:, n + i] is x[n - 2 + i]: the last two rows of each
            # row's true length n (zeros where n < 2)
            idx = torch.stack([lengths, lengths + 1], 1).long()
            new = padded.gather(1, idx[:, :, None].expand(
                -1, -1, padded.shape[-1]))
            if slot_ids is None:
                cache.dwconv_state.copy_(new)
            else:
                cache.dwconv_state[slot_ids.to(new.device, torch.long)] = \
                    new.to(cache.dwconv_state.dtype)
        return self._conv(padded)

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
        if x.is_cuda and self.head_dim not in HEAD_DIMS:
            raise NotImplementedError(
                f"MHA: head dim {self.head_dim} on the card; its kernels "
                f"take {HEAD_DIMS} (others are ROADMAP.md queue A, item "
                "7; the CPU runs any head dim)")
        if cu_seqlens is not None:
            if self.dwconv:
                raise ValueError("MHA: dwconv takes non-packed input only "
                                 "(as JAX asserts)")
            return self._forward_packed(x, cu_seqlens, max_seqlen)
        if mode not in ("train", "prefill", "decode"):
            raise NotImplementedError(f"MHA mode {mode!r}")
        if mode != "train" and cache is None:
            raise ValueError(f"MHA mode {mode!r} needs a KVCache")
        if self.dwconv and mode == "prefill" and prefix_lengths is not None:
            raise NotImplementedError(
                "MHA: prefix caching with dwconv is unsupported (as in JAX)")
        score = dict(softcap=self.softcap, alibi_slopes=self.alibi_slopes)
        b, s = x.shape[:2]
        dev = x.device
        h, h_k, d = self.num_heads, self.num_heads_kv, self.head_dim
        prefill = mode == "prefill"
        lengths = None
        if prefill:
            if cache.k is None:
                n_slots = (block_table.shape[0]
                           if self.paged and block_table is not None else b)
                fresh = self.allocate_cache(n_slots, device=dev)
                cache.k, cache.v, cache.offset = fresh.k, fresh.v, fresh.offset
                cache.dwconv_state = fresh.dwconv_state
                cache.descale = fresh.descale
            lengths = (torch.full((b,), s, dtype=torch.int32, device=dev)
                       if prefill_lengths is None
                       else prefill_lengths.to(dev, torch.int32))
        qkv = self.Wqkv(x)
        if self.dwconv:
            qkv = self._dwconv(qkv, mode, cache, slot_ids, lengths)
        q, k, v = qkv.split([h * d, h_k * d, h_k * d], dim=-1)
        q = q.unflatten(-1, (h, d))
        k = k.unflatten(-1, (h_k, d))
        v = v.unflatten(-1, (h_k, d))
        rope = self.rotary
        quant = self.kv_cache_dtype is not None
        # per (query-batch row, KV head), as JAX's _descales (mha.py:245-249)
        descale = cache.descale[:b] if quant and cache is not None else None
        if mode == "decode":
            cos = sin = None
            if rope is not None:
                cos, sin = rope.cos_sin(self.max_decode_seqlen, dev)
            # store x / scale: the rotation is linear, so dividing first
            # commutes with the call's rotary on the appended keys
            k_st, v_st = self._to_store(k, v)
            ctx = flash_attn_with_kvcache(
                q, cache.k, cache.v, k=k_st, v=v_st, rotary_cos=cos,
                rotary_sin=sin,
                rotary_interleaved=rope is not None and rope.interleaved,
                cache_seqlens=cache.offset, causal=self.causal,
                window_size=self.window_size,
                softmax_scale=self.softmax_scale,
                block_table=self._table_rows(block_table, None),
                k_descale=descale, v_descale=descale, **score)
            cache.offset += s
            return self.out_proj(ctx.reshape(b, s, h * d).to(
                self.out_proj.weight.dtype))

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
            kv_cache_update(cache.k, cache.v, *self._to_store(k, v), pref,
                            block_table=table, new_lengths=lengths)
            total_k = pref + lengths
            self._set_offsets(cache, slot_ids, total_k)
            # the padded-flat layout: row i's queries at [i * s, i * s + s),
            # the first lengths[i] of them real
            cu = torch.arange(b + 1, dtype=torch.int32, device=dev) * s
            ctx = flash_attn_varlen_func(
                q.reshape(b * s, h, d), cache.k, cache.v, cu, None, s,
                self.max_decode_seqlen, causal=self.causal,
                window_size=self.window_size,
                softmax_scale=self.softmax_scale, block_table=table,
                seqused_k=total_k, seqused_q=lengths, k_descale=descale,
                v_descale=descale, **score)
            return self.out_proj(ctx.reshape(b, s, h * d).to(
                self.out_proj.weight.dtype))

        if rope is not None:
            cos, sin = rope.cos_sin(
                self.max_decode_seqlen if prefill else s, dev)
            q = apply_rotary_emb(q, cos, sin, rope.interleaved)
            k = apply_rotary_emb(k, cos, sin, rope.interleaved)
        ctx = flash_attn_func(q, k, v, causal=self.causal,
                              window_size=self.window_size,
                              softmax_scale=self.softmax_scale, **score)
        if prefill:
            zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
            k, v = self._to_store(k, v)
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

    def _to_store(self, k, v):
        """K and V as a quantized cache stores them: x / kv_cache_scale in
        the module's type (then the store's cast), as JAX's mha.py:278-282."""
        if self.kv_cache_dtype is None or self.kv_cache_scale == 1.0:
            return k, v
        return k / self.kv_cache_scale, v / self.kv_cache_scale

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
            causal=self.causal, window_size=self.window_size,
            softmax_scale=self.softmax_scale, softcap=self.softcap,
            alibi_slopes=self.alibi_slopes)
        return self.out_proj(ctx.reshape(total, h * d))

    def jax_param_arrays(self, params) -> Dict[str, object]:
        """The arrays of a flax MHA param dict (numpy arrays) by the names
        of ``self.named_parameters()``, in torch layouts: Dense kernels
        (in, out) as Linear weights (out, in), the dwconv kernel (3, 1,
        qkv_dim) as conv1d's (qkv_dim, 1, 3)."""
        out = {}
        for name, lin in (("Wqkv", self.Wqkv), ("out_proj", self.out_proj)):
            out[f"{name}.weight"] = params[name]["kernel"].T
            if lin.bias is not None:
                out[f"{name}.bias"] = params[name]["bias"]
        if self.dwconv:
            out["dwconv_kernel"] = params["dwconv_kernel"].transpose(2, 1, 0)
            out["dwconv_bias"] = params["dwconv_bias"]
        return out

    @staticmethod
    def _set_offsets(cache: KVCache, slot_ids, lengths) -> None:
        """In place, so that the offsets keep their storage (a captured
        decode graph reads them there)."""
        if slot_ids is None:
            cache.offset.copy_(lengths)
        else:
            cache.offset[slot_ids.to(cache.offset.device, torch.long)] = lengths
