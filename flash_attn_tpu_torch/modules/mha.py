"""Multi-head attention (port of flash_attn_tpu/modules/mha.py ``MHA`` and
``RotaryEmbedding``) in three modes:

 - ``"train"``: causal or full attention over the sequence, differentiable
   (the rotary tables are cached constants, not parameters);
 - ``"prefill"``: the same, then the rotated keys and values are written
   into a new linear cache;
 - ``"decode"``: the new token(s) are appended to the cache in place and
   attend to it through ``flash_attn_with_kvcache``.

The cache lives in a :class:`KVCache` the caller passes in (the JAX
module's flax "cache" collection), in the JAX layout (b, h_k, s_alloc, d)
with s_alloc = max_decode_seqlen rounded up to a multiple of 128.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from flash_attn_tpu_torch.cache.kvcache import (
    flash_attn_with_kvcache,
    kv_cache_update,
)
from flash_attn_tpu_torch.interface import flash_attn_func
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb


@dataclasses.dataclass
class KVCache:
    """One layer's decode state: caches (b, h_k, s_alloc, d) and the
    per-row lengths (b,) int32. Filled by a prefill."""
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
                 max_decode_seqlen: int = 2048, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.num_heads_kv = num_heads_kv or num_heads
        self.head_dim = head_dim or embed_dim // num_heads
        self.causal = causal
        self.softmax_scale = softmax_scale
        self.max_decode_seqlen = max_decode_seqlen
        self.rotary = (RotaryEmbedding(rotary_emb_dim, rotary_emb_base,
                                       rotary_emb_interleaved)
                       if rotary_emb_dim > 0 else None)
        qkv_dim = (self.num_heads + 2 * self.num_heads_kv) * self.head_dim
        self.Wqkv = nn.Linear(embed_dim, qkv_dim, bias=qkv_proj_bias,
                              dtype=dtype, device=device)
        self.out_proj = nn.Linear(self.num_heads * self.head_dim, embed_dim,
                                  bias=out_proj_bias, dtype=dtype,
                                  device=device)

    def forward(self, x, mode: str = "train", cache: Optional[KVCache] = None):
        """x (b, s, embed_dim). ``cache`` is required in prefill (it is
        filled) and decode (it is updated in place)."""
        if mode not in ("train", "prefill", "decode"):
            raise NotImplementedError(f"MHA mode {mode!r}")
        if mode != "train" and cache is None:
            raise ValueError(f"MHA mode {mode!r} needs a KVCache")
        b, s = x.shape[:2]
        h, h_k, d = self.num_heads, self.num_heads_kv, self.head_dim
        q, k, v = self.Wqkv(x).split([h * d, h_k * d, h_k * d], dim=-1)
        q = q.unflatten(-1, (h, d))
        k = k.unflatten(-1, (h_k, d))
        v = v.unflatten(-1, (h_k, d))
        rope = self.rotary
        if mode == "decode":
            cos = sin = None
            if rope is not None:
                cos, sin = rope.cos_sin(self.max_decode_seqlen, x.device)
            ctx = flash_attn_with_kvcache(
                q, cache.k, cache.v, k=k, v=v, rotary_cos=cos,
                rotary_sin=sin,
                rotary_interleaved=rope is not None and rope.interleaved,
                cache_seqlens=cache.offset, causal=self.causal,
                softmax_scale=self.softmax_scale)
            cache.offset += s
        else:
            prefill = mode == "prefill"
            if rope is not None:
                cos, sin = rope.cos_sin(
                    self.max_decode_seqlen if prefill else s, x.device)
                q = apply_rotary_emb(q, cos, sin, rope.interleaved)
                k = apply_rotary_emb(k, cos, sin, rope.interleaved)
            ctx = flash_attn_func(q, k, v, causal=self.causal,
                                  softmax_scale=self.softmax_scale)
            if prefill:
                s_alloc = -(-self.max_decode_seqlen // 128) * 128
                shape = (b, h_k, s_alloc, d)
                cache.k = torch.zeros(shape, dtype=k.dtype, device=x.device)
                cache.v = torch.zeros(shape, dtype=v.dtype, device=x.device)
                zeros = torch.zeros((b,), dtype=torch.int32, device=x.device)
                kv_cache_update(cache.k, cache.v, k, v, zeros)
                cache.offset = torch.full((b,), s, dtype=torch.int32,
                                          device=x.device)
        return self.out_proj(ctx.reshape(b, s, h * d))
