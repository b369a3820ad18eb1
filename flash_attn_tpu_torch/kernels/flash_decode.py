"""Split-KV decode attention over a linear or a paged cache: the CUDA
kernels ``csrc/flash_decode.cu`` (d = dv) and ``csrc/flash_decode_mla.cu``
(the MLA route), their plain PyTorch version, and ``combine_splits``.

Port of flash_attn_tpu/kernels/flash_decode.py ``flash_attention_decode``
(linear and paged cache, causal or not, GQA, ``num_splits`` >= 1, the MLA
second query ``qv`` and a value width dv != d), with the band masks of its
d = dv route: ``window_size`` and ``attention_chunk`` (the kernel masks
:202-214; JAX's decode has no sink tokens). With a band the splits share
out only the key tiles from the band's first (:func:`band_first_tile`);
the tiles below it are masked for every row, so the merged result is
JAX's, which reads and masks them. ``softcap`` and ``alibi_slopes``
(dispatch/score.py, :245-254) are runtime fields of the d = dv route as the
band is; causal ALiBi's bias is relative to each batch row's own cache
length, so the split partials' lse all take JAX's form and
``combine_splits`` merges them as they are. The MLA route refuses a band,
a cap and slopes. The d = dv route also reads caches of 1-byte
codes (float8_e4m3fn, int8; dispatch/kvquant.py) with q in bf16, converting
each staged row on the card (B11's role, flash_attn_tpu/kernels/
fp8_cast.py:28, here Hopper's native e4m3 -> f16x2 conversion, exact for
every finite code), and (b, h_k) descales over any cache: q_descale ·
k_descale scales the scores and v_descale each split's partial out (JAX
:186, :248-249, :307-308); the MLA route refuses both. The caches keep the
JAX layouts: linear (b_c, h_k, s_max, d), paged (num_pages, h_k, page_size, d)
with a (b, max_pages) int32 block table, V the same with dv; a paged row's
capacity is max_pages * page_size positions. Each split writes an fp32
partial (out, lse) for the sq * group query rows of one KV head (the GQA
row packing of the TPU kernel); ``combine_splits`` merges them with torch
ops, as the JAX package merges them outside its kernel. The JAX function pads
d and dv to 128 lanes for its DMAs; the kernels here take them as they are.
A tensor on the CPU takes the plain version; a CUDA tensor launches a
kernel or raises.
"""

import math
from typing import Optional

import torch

from flash_attn_tpu_torch.dispatch.band import (
    band_args,
    band_valid,
    has_band,
    reach_window,
)
from flash_attn_tpu_torch.dispatch.config import (
    DECODE_BLOCK_K,
    DECODE_ROWS_PER_BLOCK,
    HEAD_DIMS,
    MLA_DECODE_DIMS,
    MLA_TILE,
    check_head_dims,
    decode_cluster,
    is_mla_form,
    num_sms,
)
from flash_attn_tpu_torch.dispatch.kvquant import (
    KV_CODES,
    check_cache_dtype,
    is_quantized,
)
from flash_attn_tpu_torch.dispatch.score import (
    alibi_bias,
    has_score,
    score_map,
    slope_args,
    slopes_bh,
)
from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.utils.testing import paged_to_linear

LOG2E = math.log2(math.e)

# Kernel launches since the last reset (plain calls not counted): the d = dv
# route over a linear and over a paged cache, those of them with a band,
# those with softcap or ALiBi and those over a cache of 1-byte codes, and
# the MLA route over either.
launches = 0
launches_paged = 0
launches_kv8 = 0
launches_paged_kv8 = 0
launches_band = 0
launches_paged_band = 0
launches_score = 0
launches_paged_score = 0
launches_mla = 0


def cache_capacity(k_cache, block_table=None) -> int:
    """Positions a batch row's cache holds: s_max, or max_pages *
    page_size for a paged cache."""
    if block_table is None:
        return k_cache.shape[2]
    return block_table.shape[1] * k_cache.shape[2]


def band_first_tile(cache_seqlens, sq: int, window_left, attention_chunk,
                    block_k: int):
    """(b,) the first key tile of each batch row's band: the tile of the
    lowest key its first query token (position cache_seqlens - sq) sees
    under the window's left extent and the chunk; 0 without either. The
    kernel computes the same from cache_seqlens on the card."""
    rs = cache_seqlens - sq
    lo = torch.zeros_like(cache_seqlens)
    if window_left is not None:
        lo = torch.maximum(lo, rs - window_left)
    if attention_chunk > 0:
        lo = torch.maximum(lo, rs - rs % attention_chunk)
    tiles = (cache_seqlens + block_k - 1) // block_k
    return torch.minimum(lo // block_k, tiles)


def _split_bounds(cache_seqlens, num_splits: int, block_k: int,
                  first_tile=0):
    """Per batch row, the key count of each split's contiguous run of
    block_k tiles from ``first_tile`` (the TPU kernel's partition,
    flash_decode.py:119-122, over the band's tiles)."""
    tiles = (cache_seqlens + block_k - 1) // block_k - first_tile
    kps = (tiles + num_splits - 1) // num_splits
    return kps * block_k  # (b,) keys per split


def _pack_rows(x, h_k):
    """(b, sq, h, w) -> (b, h_k, sq * group, w) fp32: the rows of each KV
    head, row t * group + j for token t and head h_k * group + j."""
    b, sq, h, w = x.shape
    return x.float().reshape(b, sq, h_k, h // h_k, w).transpose(1, 2).reshape(
        b, h_k, -1, w)


def flash_attention_decode_partials_plain(q, k_cache, v_cache, cache_seqlens,
                                          num_splits: int, block_k: int,
                                          softmax_scale: float, causal: bool,
                                          qv=None,
                                          window_size=(None, None),
                                          attention_chunk: int = 0,
                                          softcap: float = 0.0,
                                          alibi_slopes=None,
                                          qk_descale=None, v_descale=None):
    """fp32 matmul, score map (dispatch/score.py: the cap, then ALiBi's
    bias with each batch row's cache length as sk), mask and softmax per
    split; scores q k^T (+ qv v^T). The caches are read exactly in fp32 (a
    1-byte cache's codes too); ``qk_descale`` and ``v_descale`` ((b, h_k)
    fp32) scale the scores before the map and each split's out, as JAX's
    kernel does (flash_decode.py:248-249, :307-308).
    Returns (out_p (num_splits, b, h_k, sq * group, dv), lse_p (num_splits,
    b, h_k, sq * group))."""
    b, sq, h, d = q.shape
    h_k, s_max = k_cache.shape[1], k_cache.shape[2]
    group = h // h_k
    rows = sq * group
    kf = k_cache[:b].float()
    vf = v_cache[:b].float()
    s = torch.matmul(_pack_rows(q, h_k), kf.transpose(-1, -2))  # (b,h_k,R,S)
    if qv is not None:
        s = s + torch.matmul(_pack_rows(qv, h_k), vf.transpose(-1, -2))
    s = s * softmax_scale
    if qk_descale is not None:
        s = s * qk_descale.float()[:, :, None, None]
    sk = cache_seqlens.long().clamp(max=s_max)  # the kernel cuts at capacity
    pos = torch.arange(s_max, device=q.device)
    tok = torch.arange(rows, device=q.device) // group
    slopes = slopes_bh(alibi_slopes, b, h, q.device)
    if slopes is not None:
        # packed row t * group + j is query head kh * group + j
        slopes = slopes.reshape(b, h_k, 1, group).expand(
            b, h_k, sq, group).reshape(b, h_k, rows, 1)
    s = score_map(s, softcap, slopes, alibi_bias(
        tok[None, None, :, None], pos, sq, sk[:, None, None, None], causal))
    valid = band_valid(tok[None, :, None], pos[None, None, :],
                       (sk - sq)[:, None, None], causal, window_size,
                       attention_chunk=attention_chunk, chunk_upper=False) \
        & (pos[None, None, :] < sk[:, None, None])              # (b, R, S)
    first = band_first_tile(sk, sq, window_size[0], attention_chunk, block_k)
    per_split = _split_bounds(sk, num_splits, block_k, first).clamp(min=1)
    split_of = (pos[None, :] - (first * block_k)[:, None]).div(
        per_split[:, None], rounding_mode="floor")              # (b, S)
    outs, lses = [], []
    for sp in range(num_splits):
        m = valid & (split_of == sp)[:, None, :]
        ss = s.masked_fill(~m[:, None], float("-inf"))
        lse = torch.logsumexp(ss, dim=-1)
        p = torch.exp(ss - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
        o = torch.matmul(p, vf)
        outs.append(o if v_descale is None
                    else o * v_descale.float()[:, :, None, None])
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


def flash_attention_decode_paged_partials_plain(
        q, k_pages, v_pages, cache_seqlens, block_table, num_splits: int,
        block_k: int, softmax_scale: float, causal: bool, qv=None,
        window_size=(None, None), attention_chunk: int = 0,
        softcap: float = 0.0, alibi_slopes=None, qk_descale=None,
        v_descale=None):
    """The paged cache's plain version: gather the pages into the linear
    layout, then :func:`flash_attention_decode_partials_plain`."""
    cap = cache_capacity(k_pages, block_table)
    lengths = cache_seqlens.long().clamp(max=cap)
    return flash_attention_decode_partials_plain(
        q, paged_to_linear(k_pages, block_table, lengths),
        paged_to_linear(v_pages, block_table, lengths), cache_seqlens,
        num_splits, block_k, softmax_scale, causal, qv=qv,
        window_size=window_size, attention_chunk=attention_chunk,
        softcap=softcap, alibi_slopes=alibi_slopes, qk_descale=qk_descale,
        v_descale=v_descale)


def flash_attention_decode_partials(q, k_cache, v_cache, cache_seqlens,
                                    num_splits: int, softmax_scale: float,
                                    causal: bool, block_table=None, qv=None,
                                    window_size=(None, None),
                                    attention_chunk: int = 0,
                                    softcap: float = 0.0, alibi_slopes=None,
                                    qk_descale=None, v_descale=None):
    """Split partials of decode attention; see
    :func:`flash_attention_decode_partials_plain` for the shapes.
    ``cache_seqlens`` (b,) int32 are the cache lengths after any append;
    cache row i (or block-table row i) serves batch row i. ``qv`` (b, sq,
    h, dv), or a value width dv != d, takes the MLA route
    (:func:`_mla_partials`). The d = dv route on the card reads the cache
    by TMA (a linear cache as b_c pages of s_max rows) and shares each split
    among a cluster of decode_cluster's blocks: a view whose strides are not
    multiples of 16 bytes, or whose start is not 16-byte aligned, raises
    ValueError. The d = dv route on the card reads a cache of q's type, or
    of 1-byte codes (float8_e4m3fn, int8) with a bf16 q; ``qk_descale``
    and ``v_descale`` (b, h_k) fp32 (None: ones) scale the scores and each
    split's out; the MLA route refuses them."""
    paged = block_table is not None
    descaled = qk_descale is not None or v_descale is not None
    masks = dict(window_size=window_size, attention_chunk=attention_chunk,
                 softcap=softcap, alibi_slopes=alibi_slopes,
                 qk_descale=qk_descale, v_descale=v_descale)
    mla = is_mla_form(q.shape[-1], v_cache.shape[-1], qv is not None)
    if (descaled or is_quantized(k_cache.dtype)) and mla:
        raise NotImplementedError(
            "flash_decode: descales or a 1-byte cache on the MLA route (qv, "
            "or dv != d) are not ported yet (ROADMAP.md queue A, item 7)")
    if has_score(softcap, alibi_slopes) and mla:
        raise NotImplementedError(
            "flash_decode: softcap or ALiBi on the MLA route (qv, or dv != "
            "d) is not ported yet (ROADMAP.md queue A, item 7)")
    if q.device.type == "cpu":
        if paged:
            return flash_attention_decode_paged_partials_plain(
                q, k_cache, v_cache, cache_seqlens, block_table, num_splits,
                DECODE_BLOCK_K, softmax_scale, causal, qv=qv, **masks)
        return flash_attention_decode_partials_plain(
            q, k_cache, v_cache, cache_seqlens, num_splits, DECODE_BLOCK_K,
            softmax_scale, causal, qv=qv, **masks)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    b, sq, h, d = q.shape
    b_c, h_k, s_max, dk = k_cache.shape
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"flash_decode kernel: dtype {q.dtype} (bf16/fp16)")
    check_cache_dtype("flash_decode kernel", k_cache.dtype, q.dtype)
    kv8 = is_quantized(k_cache.dtype)
    if kv8 and (q.dtype != torch.bfloat16 or v_cache.dtype != k_cache.dtype):
        raise ValueError(
            f"flash_decode kernel: a {k_cache.dtype} cache needs a bf16 q and "
            f"a V cache of its type; got q {q.dtype}, v {v_cache.dtype}")
    if ((not paged and b > b_c) or h % h_k or b * h_k > 2**31 - 1
            or num_splits > 65535 or dk != d
            or v_cache.shape[:-1] != k_cache.shape[:-1]):
        raise ValueError(f"flash_decode kernel: shapes q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}, v "
                         f"{tuple(v_cache.shape)}, splits {num_splits}")
    for name, x in (("cache_seqlens", cache_seqlens),
                    ("block_table", block_table)):
        if x is not None and (x.device != q.device or x.dtype != torch.int32
                              or x.shape[0] != b or x.stride(-1) != 1):
            raise ValueError(
                f"flash_decode kernel: {name} must be int32 on q's device "
                f"with a row per batch row and a contiguous last dim")
    if not cache_seqlens.is_contiguous() or cache_seqlens.dim() != 1:
        raise ValueError("flash_decode kernel: cache_seqlens must be a "
                         "contiguous (b,) tensor")
    if mla:
        if has_band(causal, window_size, attention_chunk):
            raise NotImplementedError(
                "flash_decode kernel: a window or attention_chunk on the MLA "
                "route is not ported yet (ROADMAP.md queue A, item 7)")
        return _mla_partials(q, k_cache, v_cache, cache_seqlens, num_splits,
                             softmax_scale, causal, block_table, qv)
    check_head_dims("flash_decode (the d = dv route)", d, dk,
                    v_cache.shape[-1], HEAD_DIMS)
    _build.check_operand("flash_decode", "q", q, q.dtype, q.device)
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        _build.check_operand("flash_decode", name, x, k_cache.dtype, q.device)
    for name, x in (("qk_descale", qk_descale), ("v_descale", v_descale)):
        if x is not None and (x.device != q.device or x.dtype != torch.float32
                              or x.shape != (b, h_k) or not x.is_contiguous()):
            raise ValueError(f"flash_decode kernel: {name} must be a "
                             f"contiguous (b, h_k) fp32 tensor on q's device")
    rows = sq * (h // h_k)
    out_p = torch.empty((num_splits, b, h_k, rows, d), dtype=torch.float32,
                        device=q.device)
    lse_p = torch.empty((num_splits, b, h_k, rows), dtype=torch.float32,
                        device=q.device)
    blocks = b * h_k * num_splits * -(-rows // DECODE_ROWS_PER_BLOCK)
    slopes = slopes_bh(alibi_slopes, b, h, q.device)
    slope_ptr, slope_sb = slope_args(slopes)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.fa_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_seqlens.data_ptr(),
            block_table.data_ptr() if paged else None,
            out_p.data_ptr(), lse_p.data_ptr(),
            b, sq, h, h_k, d, num_splits, DECODE_BLOCK_K, s_max,
            block_table.shape[1] if paged else 0, b_c,
            cache_capacity(k_cache, block_table),
            decode_cluster(blocks, num_sms(q.device.index)),
            q.stride(0), q.stride(1), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            block_table.stride(0) if paged else 0,
            softmax_scale * LOG2E, int(causal),
            *band_args(causal, window_size, 0, attention_chunk)[:2],
            attention_chunk, float(softcap), slope_ptr, slope_sb,
            KV_CODES.get(k_cache.dtype, 0),
            qk_descale.data_ptr() if qk_descale is not None else None,
            v_descale.data_ptr() if v_descale is not None else None,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fa_decode")
    global launches, launches_paged, launches_band, launches_paged_band
    global launches_score, launches_paged_score, launches_kv8
    global launches_paged_kv8
    band = has_band(causal, window_size, attention_chunk)
    score = has_score(softcap, alibi_slopes)
    if paged:
        launches_paged += 1
        launches_paged_band += band
        launches_paged_score += score
        launches_paged_kv8 += kv8
    else:
        launches += 1
        launches_band += band
        launches_score += score
        launches_kv8 += kv8
    return out_p, lse_p


def aliases_prefix(v, k) -> bool:
    """Whether v is a view of k's first v.shape[-1] columns (DeepSeek's
    latent cache: K 576 wide, V its first 512)."""
    return (v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
            and v.shape[:-1] == k.shape[:-1] and v.shape[-1] <= k.shape[-1])


def _mla_partials(q, k_cache, v_cache, cache_seqlens, num_splits,
                  softmax_scale, causal, block_table, qv):
    """The MLA route on the card (csrc/flash_decode_mla.cu, on the wgmma +
    TMA tile of csrc/mla_sm90.cuh): qv scores against V; the d, dv and qv of
    MLA_DECODE_DIMS; without qv, V must be K's first dv columns, read from
    the same tile. A linear cache goes to the kernel as b_c pages of s_max
    rows. The operands are read by TMA: a view whose strides are not
    multiples of 16 bytes, or whose start is not 16-byte aligned, raises
    ValueError."""
    b, sq, h, d = q.shape
    b_c, h_k, s_max, _ = k_cache.shape
    dv = v_cache.shape[-1]
    paged = block_table is not None
    if (d, dv, qv is not None) not in MLA_DECODE_DIMS:
        raise NotImplementedError(
            f"flash_decode kernel: (d, dv, qv) = ({d}, {dv}, "
            f"{qv is not None}) is not ported yet; the MLA route takes "
            f"{MLA_DECODE_DIMS} (ROADMAP.md queue A, item 7)")
    if qv is None and not aliases_prefix(v_cache, k_cache):
        raise NotImplementedError(
            f"flash_decode kernel: without qv, dv = {dv} needs v_cache to "
            f"be k_cache[..., :{dv}] (the latent cache); separate V caches "
            "of another width are not ported yet (ROADMAP.md queue A, "
            "item 7)")
    if qv is not None and qv.shape != (b, sq, h, dv):
        raise ValueError(f"flash_decode kernel: qv {tuple(qv.shape)}, want "
                         f"{(b, sq, h, dv)}")
    operands = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache)]
    if qv is not None:
        operands.append(("qv", qv))
    for name, x in operands:
        _build.check_operand("flash_decode_mla", name, x, q.dtype, q.device)
    group = h // h_k
    gb = math.gcd(group, MLA_TILE.block_q)  # heads of one position in a tile
    if -(-sq // (MLA_TILE.block_q // gb)) * (group // gb) > 65535:
        raise ValueError(f"flash_decode_mla kernel: {sq * group} rows a KV "
                         "head")
    rows = sq * group
    out_p = torch.empty((num_splits, b, h_k, rows, dv), dtype=torch.float32,
                        device=q.device)
    lse_p = torch.empty((num_splits, b, h_k, rows), dtype=torch.float32,
                        device=q.device)
    qvs = qv.stride() if qv is not None else (0, 0, 0, 0)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.fa_decode_mla(
            q.data_ptr(), qv.data_ptr() if qv is not None else None,
            k_cache.data_ptr(), v_cache.data_ptr(), cache_seqlens.data_ptr(),
            block_table.data_ptr() if paged else None,
            out_p.data_ptr(), lse_p.data_ptr(),
            b, sq, h, h_k, d, dv, int(qv is not None), num_splits,
            DECODE_BLOCK_K, s_max, block_table.shape[1] if paged else 0, b_c,
            cache_capacity(k_cache, block_table),
            q.stride(0), q.stride(1), q.stride(2), qvs[0], qvs[1], qvs[2],
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            block_table.stride(0) if paged else 0,
            softmax_scale * LOG2E, int(causal),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fa_decode_mla")
    global launches_mla
    launches_mla += 1
    return out_p, lse_p


def flash_attention_decode(q, k_cache, v_cache, cache_seqlens,
                           softmax_scale: Optional[float] = None,
                           causal: bool = False, num_splits: int = 1,
                           block_table=None, qv=None,
                           window_size=(None, None),
                           attention_chunk: int = 0, softcap: float = 0.0,
                           alibi_slopes=None, qk_descale=None,
                           v_descale=None):
    """q (b, sq, h, d); caches (b_c, h_k, s_max, d) and (b_c, h_k, s_max,
    dv), or pages (num_pages, h_k, page_size, d / dv) with ``block_table``
    (b, max_pages) int32; cache_seqlens (b,) int32 cache lengths after any
    append; ``qv`` (b, sq, h, dv) adds qv v^T to the scores;
    ``window_size`` (left, right) with None for no bound,
    ``attention_chunk``, ``softcap`` and ``alibi_slopes`` ((h,) or (b, h))
    as in the JAX function; ``qk_descale`` (q_descale · k_descale) and
    ``v_descale``, (b, h_k) fp32 or None. Returns (out (b, sq, h, dv) in
    q's type, lse (b, h, sq) fp32)."""
    b, sq, h, d = q.shape
    h_k = k_cache.shape[1]
    group = h // h_k
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    cap = cache_capacity(k_cache, block_table)
    num_splits = max(1, min(num_splits, -(-cap // DECODE_BLOCK_K)))
    out_p, lse_p = flash_attention_decode_partials(
        q, k_cache, v_cache, cache_seqlens, num_splits, softmax_scale, causal,
        block_table=block_table, qv=qv,
        window_size=reach_window(window_size, causal, sq, cap),
        attention_chunk=attention_chunk, softcap=softcap,
        alibi_slopes=alibi_slopes, qk_descale=qk_descale, v_descale=v_descale)
    if num_splits == 1:
        out, lse = out_p[0], lse_p[0]
    else:
        out, lse = combine_splits(out_p, lse_p)
    # (b, h_k, sq * group, dv) rows -> (b, sq, h, dv); lse -> (b, h, sq)
    out = out.reshape(b, h_k, sq, group, -1).permute(0, 2, 1, 3, 4).reshape(
        b, sq, h, -1).to(q.dtype)
    lse = lse.reshape(b, h_k, sq, group).transpose(2, 3).reshape(b, h, sq)
    return out, lse


def combine_splits(out_partial, lse_partial):
    """LSE-weighted merge of split-KV partials (flash_decode.py:708).

    out_partial: (num_splits, ..., dv) fp32, each normalised per split;
    lse_partial: (num_splits, ...) fp32, -inf for empty splits.
    Returns (out, lse) without the leading splits axis."""
    m = lse_partial.max(dim=0).values
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w = torch.exp(lse_partial - m_safe)  # exp(-inf) = 0 for empty splits
    denom = w.sum(dim=0)
    out = (out_partial * w[..., None]).sum(dim=0)
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    out = out / denom_safe[..., None]
    lse = torch.where(torch.isneginf(m), float("-inf"), m + torch.log(denom_safe))
    return out, lse
