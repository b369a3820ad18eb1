"""Chunked prefill against a paged KV cache with the MLA second query
``qv``: the CUDA kernel ``csrc/flash_paged_prefill.cu`` and its plain
PyTorch version.

Port of flash_attn_tpu/kernels/flash_paged_prefill.py
``flash_attention_paged_prefill`` (:260): a dense-padded chunk of queries
(b, sq_max, h, d), of which sequence s uses its first seqused_q[s] rows,
attends to the first cache_seqlens[s] keys of its pages (the chunk's own
keys included), bottom-right causal: query row r sits at key position
cache_seqlens[s] - seqused_q[s] + r. Scores are q k^T + qv v^T; the value
width dv may differ from d. ``learnable_sink`` (h,) adds one more logit
to each row's softmax, its own head's (JAX :231-243, dispatch/sink.py).
Rows at or past seqused_q give zeros and lse -inf (the sink under one).
The JAX function pads d and dv to 128 lanes and batch-chunks its page
table for the TPU compiler; neither is needed here.

The kernel (wgmma and TMA page copies, csrc/flash_paged_prefill.cu) reads
q, qv and out in the packed layout of
``flash_attn_varlen_func`` through a start row per sequence, so
:func:`flash_attention_paged_prefill_varlen` serves the varlen entry point
without padding, and the dense signature views its batch as packed rows.
bf16/fp16 on the card, in the forms of ``PAGED_PREFILL_DIMS``; window,
softcap and descales raise. A tensor on the CPU takes
the plain version; a CUDA tensor launches the kernel or raises.
"""

import math
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.config import (
    MLA_TILE,
    PAGED_PREFILL_DIMS,
    default_scale,
    normalize_window,
)
from flash_attn_tpu_torch.dispatch.sink import (
    lse_fill,
    sink_arg,
    sink_ptr,
    with_sink,
)
from flash_attn_tpu_torch.dispatch.varlen_meta import sequence_lengths
from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.utils.testing import paged_to_linear

LOG2E = math.log2(math.e)

# Kernel launches since the last reset (plain calls not counted), and
# those with a learnable sink among them.
launches = 0
launches_sink = 0


def flash_attention_paged_prefill_plain(
        q, k_cache, v_cache, seqused_q, cache_seqlens, block_table, qv=None,
        softmax_scale: Optional[float] = None, causal: bool = True,
        learnable_sink=None):
    """Gather the pages into the linear layout and compute masked attention
    in fp32, with the (h,) ``learnable_sink`` in each row's softmax.
    Returns (out (b, sq_max, h, dv) in q's type, lse (b, h, sq_max) fp32),
    zeros and -inf (the sink under one) for rows that see no key."""
    b, sq_max, h, d = q.shape
    sink = sink_arg("flash_paged_prefill", learnable_sink, h, q.device)
    h_k, dv = k_cache.shape[1], v_cache.shape[-1]
    group = h // h_k
    dev = q.device
    if softmax_scale is None:
        softmax_scale = default_scale(d, dv, qv is not None)
    lens_q = seqused_q.to(dev, torch.long).clamp(max=sq_max)
    lens_k = cache_seqlens.to(dev, torch.long)
    k_lin = paged_to_linear(k_cache, block_table, lens_k).float()
    v_lin = paged_to_linear(v_cache, block_table, lens_k).float()

    def heads(x):  # (b, sq_max, h, w) -> (b, h_k, group, sq_max, w)
        return x.float().reshape(b, sq_max, h_k, group, -1).permute(0, 2, 3, 1, 4)

    s = torch.einsum("bkgmd,bksd->bkgms", heads(q), k_lin)
    if qv is not None:
        s = s + torch.einsum("bkgmd,bksd->bkgms", heads(qv), v_lin)
    s = s * softmax_scale
    pos_q = torch.arange(sq_max, device=dev)
    pos_k = torch.arange(k_lin.shape[2], device=dev)
    valid = (pos_q[None, :, None] < lens_q[:, None, None]) \
        & (pos_k[None, None, :] < lens_k[:, None, None])        # (b, M, S)
    if causal:
        shift = (lens_k - lens_q)[:, None, None]
        valid = valid & (pos_k[None, None, :] <= pos_q[None, :, None] + shift)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    lse = with_sink(torch.logsumexp(s, dim=-1),                 # (b, h_k, g, M)
                    None if sink is None else sink.view(h_k, group))
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    out = torch.einsum("bkgms,bksd->bmkgd", p, v_lin).reshape(
        b, sq_max, h, dv).to(q.dtype)
    return out, lse.reshape(b, h, sq_max)


def prefill_row_tiles(max_rows_q: int, group: int) -> int:
    """Row tiles of the kernel's grid for chunks of at most ``max_rows_q``
    positions at ``group`` query heads a KV head: a tile is PB positions by
    GB heads, GB = gcd(group, 64) and PB = 64 / GB."""
    gb = math.gcd(group, MLA_TILE.block_q)
    return -(-max_rows_q // (MLA_TILE.block_q // gb)) * (group // gb)


def _launch(q, qv, k_cache, v_cache, starts, lens_q, lens_k, block_table,
            max_rows_q: int, softmax_scale: float, causal: bool, out, lse,
            sink=None):
    """The kernel over packed q (total, h, d), qv (total, h, dv): sequence
    s owns rows starts[s] .. starts[s] + lens_q[s] (lens_q <= max_rows_q);
    writes those rows of out (total, h, dv) and lse (h, total), leaving the
    others as the caller filled them; ``sink`` is sink_arg's."""
    total, h, d = q.shape
    num_pages, h_k, page_size, dk = k_cache.shape
    dv = v_cache.shape[-1]
    b = starts.numel()
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"flash_paged_prefill kernel: dtype {q.dtype} "
                         "(bf16/fp16 only)")
    if (d, dv, qv is not None) not in PAGED_PREFILL_DIMS:
        raise NotImplementedError(
            f"flash_paged_prefill kernel: (d, dv, qv) = ({d}, {dv}, "
            f"{qv is not None}) is not ported yet; it takes "
            f"{PAGED_PREFILL_DIMS} (ROADMAP.md queue A, item 7)")
    row_tiles = prefill_row_tiles(max_rows_q, h // max(h_k, 1))
    if (dk != d or h % h_k or v_cache.shape[:-1] != k_cache.shape[:-1]
            or block_table.shape[0] != b or b * h_k > 2**31 - 1
            or row_tiles > 65535
            or (qv is not None and qv.shape != (total, h, dv))):
        raise ValueError(
            f"flash_paged_prefill kernel: shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, table "
            f"{tuple(block_table.shape)}, {b} sequences")
    operands = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache)]
    if qv is not None:
        operands.append(("qv", qv))
    for name, x in operands:
        _build.check_operand("flash_paged_prefill", name, x, q.dtype,
                             q.device)

    def as_int32(x):
        return x.to(q.device, torch.int32).contiguous()

    starts, lens_q, lens_k, table = (as_int32(x) for x in (
        starts, lens_q, lens_k, block_table))
    qvs = qv.stride() if qv is not None else (0, 0)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.fa_paged_prefill(
            q.data_ptr(), qv.data_ptr() if qv is not None else None,
            k_cache.data_ptr(), v_cache.data_ptr(), starts.data_ptr(),
            lens_q.data_ptr(), lens_k.data_ptr(), table.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, total, row_tiles, h, h_k, d, dv,
            int(qv is not None), page_size, table.shape[1], num_pages,
            q.stride(0), q.stride(1), qvs[0], qvs[1],
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            out.stride(0), out.stride(1), lse.stride(1), lse.stride(0),
            table.stride(0), softmax_scale * LOG2E, int(causal),
            sink_ptr(sink), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fa_paged_prefill")
    global launches, launches_sink
    launches += 1
    launches_sink += sink is not None


def flash_attention_paged_prefill(
        q, k_cache, v_cache, seqused_q, cache_seqlens, block_table, qv=None,
        learnable_sink=None, q_descale=None, k_descale=None, v_descale=None,
        softmax_scale: Optional[float] = None, causal: bool = True,
        window_size: Tuple[Optional[int], Optional[int]] = (None, None),
        softcap: float = 0.0):
    """q (b, sq_max, h, d) dense padded; pages (num_pages, h_k, page_size,
    d) and (num_pages, h_k, page_size, dv); seqused_q (b,) query rows in
    use; cache_seqlens (b,) keys of each sequence, the chunk included;
    block_table (b, max_pages) int32; qv (b, sq_max, h, dv); learnable_sink
    (h,) on q's device. The scale defaults to 1/sqrt(d) (1/sqrt(d + dv)
    with qv). Returns (out (b, sq_max, h, dv) in q's type, lse (b, h,
    sq_max) fp32); rows at or past seqused_q give zeros and -inf (the sink
    under one)."""
    from flash_attn_tpu_torch.interface import reject_unsupported

    reject_unsupported(
        "flash_attention_paged_prefill", roadmap_item="queue A, item 7",
        window_size=normalize_window(tuple(window_size)), softcap=softcap,
        q_descale=q_descale, k_descale=k_descale, v_descale=v_descale)
    if q.device.type == "cpu":
        return flash_attention_paged_prefill_plain(
            q, k_cache, v_cache, seqused_q, cache_seqlens, block_table, qv,
            softmax_scale, causal, learnable_sink)
    if q.device.type != "cuda":
        raise ValueError(f"flash_paged_prefill: unsupported device {q.device}")
    b, sq_max, h, d = q.shape
    sink = sink_arg("flash_paged_prefill", learnable_sink, h, q.device)
    dv = v_cache.shape[-1]
    if softmax_scale is None:
        softmax_scale = default_scale(d, dv, qv is not None)
    starts = torch.arange(b, dtype=torch.int32, device=q.device) * sq_max
    lens_q = seqused_q.to(q.device, torch.int32).clamp(0, sq_max)
    out = torch.zeros((b * sq_max, h, dv), dtype=q.dtype, device=q.device)
    lse = lse_fill(sink, h, b * sq_max, q.device)
    _launch(q.reshape(b * sq_max, h, d),
            None if qv is None else qv.reshape(b * sq_max, h, dv),
            k_cache, v_cache, starts, lens_q, cache_seqlens, block_table,
            sq_max, softmax_scale, causal, out, lse, sink)
    return (out.reshape(b, sq_max, h, dv),
            lse.reshape(h, b, sq_max).permute(1, 0, 2))


def flash_attention_paged_prefill_varlen_plain(
        q, k_cache, v_cache, cu_seqlens_q, max_seqlen_q: int, seqlens_k,
        block_table, seqused_q=None, qv=None,
        softmax_scale: Optional[float] = None, causal: bool = False,
        learnable_sink=None):
    """Pack -> pad per sequence -> :func:`flash_attention_paged_prefill_plain`
    -> unpack, as the JAX package pads for its kernel
    (interface.py:549-591), but keeping ``seqused_q``."""
    total_q, h, d = q.shape
    sink = sink_arg("flash_paged_prefill", learnable_sink, h, q.device)
    b = cu_seqlens_q.numel() - 1
    sq_max = max(int(max_seqlen_q), 1)
    cu = cu_seqlens_q.to(q.device, torch.long)
    lens_q = sequence_lengths(cu, seqused_q).long()
    pos = torch.arange(sq_max, device=q.device)
    gather = (cu[:-1, None] + pos[None]).clamp(0, max(total_q - 1, 0))

    def dense(x):
        if total_q == 0:
            return x.new_zeros((b, sq_max) + x.shape[1:])
        return x[gather.reshape(-1)].reshape((b, sq_max) + x.shape[1:])

    out_d, lse_d = flash_attention_paged_prefill_plain(
        dense(q), k_cache, v_cache, lens_q, seqlens_k, block_table,
        None if qv is None else dense(qv), softmax_scale, causal, sink)
    tok = torch.arange(total_q, device=q.device)
    seq = torch.searchsorted(cu[1:], tok, right=True).clamp(max=max(b - 1, 0))
    loc = tok - cu[seq]
    live = loc < lens_q[seq]
    loc = loc.clamp(0, sq_max - 1)
    out = torch.where(live[:, None, None], out_d[seq, loc], 0.0).to(q.dtype)
    lse = torch.where(live[None], lse_d[seq, :, loc].T,
                      lse_fill(sink, h, total_q, q.device))
    return out, lse


def flash_attention_paged_prefill_varlen(
        q, k_cache, v_cache, cu_seqlens_q, max_seqlen_q: int, seqlens_k,
        block_table, seqused_q=None, qv=None,
        softmax_scale: Optional[float] = None, causal: bool = False,
        learnable_sink=None):
    """The same over packed queries: q (total_q, h, d) and qv (total_q, h,
    dv) by cu_seqlens_q (b + 1,), sequence s's first seqused_q[s] rows (all
    of them when None) in use. Returns (out (total_q, h, dv), lse (h,
    total_q) fp32), zeros and -inf (the sink under one) on rows in no
    sequence or past seqused_q. The kernel reads the packed layout in
    place."""
    total_q, h, d = q.shape
    dv = v_cache.shape[-1]
    if softmax_scale is None:
        softmax_scale = default_scale(d, dv, qv is not None)
    if q.device.type == "cpu":
        return flash_attention_paged_prefill_varlen_plain(
            q, k_cache, v_cache, cu_seqlens_q, max_seqlen_q, seqlens_k,
            block_table, seqused_q, qv, softmax_scale, causal, learnable_sink)
    if q.device.type != "cuda":
        raise ValueError(f"flash_paged_prefill: unsupported device {q.device}")
    sink = sink_arg("flash_paged_prefill", learnable_sink, h, q.device)
    out = torch.zeros((total_q, h, dv), dtype=q.dtype, device=q.device)
    lse = lse_fill(sink, h, total_q, q.device)
    _launch(q, qv, k_cache, v_cache, cu_seqlens_q[:-1],
            sequence_lengths(cu_seqlens_q.to(q.device), seqused_q),
            seqlens_k, block_table, int(max_seqlen_q), softmax_scale, causal,
            out, lse, sink)
    return out, lse
