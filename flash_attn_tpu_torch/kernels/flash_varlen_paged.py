"""Packed-varlen prefill over a paged KV cache: the CUDA kernel
``csrc/flash_varlen_paged.cu`` and its plain PyTorch version.

Port of flash_attn_tpu/kernels/flash_varlen_paged.py
``flash_attention_varlen_paged_fwd`` (bf16/fp16, head dims in HEAD_DIMS,
with its sliding window, :249-254, its softcap, :225-233, and its
descales, :230-241, :276-277, over pages of q's type or of 1-byte codes,
and its learnable sink, :194-207, dispatch/sink.py; no ``qv``: the JAX
kernel has no chunk, sink tokens or ALiBi either). The descales ((b, h_k) fp32) are runtime fields of the
kernel: q_descale · k_descale scales each block's scores (before the cap,
as JAX's :225-233) and v_descale its 1 / l. Pages of 1-byte codes
(float8_e4m3fn, int8) are first converted, the pages each row reaches
alone, into a pool of q's type by ``kernels/kv_dequant.py`` (B11's
conversion), over which B8 runs as it is. A call with a window launches the kernel's band
instantiation, whose blocks read only the pages of their rows' window; one
with a cap its score instantiation (with or without the window); the sink
runs in every instantiation's epilogue, with v_descale still scaling its
1 / l. Query chunks are
packed along one token axis by ``cu_seqlens_q``; ``seqused_q`` gives each
sequence's true length when the layout pads every slot to one length (the
padded-flat layout of the engine's prefix-cached prefill). The JAX function
gathers q into a tile-aligned copy and walks a flat work list; here the
wrapper counts each sequence's tiles of FWD_TILE's 128 rows
(:func:`tile_ends`) with torch ops and no host sync, the kernel walks them
head by head, and it reads q and writes out in the packed layout directly.
The operands are read by TMA: a view whose strides are not multiples of 16
bytes, or whose start is not 16-byte aligned, raises ValueError. A tensor
on the CPU takes the plain version; a CUDA tensor launches the kernel or
raises.
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
    FWD_TILE,
    HEAD_DIMS,
    check_head_dims,
    scale_log2,
)
from flash_attn_tpu_torch.dispatch.kvquant import (
    check_cache_dtype,
    is_quantized,
)
from flash_attn_tpu_torch.dispatch.score import score_map
from flash_attn_tpu_torch.dispatch.sink import (
    lse_fill,
    sink_arg,
    sink_ptr,
    with_sink,
)
from flash_attn_tpu_torch.dispatch.varlen_meta import (
    num_tiles_bound,
    sequence_lengths,
)
from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.kv_dequant import dequant_pages
from flash_attn_tpu_torch.utils.testing import paged_to_linear


# Kernel launches since the last reset (plain calls not counted): all of
# them, those of the band and of the score instantiations among them, and
# those with descales and those with a learnable sink.
launches = 0
launches_band = 0
launches_score = 0
launches_descale = 0
launches_sink = 0


def tile_ends(lens_q, block_q: int):
    """(b,) int32 running count of the tiles of ``block_q`` rows over
    sequences of ``lens_q`` rows: sequence s owns tiles tile_ends[s - 1]
    .. tile_ends[s] - 1, the kernel's work list."""
    return torch.cumsum((lens_q + block_q - 1) // block_q, 0,
                        dtype=torch.int32)


def _lengths(cu_seqlens_q, seqused_q):
    """(addressed rows per sequence, true query rows per sequence)."""
    lens_addr = cu_seqlens_q[1:] - cu_seqlens_q[:-1]
    return lens_addr, lens_addr if seqused_q is None else seqused_q


def flash_attention_varlen_paged_fwd_plain(
        q, k_pages, v_pages, cu_seqlens_q, max_seqlen_q: int, seqlens_k,
        block_table, seqused_q=None, softmax_scale: Optional[float] = None,
        causal: bool = False, window_size=(None, None), softcap: float = 0.0,
        qk_descale=None, v_descale=None, learnable_sink=None):
    """Gather the pages into the linear layout (1-byte codes read exactly),
    pad the packed queries per sequence, and compute capped (``softcap``),
    masked attention in fp32, the scores scaled by ``qk_descale`` before the
    cap and the output by ``v_descale`` ((b, h_k) fp32), the (h,)
    ``learnable_sink`` in each row's softmax. Returns out (total_q, h, dv)
    in q's type and lse (h, total_q) fp32, with zeros and -inf (the sink
    under one) for the rows that see no key."""
    total_q, h, d = q.shape
    sink = sink_arg("flash_varlen_paged", learnable_sink, h, q.device)
    h_k = k_pages.shape[1]
    group = h // h_k
    dev = q.device
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    cu = cu_seqlens_q.to(dev, torch.long)
    lens_addr, lens_q = _lengths(cu, None if seqused_q is None
                                 else seqused_q.to(dev, torch.long))
    lens_k = seqlens_k.to(dev, torch.long)
    k_lin = paged_to_linear(k_pages, block_table, lens_k).float()
    v_lin = paged_to_linear(v_pages, block_table, lens_k).float()
    # (b, max_seqlen_q) packed row of each padded query row
    pos_q = torch.arange(max_seqlen_q, device=dev)
    rows = (cu[:-1, None] + pos_q[None]).clamp(0, max(total_q - 1, 0))
    qd = q.float()[rows] if total_q else q.float().new_zeros(
        rows.shape + (h, d))
    qd = qd.reshape(-1, max_seqlen_q, h_k, group, d).permute(0, 2, 3, 1, 4)
    s = torch.einsum("bkgmd,bksd->bkgms", qd, k_lin) * scale
    if qk_descale is not None:
        s = s * qk_descale.to(dev).float()[:, :, None, None, None]
    s = score_map(s, softcap)
    pos_k = torch.arange(k_lin.shape[2], device=dev)
    valid = (pos_q[None, :, None] < lens_q[:, None, None]) \
        & (pos_k[None, None, :] < lens_k[:, None, None])
    if causal or has_band(causal, window_size):
        shift = (lens_k - lens_q)[:, None, None]
        valid = valid & band_valid(pos_q[None, :, None], pos_k[None, None, :],
                                   shift, causal, window_size)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    lse = with_sink(torch.logsumexp(s, dim=-1),             # (b, h_k, g, M)
                    None if sink is None else sink.view(h_k, group))
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    out = torch.einsum("bkgms,bksd->bmkgd", p, v_lin)
    if v_descale is not None:
        out = out * v_descale.to(dev).float()[:, None, :, None, None]
    out = out.reshape(-1, max_seqlen_q, h, v_pages.shape[-1])
    lse = lse.reshape(-1, h, max_seqlen_q)
    # back to the packed layout: token t is row t - cu[s] of its sequence s
    tok = torch.arange(total_q, device=dev)
    seq = torch.searchsorted(cu[1:], tok, right=True).clamp(max=cu.numel() - 2)
    loc = tok - cu[seq]
    live = loc < torch.minimum(lens_addr[seq],
                               torch.full_like(loc, max_seqlen_q))
    loc = loc.clamp(0, max_seqlen_q - 1)
    out_p = torch.where(live[:, None, None], out[seq, loc], 0.0).to(q.dtype)
    lse_p = torch.where(live[None], lse[seq, :, loc].T,
                        lse_fill(sink, h, total_q, dev))
    return out_p, lse_p


def flash_attention_varlen_paged_fwd(
        q, k_pages, v_pages, cu_seqlens_q, max_seqlen_q: int, seqlens_k,
        block_table, seqused_q=None, softmax_scale: Optional[float] = None,
        causal: bool = False, window_size=(None, None), softcap: float = 0.0,
        qk_descale=None, v_descale=None, learnable_sink=None):
    """q (total_q, h, d) packed by cu_seqlens_q (b + 1,); pages (num_pages,
    h_k, page_size, d) of q's type or of 1-byte codes; seqlens_k (b,) key
    counts including the chunk; block_table (b, max_pages); seqused_q (b,)
    true query lengths or None. ``max_seqlen_q`` bounds cu_seqlens_q's
    deltas; ``window_size`` (left, right) with None for no bound;
    ``softcap`` (0: none); ``qk_descale`` (q_descale · k_descale) and
    ``v_descale`` (b, h_k) fp32 or None; ``learnable_sink`` (h,) on q's
    device (dispatch/sink.py). Returns (out (total_q, h, d) in q's type,
    lse (h, total_q) fp32)."""
    if q.device.type == "cpu":
        return flash_attention_varlen_paged_fwd_plain(
            q, k_pages, v_pages, cu_seqlens_q, max_seqlen_q, seqlens_k,
            block_table, seqused_q, softmax_scale, causal, window_size,
            softcap, qk_descale, v_descale, learnable_sink)
    if q.device.type != "cuda":
        raise ValueError(f"flash_varlen_paged: unsupported device {q.device}")
    total_q, h, d = q.shape
    num_pages, h_k, page_size, dk = k_pages.shape
    b = cu_seqlens_q.numel() - 1
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"flash_varlen_paged kernel: dtype {q.dtype} "
                         "(bf16/fp16 only)")
    check_head_dims("flash_varlen_paged", d, dk, v_pages.shape[-1],
                    HEAD_DIMS)
    check_cache_dtype("flash_varlen_paged kernel", k_pages.dtype, q.dtype)
    for name, x in (("qk_descale", qk_descale), ("v_descale", v_descale)):
        if x is not None and (x.device != q.device or x.dtype != torch.float32
                              or x.shape != (b, h_k) or not x.is_contiguous()):
            raise ValueError(f"flash_varlen_paged kernel: {name} must be a "
                             "contiguous (b, h_k) fp32 tensor on q's device")
    sink = sink_arg("flash_varlen_paged", learnable_sink, h, q.device)
    if h % h_k or block_table.shape[0] != b or b < 1 \
            or v_pages.shape != k_pages.shape:
        raise ValueError(f"flash_varlen_paged kernel: shapes q {tuple(q.shape)}"
                         f", pages {tuple(k_pages.shape)}, table "
                         f"{tuple(block_table.shape)}, {b} sequences")
    _build.check_operand("flash_varlen_paged", "q", q, q.dtype, q.device)
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        _build.check_operand("flash_varlen_paged", name, x, k_pages.dtype,
                             q.device)

    def as_int32(x):
        return x.to(q.device, torch.int32).contiguous()

    cu = as_int32(cu_seqlens_q)
    lens_q, lens_k, table = (as_int32(x) for x in (
        sequence_lengths(cu, seqused_q), seqlens_k, block_table))
    if is_quantized(k_pages.dtype):
        # B11's conversion: the pages each row reaches, into q's type
        k_pages, v_pages, table = dequant_pages(k_pages, v_pages, table,
                                                lens_k, q.dtype)
        num_pages = k_pages.shape[0]
    tile = FWD_TILE
    # rows past seqused_q are in no tile: they keep out's zeros and lse's
    # fill (-inf, or the sink)
    ends = tile_ends(lens_q, tile.block_q)
    num_tiles = num_tiles_bound(b, max_seqlen_q, total_q, tile.block_q)
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    out = torch.zeros_like(q)
    lse = lse_fill(sink, h, total_q, q.device)
    # keys a sequence can hold: its pages
    window = reach_window(window_size, causal, max_seqlen_q,
                          table.shape[1] * page_size)
    band = has_band(causal, window)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.fa_varlen_paged(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            cu.data_ptr(), lens_q.data_ptr(), lens_k.data_ptr(),
            table.data_ptr(), ends.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, num_tiles, total_q, h, h_k, d, page_size, table.shape[1],
            num_pages, tile.block_q, tile.block_k,
            q.stride(0), q.stride(1),
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
            out.stride(0), out.stride(1), table.stride(0),
            scale_log2(scale), int(causal), *band_args(causal, window)[:2],
            int(band), float(softcap),
            qk_descale.data_ptr() if qk_descale is not None else None,
            v_descale.data_ptr() if v_descale is not None else None,
            sink_ptr(sink), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fa_varlen_paged")
    global launches, launches_band, launches_score, launches_descale
    global launches_sink
    launches += 1
    launches_sink += sink is not None
    launches_band += band
    launches_score += softcap > 0.0
    launches_descale += qk_descale is not None or v_descale is not None
    return out, lse
