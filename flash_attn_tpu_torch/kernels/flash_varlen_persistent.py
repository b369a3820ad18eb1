"""Packed varlen attention forward on a persistent grid (B7): the CUDA
kernel ``fa_varlen_fwd_persistent`` of ``csrc/flash_varlen_fwd.cu`` and its
plain PyTorch version.

Port of flash_attn_tpu/kernels/flash_varlen_persistent.py
``flash_attention_varlen_fwd_persistent`` (:335): the same function as the
B6 forward (kernels/flash_varlen.py), computed by resident blocks that walk
a static work list. The TPU kernel gives one grid step per head a flat list
of (q tile, kv tile) items and keeps a 4-deep K/V DMA ring full across
them. Here the items are the (128-row q tile, head) pairs of B6's own list
(dispatch/varlen_meta.py ``schedule``, longest KV band first, head by head),
and a grid of SM count x resident blocks per SM walks them with a stride.
Each item runs the wgmma/TMA tile of csrc/fwd_sm90.cuh, as B6 does, so B7
gives B6's bits; a block's two-stage K/V ring carries across its items,
the next item's first K/V tile (and, at head dim 64, where a block keeps a
second Q tile, its Q) loading under the current item's last tile and
epilogue. ``window_size`` and ``attention_chunk`` (per sequence, as B6)
launch the kernel's band instantiation, whose items walk the key tiles of
their band from its first; ``softcap`` and ``alibi_slopes`` (as B6: each
sequence its row of slopes) its score instantiation; ``learnable_sink``
(dispatch/sink.py) runs in every instantiation's epilogue, and the rows
of the items that see no key keep the wrapper's fill of lse, the sink. A
tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

import math
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.band import band_valid
from flash_attn_tpu_torch.dispatch.config import FWD_TILE
from flash_attn_tpu_torch.dispatch.score import alibi_bias, has_score, score_map
from flash_attn_tpu_torch.dispatch.sink import lse_fill, sink_arg, with_sink
from flash_attn_tpu_torch.kernels.flash_varlen import (
    check_kernel_inputs,
    check_meta,
    kernel_band,
    launch_fwd,
    seq_slopes,
    varlen_meta,
)

# Kernel launches since the last reset (plain calls not counted), and the
# band and the score instantiations' and those with a learnable sink among
# them.
launches = 0
launches_band = 0
launches_score = 0
launches_sink = 0
last_grid = 0  # blocks of the last launch's grid

Window = Tuple[Optional[int], Optional[int]]


def _band_keys(row0: int, rows: int, lq: int, lk: int, causal: bool,
               window: Window, chunk: int):
    """[lo, hi) of the keys that some row of the tile [row0, row0 + rows)
    of a sequence of lq rows over lk keys sees (bottom-right aligned), as
    csrc/common.cuh KeyRange bounds them; hi <= lo when none."""
    shift = lk - lq
    r_hi = row0 + rows - 1
    left, right = window
    right = 0 if causal else right
    lo, hi = 0, lk - 1
    if right is not None:
        hi = min(hi, r_hi + shift + right)
    if left is not None:
        lo = max(lo, row0 + shift - left)
    if chunk > 0:
        lo = max(lo, (row0 + shift) // chunk * chunk)
        hi = min(hi, (r_hi + shift) // chunk * chunk + chunk - 1)
    return lo, hi + 1


def _tile_plain(q, k, v, row0, key0, lq, lk, softmax_scale, causal, window,
                chunk, softcap=0.0, slopes=None, sink=None):
    """Rows [row0, row0 + q rows) of one sequence of lq rows over lk keys
    against its keys [key0, key0 + k rows), mapped by ``softcap`` and the
    sequence's ``slopes`` (h,) (dispatch/score.py), masked by the causal
    bound and the band at the sequence's own row, key and shift
    (band_valid), with the (h,) ``sink`` in each row's softmax, in fp32. q
    (rows, h, d), k/v (keys, h_k, d); returns out (1, h, rows, d) and lse
    (1, h, rows)."""
    qt, kt, vt = (x.transpose(0, 1)[None].float() for x in (q, k, v))
    group = qt.shape[1] // kt.shape[1]
    kt, vt = (x.repeat_interleave(group, dim=1) for x in (kt, vt))
    scale = (1.0 / math.sqrt(q.shape[-1]) if softmax_scale is None
             else softmax_scale)
    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    rows = torch.arange(row0, row0 + q.shape[0], device=q.device)[:, None]
    cols = torch.arange(key0, key0 + k.shape[0], device=q.device)[None, :]
    s = score_map(s, softcap,
                  None if slopes is None else slopes[:, None, None],
                  alibi_bias(rows, cols, lq, lk, causal))
    s = s.masked_fill(~band_valid(rows, cols, lk - lq, causal, window, 0,
                                  chunk), float("-inf"))
    lse = with_sink(torch.logsumexp(s, dim=-1), sink)
    seen = torch.isfinite(lse)
    p = torch.exp(s - torch.where(seen, lse, 0.0)[..., None])
    return torch.matmul(p, vt).to(q.dtype), lse


def flash_attention_varlen_fwd_persistent_plain(
        q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q: int,
        max_seqlen_k: int, seqused_q=None, seqused_k=None,
        softmax_scale: Optional[float] = None, causal: bool = False,
        meta=None, window_size: Window = (None, None),
        attention_chunk: int = 0, softcap: float = 0.0, alibi_slopes=None,
        learnable_sink=None):
    """The kernel's walk in fp32: the items of the persistent schedule in
    order, each 128-row tile (all heads at once) against the keys of its
    band (causal, window and chunk: from the band's first key to its last)
    under the score map, the band's mask and the sink. Returns out
    (total_q, h, dv) in q's type and lse (h, total_q) fp32, as the B6
    forward does."""
    sink = sink_arg("flash_varlen_fwd_persistent", learnable_sink,
                    q.shape[1], q.device)
    meta = varlen_meta(q, k, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                       max_seqlen_k, seqused_q, seqused_k, causal, meta,
                       window_size, attention_chunk)
    total_q, h, _ = q.shape
    out = q.new_zeros((total_q, h, v.shape[-1]))
    lse = lse_fill(sink, h, total_q, q.device)
    cu_q, cu_k = cu_seqlens_q.tolist(), cu_seqlens_k.tolist()
    lens_q, lens_k = meta.lens_q.tolist(), meta.lens_k.tolist()
    slopes = seq_slopes(alibi_slopes, cu_seqlens_q, h, q.device)
    for seq, row0 in meta.schedule.tolist():
        if seq < 0:
            break  # dead tiles sort last
        lq, lk = lens_q[seq], lens_k[seq]
        rows = min(FWD_TILE.block_q, lq - row0)
        lo, hi = _band_keys(row0, rows, lq, lk, causal, window_size,
                            attention_chunk)
        if hi <= lo:
            continue  # rows that see no key keep zeros and lse's fill
        q0, k0 = cu_q[seq] + row0, cu_k[seq] + lo
        o, l = _tile_plain(q[q0:q0 + rows], k[k0:k0 + hi - lo],
                           v[k0:k0 + hi - lo], row0, lo, lq, lk,
                           softmax_scale, causal, window_size,
                           attention_chunk, softcap,
                           None if slopes is None else slopes[seq], sink)
        out[q0:q0 + rows] = o[0].transpose(0, 1)
        lse[:, q0:q0 + rows] = l[0]
    return out, lse


def flash_attention_varlen_fwd_persistent(
        q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q: int,
        max_seqlen_k: int, seqused_q=None, seqused_k=None,
        softmax_scale: Optional[float] = None, causal: bool = False,
        meta=None, window_size: Window = (None, None),
        attention_chunk: int = 0, softcap: float = 0.0, alibi_slopes=None,
        learnable_sink=None):
    """Arguments and results as kernels/flash_varlen.py
    ``flash_attention_varlen_fwd``. CUDA: a grid of SM count x resident
    blocks per SM walking the sorted (q tile, head) items with a stride."""
    if q.device.type == "cpu":
        return flash_attention_varlen_fwd_persistent_plain(
            q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
            seqused_q, seqused_k, softmax_scale, causal, meta, window_size,
            attention_chunk, softcap, alibi_slopes, learnable_sink)
    check_kernel_inputs("flash_varlen_fwd_persistent", q, k, v, cu_seqlens_q,
                        cu_seqlens_k)
    sink = sink_arg("flash_varlen_fwd_persistent", learnable_sink,
                    q.shape[1], q.device)
    if meta is not None:
        check_meta("flash_varlen_fwd_persistent", meta, cu_seqlens_q,
                   cu_seqlens_k, max_seqlen_q, max_seqlen_k, q.shape[0],
                   k.shape[0], backward=False)
    global launches, launches_band, launches_score, launches_sink, last_grid
    if q.shape[0] == 0 or k.shape[0] == 0:  # no row sees a key
        last_grid = 0
        return (torch.zeros_like(q),
                lse_fill(sink, q.shape[1], q.shape[0], q.device))
    meta = varlen_meta(q, k, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                       max_seqlen_k, seqused_q, seqused_k, causal, meta,
                       window_size, attention_chunk)
    band = kernel_band(causal, window_size, attention_chunk, max_seqlen_q,
                       max_seqlen_k)
    out, lse, grid = launch_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k, meta,
                                softmax_scale, causal, persistent=True,
                                band=band, softcap=softcap,
                                alibi_slopes=alibi_slopes, sink=sink)
    launches += 1
    launches_band += band[-1]
    launches_score += has_score(softcap, alibi_slopes)
    launches_sink += sink is not None
    last_grid = grid
    return out, lse
