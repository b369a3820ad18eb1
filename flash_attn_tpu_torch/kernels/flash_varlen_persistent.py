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
epilogue. A tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from typing import Optional

import torch

from flash_attn_tpu_torch.dispatch.config import FWD_TILE
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd_plain
from flash_attn_tpu_torch.kernels.flash_varlen import (
    check_kernel_inputs,
    check_meta,
    launch_fwd,
    varlen_meta,
)

launches = 0  # kernel launches since the last reset (plain calls not counted)
last_grid = 0  # blocks of the last launch's grid


def flash_attention_varlen_fwd_persistent_plain(
        q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q: int,
        max_seqlen_k: int, seqused_q=None, seqused_k=None,
        softmax_scale: Optional[float] = None, causal: bool = False,
        meta=None):
    """The kernel's walk in fp32: the items of the persistent schedule in
    order, each 128-row tile (all heads at once) against the keys of its
    causal band through the dense plain forward. Returns out (total_q, h,
    dv) in q's type and lse (h, total_q) fp32, as the B6 forward does."""
    meta = varlen_meta(q, k, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                       max_seqlen_k, seqused_q, seqused_k, causal, meta)
    total_q, h, _ = q.shape
    out = q.new_zeros((total_q, h, v.shape[-1]))
    lse = torch.full((h, total_q), float("-inf"), device=q.device)
    cu_q, cu_k = cu_seqlens_q.tolist(), cu_seqlens_k.tolist()
    lens_q, lens_k = meta.lens_q.tolist(), meta.lens_k.tolist()
    for seq, row0 in meta.schedule.tolist():
        if seq < 0:
            break  # dead tiles sort last
        lq, lk = lens_q[seq], lens_k[seq]
        rows = min(FWD_TILE.block_q, lq - row0)
        # the band: with bottom-right causal masking, the tile's last row
        # sees keys up to row0 + rows - 1 + lk - lq
        keys = min(lk, max(row0 + rows + lk - lq, 0)) if causal else lk
        if keys == 0:
            continue  # rows that see no key keep zeros and -inf
        q0, k0 = cu_q[seq] + row0, cu_k[seq]
        o, l = flash_attention_fwd_plain(
            q[q0:q0 + rows].transpose(0, 1)[None],
            k[k0:k0 + keys].transpose(0, 1)[None],
            v[k0:k0 + keys].transpose(0, 1)[None], softmax_scale, causal)
        out[q0:q0 + rows] = o[0].transpose(0, 1)
        lse[:, q0:q0 + rows] = l[0]
    return out, lse


def flash_attention_varlen_fwd_persistent(
        q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q: int,
        max_seqlen_k: int, seqused_q=None, seqused_k=None,
        softmax_scale: Optional[float] = None, causal: bool = False,
        meta=None):
    """Arguments and results as kernels/flash_varlen.py
    ``flash_attention_varlen_fwd``. CUDA: a grid of SM count x resident
    blocks per SM walking the sorted (q tile, head) items with a stride."""
    if q.device.type == "cpu":
        return flash_attention_varlen_fwd_persistent_plain(
            q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
            seqused_q, seqused_k, softmax_scale, causal, meta)
    check_kernel_inputs("flash_varlen_fwd_persistent", q, k, v, cu_seqlens_q,
                        cu_seqlens_k)
    if meta is not None:
        check_meta("flash_varlen_fwd_persistent", meta, cu_seqlens_q,
                   cu_seqlens_k, max_seqlen_q, max_seqlen_k, q.shape[0],
                   k.shape[0], backward=False)
    global launches, last_grid
    if q.shape[0] == 0 or k.shape[0] == 0:  # no row sees a key
        last_grid = 0
        return (torch.zeros_like(q), torch.full(
            (q.shape[1], q.shape[0]), float("-inf"), device=q.device))
    meta = varlen_meta(q, k, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                       max_seqlen_k, seqused_q, seqused_k, causal, meta)
    out, lse, grid = launch_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k, meta,
                                softmax_scale, causal, persistent=True)
    launches += 1
    last_grid = grid
    return out, lse
