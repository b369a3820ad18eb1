"""Packed varlen attention forward on a persistent grid (B7): the CUDA
kernel ``fa_varlen_fwd_persistent`` of ``csrc/flash_varlen.cu`` and its
plain PyTorch version.

Port of flash_attn_tpu/kernels/flash_varlen_persistent.py
``flash_attention_varlen_fwd_persistent`` (:335): the same function as the
B6 forward (kernels/flash_varlen.py), computed by resident blocks that walk
a static work list. The TPU kernel gives one grid step per head a flat list
of (q tile, kv tile) items and streams K/V through a 4-deep DMA ring; here
the work list holds the (q tile, head) items of every sequence, its q tiles
ordered longest KV band first (a stable sort on the device,
dispatch/varlen_meta.py ``schedule``), and a grid of SM count x resident
blocks per SM walks the (q tile, head) items with a stride. Each item
runs the mma.sync tile loop of csrc/fwd_tile.cuh on 64-row tiles
(VARLEN_FWD_TILE); the B6 forward runs the wgmma/TMA tile of
csrc/fwd_sm90.cuh on 128-row tiles, so the two agree to rounding, not
bitwise. A tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from typing import Optional

import torch

from flash_attn_tpu_torch.dispatch.config import VARLEN_FWD_TILE
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd_plain
from flash_attn_tpu_torch.kernels.flash_varlen import (
    check_kernel_inputs,
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
    order, each 64-row tile (all heads at once) against the keys of its
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
        rows = min(VARLEN_FWD_TILE.block_q, lq - row0)
        # the band: with bottom-right causal masking, the tile's last row
        # sees keys up to row0 + rows - 1 + lk - lq
        keys = min(lk, max(row0 + rows + lk - lq, 0)) if causal else lk
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
    meta = varlen_meta(q, k, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                       max_seqlen_k, seqused_q, seqused_k, causal, meta)
    out, lse, grid = launch_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k, meta,
                                softmax_scale, causal, persistent=True)
    global launches, last_grid
    launches += 1
    last_grid = grid
    return out, lse
