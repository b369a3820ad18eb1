"""Public scheduler-metadata API (port of
flash_attn_tpu/dispatch/scheduler_metadata.py): the varlen work lists
computed once and reused by ``flash_attn_varlen_func(...,
scheduler_metadata=)`` across calls with the same lengths, as the BERT
encoder does across its layers."""

from typing import NamedTuple, Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.config import (
    FWD_TILE,
    VARLEN_BWD_TILE,
    normalize_window,
)
from flash_attn_tpu_torch.dispatch.varlen_meta import (
    VarlenMeta,
    compute_varlen_meta,
    num_tiles_bound,
)
from flash_attn_tpu_torch.utils.device import resolve_device

__all__ = ["SchedulerMetadata", "get_scheduler_metadata"]


class SchedulerMetadata(NamedTuple):
    meta: VarlenMeta
    block_q: int
    block_k: int
    num_q_tiles: int
    num_k_tiles: int


def get_scheduler_metadata(
    batch_size: int,
    max_seqlen_q: int,
    max_seqlen_k: int,
    num_heads: int,
    num_heads_kv: int,
    headdim: int,
    cu_seqlens_q=None,
    cu_seqlens_k=None,
    seqused_q=None,
    seqused_k=None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    headdim_v: Optional[int] = None,
    device=None,
) -> SchedulerMetadata:
    """The work lists of ``batch_size`` sequences packed by cu_seqlens_q/k
    (by default every sequence at its max_seqlen), on cu_seqlens_q's
    device; without cu_seqlens_q, on ``device``, which is the CUDA card
    when None (raising without one, as the entry points do). As in JAX,
    the packed layouts are taken to hold batch_size x max_seqlen rows
    (unpad_input's). ``window_size`` (left, right; -1 or None for no bound)
    orders the work lists by the window's bands, as JAX bounds its bands by
    it; the lists serve a call with any band (the kernels bound each tile's
    band themselves). ``headdim_v != headdim`` raises NotImplementedError
    (ROADMAP.md queue A, item 7)."""
    window = normalize_window(tuple(window_size))
    if (headdim_v or headdim) != headdim:
        raise NotImplementedError(
            "get_scheduler_metadata: headdim_v != headdim is not ported yet "
            "(ROADMAP.md queue A, item 7)")
    if cu_seqlens_q is None:
        cu_seqlens_q = torch.arange(batch_size + 1, dtype=torch.int32,
                                    device=resolve_device(device)) \
            * max_seqlen_q
    if cu_seqlens_k is None:
        cu_seqlens_k = torch.arange(batch_size + 1, dtype=torch.int32,
                                    device=cu_seqlens_q.device) * max_seqlen_k
    total_q, total_k = batch_size * max_seqlen_q, batch_size * max_seqlen_k
    bq, bk = FWD_TILE.block_q, FWD_TILE.block_k
    meta = compute_varlen_meta(
        cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k, total_q,
        total_k, causal=causal, seqused_q=seqused_q, seqused_k=seqused_k,
        block_q=VARLEN_BWD_TILE.block_q, block_k=VARLEN_BWD_TILE.block_k,
        schedule_block_q=bq, schedule_block_k=bk, window_size=window)
    return SchedulerMetadata(
        meta=meta, block_q=bq, block_k=bk,
        num_q_tiles=num_tiles_bound(batch_size, max_seqlen_q, total_q, bq),
        num_k_tiles=num_tiles_bound(batch_size, max_seqlen_k, total_k,
                                    VARLEN_BWD_TILE.block_k))
