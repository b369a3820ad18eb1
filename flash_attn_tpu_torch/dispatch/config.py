"""Kernel-config resolution for the H100 kernels (tile sizes, split
heuristic).

Port of flash_attn_tpu/dispatch/config.py: ``normalize_window`` and
``num_splits_heuristic`` are carried over as they are; the tile choices
are new, because the Hopper kernels tile for shared memory and registers,
not for VMEM (the TPU's VMEM budgeting helpers have no counterpart here).
"""

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

# Head dims the two CUDA kernels are compiled for.
KERNEL_HEAD_DIMS = (64, 128)


@dataclasses.dataclass(frozen=True)
class FwdConfig:
    block_q: int
    block_k: int


# Tile of csrc/flash_fwd.cu: 64 query rows (16 per warp of 4, the
# m16n8k16 tensor-core tile) by 64 keys. At head dim 128 the Q, K and V
# tiles take 48 KB of shared memory, room for two blocks on one SM. The
# kernel checks that the wrapper passes the tile it was compiled for.
FWD_TILE = FwdConfig(block_q=64, block_k=64)

@dataclasses.dataclass(frozen=True)
class BwdConfig:
    block_q: int  # query rows of a tile
    block_k: int  # KV rows of a tile


def get_bwd_config(head_dim: int) -> Tuple[BwdConfig, BwdConfig]:
    """Tiles of csrc/bwd_tile.cuh, the mma.sync backward loops of the
    packed-varlen (csrc/flash_varlen.cu) and block-sparse
    (csrc/flash_blocksparse.cu) backward: (the dK/dV loop's, the dQ loop's).

    Both loops run 4 warps of 16 rows (the m16n8k16 tile), so a dK/dV
    block owns 64 KV rows and a dQ block 64 query rows. A dK/dV warp keeps
    its rows' dK and dV in registers (128 fp32 a thread at head dim 128)
    beside the S^T and dP^T tiles of the q tile, so the q tile is what
    keeps the kernel within 255 registers without spilling: 64 rows at
    head dim 64, 32 at 128 (csrc/bwd_tile.cuh FA_BWD_BM_D128). The kernels
    check that the wrapper passes the tiles they were compiled for."""
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_bwd: head dim {head_dim} not in "
                         f"{KERNEL_HEAD_DIMS}")
    dkdv = BwdConfig(block_q=32 if head_dim == 128 else 64, block_k=64)
    return dkdv, BwdConfig(block_q=64, block_k=64)


# Tiles of csrc/flash_bwd.cu, the dense backward on wgmma and TMA, at both
# head dims: (the dK/dV kernel's, the dQ kernel's). A block runs two
# warpgroups of 64 rows (wgmma's M): the dK/dV kernel owns 128 KV rows and
# streams q tiles of 64 rows, the dQ kernel owns 128 query rows and streams
# key tiles of 64. At head dim 128 a thread keeps 64 + 64 fp32 dK/dV
# accumulators beside the 32 + 32 of S^T and dP^T, within the 255
# registers a 256-thread block allows. The kernels check that the wrapper
# passes these tiles.
DENSE_BWD_TILES = (BwdConfig(block_q=64, block_k=128),
                   BwdConfig(block_q=128, block_k=64))

# Rows of the preprocess kernel's lse and delta buffers are padded to a
# multiple of this (the larger q extent of the two dense backward tiles),
# so every tile's bulk copy of them is whole and 16-byte aligned.
DENSE_BWD_ROW_PAD = 128


# Split granularity of csrc/flash_decode.cu and of its plain version: a
# split's share of the cache is a run of 64-key tiles (one pass of the
# kernel's 4 warps' unrolled loads at head dim 128).
#
# The paged cache keeps this tile whatever the page size. The TPU kernel
# sizes its KV tile from the page (flash_decode.py:484-489: pages_per_tile
# pages of a ~512-row target, so that each DMA moves a whole page), because
# a TPU tile is one DMA'd slab. The CUDA kernel resolves every key position
# through the block table inside its 16-byte loads, so a tile may start and
# end inside a page: page 16, 64 or 256 all split on 64-key tiles, and
# paged decode sums in the same order as linear decode.
DECODE_BLOCK_K = 64

# Query rows a block of the d = dv decode route holds (csrc/flash_decode.cu:
# up to 8, grid.z covers the rest): the split heuristic's row block there.
DECODE_ROWS_PER_BLOCK = 8

# Tile of csrc/mla_tile.cuh, the loop of the MLA decode route and of the
# paged chunked prefill (B8p): 64 packed (position, head) rows, heads
# fastest, by 64 keys. The TPU kernels pad d and dv to 128 lanes and size
# the KV tile from the page (~512 rows); here 8 warps hold a 64 x 512 fp32
# output in registers (a warp pair per 16 rows, each warp half the value
# columns), and the Q tile plus two 64-key tiles at 576 columns take 216 KB
# of shared memory. The split heuristic counts blocks of this tile.
MLA_TILE = FwdConfig(block_q=64, block_k=64)

# The (d, dv, qv given) forms each MLA kernel is compiled for (the form
# list passed to mla_dispatch in its .cu). The decode route takes
# DeepSeek's absorbed form (a 64-wide rope key, qv against the 512-wide
# latent), the same latent cache stored as K 576 wide with V its first 512
# columns (no qv), and two narrow qv forms: flash_attn_with_kvcache reaches
# all four. B8p is reached only through flash_attn_varlen_func(qv=), so it
# takes the three qv forms. Other forms raise on the card (ROADMAP.md queue
# A, item 7).
MLA_DECODE_DIMS = ((64, 512, True), (576, 512, False), (64, 128, True),
                   (128, 128, True))
PAGED_PREFILL_DIMS = ((64, 512, True), (64, 128, True), (128, 128, True))


def default_scale(d: int, dv: int, has_qv: bool) -> float:
    """The softmax scale when none is given: 1/sqrt(d), or 1/sqrt(d + dv)
    with qv (the score depth of DeepSeek's absorbed MLA)."""
    return 1.0 / math.sqrt(d + dv if has_qv else d)


def is_mla_form(d: int, dv: int, has_qv: bool) -> bool:
    """Whether a decode call takes the MLA route (a qv, or dv != d) rather
    than the d = dv route of csrc/flash_decode.cu."""
    return has_qv or d != dv


def decode_rows_per_block(d: int, dv: int, has_qv: bool) -> int:
    """Query rows one decode block holds, for the split heuristic."""
    return MLA_TILE.block_q if is_mla_form(d, dv, has_qv) \
        else DECODE_ROWS_PER_BLOCK

# Tile of csrc/flash_varlen_paged.cu (the packed-varlen prefill over the
# paged cache): 64 query rows of one sequence by 64 keys, the tile of the
# dense forward kernel whose loop it reuses. The JAX function picks
# bq = min(512, next_pow2(max(max_seqlen_q, 128))) and bk = page_size *
# min(8, 1024 // page_size) (flash_varlen_paged.py:369-376) to fill its
# 128 x 128 matrix unit with tall tiles from a large VMEM and to move whole
# pages per DMA. On the H100 a block of 4 warps holds 64 rows in mma.sync
# fragments within the register budget, and small tiles give the 132 SMs
# enough blocks: an admission of 8 chunks of 256 rows at 16 heads is 512
# blocks. The K/V tile does not follow the page either: its rows load one
# by one through the table, so any page size fits a 64-key tile.
VARLEN_PAGED_TILE = FwdConfig(block_q=64, block_k=64)


# Tiles of csrc/flash_varlen.cu. Its forwards (B6 and the persistent B7) run
# the dense forward's tile loop (csrc/fwd_tile.cuh), so they take its 64 x 64
# tile; its backward runs the dense backward's loops with the tiles of
# get_bwd_config. The JAX kernels tile the flat token axis with blocks of up
# to 512 rows (get_fwd_config) so that each DMA is large and aligned; here a
# tile is 64 rows of one sequence, which keeps the ragged edge of each
# sequence to one partial tile.
VARLEN_FWD_TILE = FWD_TILE


@functools.lru_cache(maxsize=None)
def num_sms(device_index: int) -> int:
    """Streaming multiprocessors of CUDA card ``device_index``, read once:
    the persistent varlen forward's grid is this many times the blocks that
    fit on one SM (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def normalize_window(
    window_size: Tuple[Optional[int], Optional[int]],
) -> Tuple[Optional[int], Optional[int]]:
    """Accept both the FA2 (-1 = unlimited) and FA4 (None = unlimited)
    window conventions."""
    left, right = window_size
    if left is not None and left < 0:
        left = None
    if right is not None and right < 0:
        right = None
    return (left, right)


def num_splits_heuristic(
    total_mblocks: int,
    num_cores: int,
    num_kv_blocks: int,
    max_splits: int = 8,
) -> int:
    """How many KV splits for decode so that every core has work; on the
    H100 a core is a streaming multiprocessor (132 of them)."""
    if total_mblocks >= 0.8 * num_cores:
        return 1
    max_useful = max(1, min(max_splits, num_kv_blocks, num_cores))
    best, best_eff = 1, 0.0
    for s in range(1, max_useful + 1):
        n_waves = (total_mblocks * s) / num_cores
        eff = n_waves / float(int(n_waves) + 1) if n_waves < 1 else 1.0
        if eff > best_eff * 1.05:
            best, best_eff = s, eff
    return best
