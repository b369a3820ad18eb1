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
import struct
from typing import Optional, Tuple

import torch

# Head dims (q, k and v alike) the attention kernels are compiled for, in
# serving and in training alike: the dense forward B1 (csrc/flash_fwd.cu),
# the paged varlen prefill B8 (csrc/flash_varlen_paged.cu) and the
# packed-varlen forwards B6 and B7 (csrc/flash_varlen_fwd.cu), all on the
# forward tile of fwd_sm90.cuh; the d = dv decode route B4
# (csrc/flash_decode.cu, linear and paged); and the backwards B2, B3
# (csrc/flash_bwd.cu) and B6 (csrc/flash_varlen.cu) with their preprocess,
# on the tiles of bwd_sm90.cuh. 80 (BTLM-3B-8K), 96 (GPT-NeoX-20B) and 256
# (GPT-J) run there in whole 64-column panels (80 and 96 as 128 with TMA's
# zero fill past the tensor's columns, 80 in sources of its own, the
# *_80.cu files; the backward at 256 on blocks of 64 rows whose warpgroups
# split the columns).
HEAD_DIMS = (64, 80, 96, 128, 256)

# (q/k, v) head-dim pairs with a value head dim of its own: 192 / 128, the
# attention of DeepSeek's MLA when it is not absorbed (128 "nope" + 64 rope
# columns of q and k, 128 of v), and so ``flash_attn_func(qv=)`` at (64,
# 128) through JAX's concatenation. Only the dense forward B1, the dense
# backwards B2 and B3 and their preprocess are compiled for it
# (csrc/flash_fwd_192.cu, csrc/flash_bwd_192.cu, band-free and without the
# score map), so they take DENSE_HEAD_DIMS; every other kernel takes
# HEAD_DIMS alone (the packed and paged routes at 192 / 128 are ROADMAP.md
# queue A, item 7).
HEAD_DIM_PAIRS = ((192, 128),)
DENSE_HEAD_DIMS = HEAD_DIMS + HEAD_DIM_PAIRS

# Head dims of the block-sparse kernels B10 (csrc/flash_blocksparse.cu).
# The rest (and d != dv, and every head dim of the MLA route but its
# compiled forms, MLA_DECODE_DIMS) is ROADMAP.md queue A, item 7.
BLOCKSPARSE_HEAD_DIMS = (64, 128)


def _fp32(x: float) -> float:
    return struct.unpack("f", struct.pack("f", x))[0]


def scale_log2(scale: float) -> float:
    """softmax_scale * log2(e) as the kernels' C entry points form it
    (csrc/common.cuh FA_LOG2E: the fp32 product of the fp32 scale and the
    fp32 log2(e)), for the wrappers that pass it formed (B1, B8), so that
    every kernel on the forward tile of fwd_sm90.cuh maps the same scores
    to the same base-2 scores as B6, B7 and the backwards (1/sqrt(80) times
    log2(e) in double precision rounds to another fp32 value)."""
    return _fp32(_fp32(scale) * _fp32(math.log2(math.e)))


def check_head_dims(kernel: str, d: int, dk: int, dv: int, dims) -> None:
    """Raise ValueError unless q and k share a head dim and (d, v's) is in
    ``dims``, the set ``kernel`` is compiled for: a head dim there is one
    that q, k and v share, a (d, dv) pair one with a v head dim of its own
    (HEAD_DIM_PAIRS)."""
    if dk != d or not ((dv == d and d in dims) or (d, dv) in dims):
        raise ValueError(
            f"{kernel} kernel: head dims q {d}, k {dk}, v {dv}; it takes "
            f"{dims} (an int: q, k and v alike; a pair: q/k and v) and no "
            f"other (ROADMAP.md queue A, item 7)")


def refuse_dv_forms(kernel: str, d: int, dv: int, band: bool,
                    score: bool) -> None:
    """Raise NotImplementedError for the band or the score map at a v head
    dim of its own: the kernels at HEAD_DIM_PAIRS compile neither (each is
    a template flag that would double their instantiations)."""
    if dv == d or not (band or score):
        return
    form = ("the band (window, chunk, sink tokens)" if band
            else "the score map (softcap, ALiBi)")
    raise NotImplementedError(
        f"{kernel} kernel: {form} at head dims {d} / {dv} is not ported yet "
        f"(ROADMAP.md queue A, item 7)")


@dataclasses.dataclass(frozen=True)
class FwdConfig:
    block_q: int
    block_k: int


# Tile of csrc/fwd_sm90.cuh, the wgmma/TMA forward tile of the dense
# forward (csrc/flash_fwd.cu, B1), the packed-varlen forwards
# (csrc/flash_varlen_fwd.cu: B6 and the persistent B7) and the paged varlen
# prefill (csrc/flash_varlen_paged.cu, B8): 128 query rows (two
# warpgroups of 64, wgmma's M) by 64 keys. At head dim 128 the Q tile and two
# stages of K + V take 97 KB of shared memory, and a thread keeps 64 fp32
# accumulators of O beside the 32 of S within 128 registers, so two blocks
# share an SM. get_scheduler_metadata builds its forward work list (the
# schedule) for this tile, and B8's wrapper counts each sequence's tiles of
# it (kernels/flash_varlen_paged.py tile_ends). The JAX B8 picks bq =
# min(512, next_pow2(max(max_seqlen_q, 128))) and a key tile of whole pages
# (flash_varlen_paged.py:369-376) to move whole pages per DMA; here a 64-key
# tile is boxes of gcd(page_size, 64) rows, so any page size fits it. The
# kernels check that the wrapper passes the tile they were compiled for.
FWD_TILE = FwdConfig(block_q=128, block_k=64)


@dataclasses.dataclass(frozen=True)
class BwdConfig:
    block_q: int  # query rows of a tile
    block_k: int  # KV rows of a tile


# Tiles of csrc/bwd_sm90.cuh, the backward on wgmma and TMA of the dense
# backward (csrc/flash_bwd.cu) and of the packed-varlen one
# (csrc/flash_varlen.cu, VARLEN_BWD_TILE), up to head dim 128: (the dK/dV
# kernel's, the dQ kernel's). A block runs two
# warpgroups of 64 rows (wgmma's M): the dK/dV kernel owns 128 KV rows and
# streams q tiles of 64 rows, the dQ kernel owns 128 query rows and streams
# key tiles of 64. At head dim 128 a thread keeps 64 + 64 fp32 dK/dV
# accumulators beside the 32 + 32 of S^T and dP^T, within the 255
# registers a 256-thread block allows. The kernels check that the wrapper
# passes these tiles (dense_bwd_tiles).
DENSE_BWD_TILES = (BwdConfig(block_q=64, block_k=128),
                   BwdConfig(block_q=128, block_k=64))

# The same at head dim 256: a block owns 64 rows (KV rows of dK/dV, q rows
# of dQ), both warpgroups on them, each keeping 128 of the 256 columns of
# dK and dV (or dQ) in 64 + 64 registers; 128-row blocks would need 256
# accumulator registers a thread and more shared memory than a block has.
DENSE_BWD_TILES_256 = (BwdConfig(block_q=64, block_k=64),
                       BwdConfig(block_q=64, block_k=64))


# The same at q/k head dim 192 beside v head dim 128: the dK/dV block owns
# 64 KV rows (warpgroup 0 keeps dK's 192 columns, warpgroup 1 dV's 128),
# the dQ block 128 query rows (a warpgroup's 64 over all 192 columns).
DENSE_BWD_TILES_192_128 = (BwdConfig(block_q=64, block_k=64),
                           BwdConfig(block_q=128, block_k=64))


def dense_bwd_tiles(d: int, dv: Optional[int] = None) -> Tuple[BwdConfig,
                                                             BwdConfig]:
    """The dense backward's (dK/dV, dQ) tiles at q/k head dim ``d`` and v
    head dim ``dv`` (d's unless given)."""
    if dv is not None and dv != d:
        return DENSE_BWD_TILES_192_128
    return DENSE_BWD_TILES_256 if d > 128 else DENSE_BWD_TILES

# Rows of the preprocess kernel's lse and delta buffers are padded to a
# multiple of this (the larger q extent of the two dense backward tiles),
# so every tile's bulk copy of them is whole and 16-byte aligned.
DENSE_BWD_ROW_PAD = 128


# Split granularity of csrc/flash_decode.cu and of its plain version: a
# split's share of the cache is a run of 64-key tiles, which the kernel
# stages in its shared-memory ring whole or in quarters (TMA copies of K and
# V in boxes of gcd(page_size, staged tile) rows).
#
# The paged cache keeps this tile whatever the page size. The TPU kernel
# sizes its KV tile from the page (flash_decode.py:484-489: pages_per_tile
# pages of a ~512-row target, so that each DMA moves a whole page), because
# a TPU tile is one DMA'd slab. The CUDA kernel resolves each box's page
# through the block table, so a tile may start and end inside a page: page
# 16, 64 or 256 all split on 64-key tiles, and paged decode sums in the
# same order as linear decode.
DECODE_BLOCK_K = 64

# Query rows a block of the d = dv decode route holds (csrc/flash_decode.cu:
# up to 8, grid.z covers the rest): the split heuristic's row block there.
DECODE_ROWS_PER_BLOCK = 8

# Blocks of the d = dv decode route's deep ring (csrc/flash_decode.cu: 3
# stages of 64 keys, 97 KB of shared memory at head dim 128, 96 staged as
# 128; 2 stages of 32 keys at 256) an SM holds.
DECODE_BLOCKS_PER_SM = 2


def decode_cluster(blocks: int, sms: int) -> int:
    """Blocks of a thread-block cluster that share one split of the d = dv
    decode route (csrc/flash_decode.cu): the most of 1, 2 and 4 whose grid
    of ``blocks`` x that many still fits the card's resident blocks of the
    deep ring, so that the longest rows spread over idle SMs at small
    batch, and a full grid runs one block a split (on the shallow ring)."""
    cluster = 1
    while cluster < 4 and blocks * cluster * 2 <= sms * DECODE_BLOCKS_PER_SM:
        cluster *= 2
    return cluster


# Tile of csrc/mla_sm90.cuh, which the MLA decode route and the paged
# chunked prefill (B8p) both run on wgmma and TMA: 64 packed (position,
# head) rows, heads fastest (gcd(group, 64) heads of 64 / that many
# positions), by 64 keys. The TPU kernels pad d and dv to 128 lanes and size
# the KV tile from the page (~512 rows); here two warpgroups hold a 64 x 512
# fp32 output in registers (each half the value columns), and the Q tile
# plus two 64-key stages at 576 columns take 218 KB of shared memory. The
# split heuristic counts blocks of this tile.
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


# The backward work lists of packed varlen attention (csrc/flash_varlen.cu,
# B6 on the wgmma/TMA tiles of csrc/bwd_sm90.cuh that the dense backward B3
# runs, DENSE_BWD_TILES): its dK/dV kernel owns 128-key tiles (k_tiles,
# walked in k_schedule's order) and streams 64-row q tiles, its dQ kernel
# owns 128-row q tiles (q_tiles; walked in the order of the forward's
# schedule, whose tiles are FWD_TILE's 128 rows too) and streams 64-key
# tiles, whatever the head dim (at 256 the kernels run a list tile as two
# blocks of 64 rows, DENSE_BWD_TILES_256). compute_varlen_meta builds them
# beside the forward's schedule, so that one VarlenMeta serves
# flash_attn_varlen_func's forward and backward; the preprocess kernel pads lse and delta per
# sequence to whole 128-row tiles of q_tiles. The kernels check that the
# wrapper passes these tiles.
VARLEN_BWD_TILE = FwdConfig(block_q=128, block_k=128)


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
