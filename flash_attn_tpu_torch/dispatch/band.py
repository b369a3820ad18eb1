"""The band masks: sliding window, chunked attention and sink tokens.

Port of flash_attn_tpu/dispatch/band.py ``kv_band_static`` (:28), the
host's mirror of the forward's key-tile bounds (flash_attn_tpu/kernels/
flash_fwd.py:360 ``_kv_block_bounds``), as plain Python, and beside it
:func:`q_band_static`, the mirror of the backward's query-tile bounds
(flash_attn_tpu/kernels/flash_bwd.py:157 ``_q_block_bounds``). ``PackedBand``
(:71) enumerates the in-band tile pairs as one flat grid axis for the
TPU's sequential grid; the CUDA kernels run a loop over the band inside
each block instead, and need no counterpart.

Beside it, the masks themselves in the JAX package's semantics, on torch
tensors, for the plain versions of the kernels that take a band
(:func:`band_valid`), and the arguments the C entry points take
(:func:`band_args`). With shift = sk - sq (bottom-right alignment), query
row r sees key c iff

 - c <= r + shift + right, where right = 0 under ``causal`` and the
   window's right extent otherwise (no bound when it is None);
 - c >= r + shift - left, or c < sink_token_length (no bound when the
   window's left extent is None; sinks count only under a left window);
 - with attention_chunk > 0: c >= lo, and c < lo + attention_chunk where
   the forward masks it (the decode kernel masks only the lower bound,
   flash_attn_tpu/kernels/flash_decode.py:209-214), for lo = (r + shift)
   rounded down to a multiple of attention_chunk (floor division, also for
   the negative r + shift of rows past sk when sq > sk).
"""

from typing import Optional, Tuple

import torch

# A missing window extent in the C entry points' arguments (the kernels
# read it as csrc/common.cuh's BAND_NONE).
NO_BOUND = -1


def kv_band_static(
    nq: int,
    nk: int,
    block_q: int,
    block_k: int,
    shift: int,
    causal: bool,
    window_left: Optional[int],
    window_right: Optional[int],
    sink_token_length: int,
    attention_chunk: int,
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(j_min, j_max) per q block as int tuples: the inclusive key-tile
    band of query tile i. Empty bands (fully masked rows, e.g. the top rows
    of a causal sq > sk) are clamped to the single tile [0, 0], which the
    mask then leaves fully masked (out 0, lse -inf)."""
    j_min_l, j_max_l = [], []
    for i in range(nq):
        j_max = nk - 1
        wr = 0 if causal else window_right
        if causal or wr is not None:
            col_hi = i * block_q + (block_q - 1) + shift + wr
            j_max = min(j_max, col_hi // block_k)
        j_min = 0
        if window_left is not None and sink_token_length == 0:
            col_lo = i * block_q + shift - window_left
            j_min = max(0, col_lo // block_k)
        if attention_chunk > 0 and sink_token_length == 0 \
                and window_left is None:
            rs = i * block_q + shift
            col_lo = rs - rs % attention_chunk
            j_min = max(0, col_lo // block_k)
        j_min = min(j_min, nk - 1)
        if j_max < j_min:
            j_min, j_max = 0, 0
        j_min_l.append(j_min)
        j_max_l.append(j_max)
    return tuple(j_min_l), tuple(j_max_l)


def q_band_static(
    nq: int,
    nk: int,
    block_q: int,
    block_k: int,
    shift: int,
    causal: bool,
    window_left: Optional[int],
    window_right: Optional[int],
    sink_token_length: int,
    attention_chunk: int,
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(i_min, i_max) per key block as int tuples: the inclusive query-tile
    band of key tile j, as the JAX backward's dK/dV grid bounds it (its
    ``iclamp`` then clips each to [0, nq - 1]); i_max < i_min where no row
    sees the tile. The chunk bounds i_max only without a left window and
    sinks, as JAX's does; the CUDA kernels' QueryRange (csrc/common.cuh) is
    tighter (the chunk's lower edge, and a key tile past the sinks), which
    skips only tiles that these bounds leave fully masked."""
    i_min_l, i_max_l = [], []
    wr = 0 if causal else window_right
    for j in range(nk):
        i_min = 0
        if causal or wr is not None:
            i_min = max(0, (j * block_k - shift - wr) // block_q)
        i_max = nq - 1
        if window_left is not None and sink_token_length == 0:
            row_hi = j * block_k + (block_k - 1) + window_left - shift
            i_max = min(i_max, row_hi // block_q)
        if attention_chunk > 0 and sink_token_length == 0 \
                and window_left is None:
            row_hi = j * block_k + (block_k - 1) + attention_chunk - shift
            i_max = min(i_max, row_hi // block_q)
        i_min_l.append(i_min)
        i_max_l.append(i_max)
    return tuple(i_min_l), tuple(i_max_l)


def band_valid(rows, cols, shift, causal: bool,
               window: Tuple[Optional[int], Optional[int]] = (None, None),
               sink_token_length: int = 0, attention_chunk: int = 0,
               chunk_upper: bool = True):
    """Bool tensor, True where query row ``rows`` sees key ``cols`` under
    the causal bound and the band (the module docstring's rules); the three
    broadcast together (``shift`` a tensor of per-sequence shifts, or an
    int). Key counts (c < sk) are the caller's to mask."""
    left, right = window
    rs = rows + shift
    valid = torch.ones(torch.broadcast_shapes(
        getattr(rs, "shape", ()), cols.shape), dtype=torch.bool,
        device=cols.device)
    wr = 0 if causal else right
    if wr is not None:
        valid = valid & (cols <= rs + wr)
    if left is not None:
        in_window = cols >= rs - left
        if sink_token_length > 0:
            in_window = in_window | (cols < sink_token_length)
        valid = valid & in_window
    if attention_chunk > 0:
        lo = rs - rs % attention_chunk  # torch's % floors, as jnp's does
        valid = valid & (cols >= lo)
        if chunk_upper:
            valid = valid & (cols < lo + attention_chunk)
    return valid


def has_band(causal: bool, window: Tuple[Optional[int], Optional[int]],
             attention_chunk: int = 0) -> bool:
    """Whether the band masks anything beyond the causal bound."""
    left, right = window
    return left is not None or (not causal and right is not None) \
        or attention_chunk > 0


def reach_window(window: Tuple[Optional[int], Optional[int]], causal: bool,
                 max_sq: int, max_sk: int):
    """The window with each extent that reaches every key dropped (None):
    a left extent of at least max_sk - 1, a right one (not causal) of at
    least max_sq - 1, where max_sq and max_sk bound the query rows and keys
    of every sequence. The masks are the same, and a call whose window
    reaches every key runs the band-free kernel."""
    left, right = window
    if left is not None and left >= max_sk - 1:
        left = None
    if causal or (right is not None and right >= max_sq - 1):
        right = None
    return left, right


def band_span(causal: bool, window: Tuple[Optional[int], Optional[int]],
              attention_chunk: int, sq: int) -> Optional[int]:
    """The keys the decode band of ``sq`` query tokens spans at most (None
    where it has no lower or no upper edge): the splits of a decode call
    share out only those (cache/kvcache.py picks the split count from
    them)."""
    left, right = window
    spans = [x for x in (left, attention_chunk or None) if x is not None]
    if not spans or not (causal or right is not None):
        return None
    return min(spans) + sq + (0 if causal else right)


def band_args(causal: bool, window: Tuple[Optional[int], Optional[int]],
              sink_token_length: int = 0, attention_chunk: int = 0):
    """(left, right, sink, chunk) ints for a C entry point: NO_BOUND for a
    missing extent, right folded to 0 under causal masking, the sinks 0
    without a left extent."""
    left, right = window
    return (NO_BOUND if left is None else int(left),
            0 if causal else (NO_BOUND if right is None else int(right)),
            int(sink_token_length) if left is not None else 0,
            int(attention_chunk))
