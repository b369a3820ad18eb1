"""Varlen tile metadata for the Hopper kernels, computed on the device with
no host sync.

Port of flash_attn_tpu/dispatch/varlen_meta.py. The per-token vectors
(segment id, in-sequence position, the sequence's query and key lengths,
with the sentinel segments -1 and -2 for tokens in no sequence) are kept as
JAX computes them. The flat-axis tile bands are not: the TPU kernels tile
the packed token axis with aligned blocks and rebuild sequences from the
segment ids, while on Hopper each tile belongs to one sequence. The kernels
take work lists of per-sequence tile origins instead:

  - ``q_tiles``: (sequence, first local row) of every ``block_q``-row query
    tile (dQ);
  - ``k_tiles``: (sequence, first local key) of every ``block_k``-key tile;
  - ``k_schedule``: the same key tiles ordered by the query rows that see
    them, most first (the dK/dV kernel's work list);
  - ``schedule``: the query tiles of ``schedule_block_q`` rows (``block_q``
    unless given; the forwards' 128) ordered longest KV band (in
    ``schedule_block_k``-key tiles) first, the forward's and the dQ
    kernel's work list.

Each list is sized by a static bound (``num_tiles_bound``), with sequence -1
past the last live tile, so building it reads nothing back to the host. A
tile's key or query range inside its sequence follows from ``cu_seqlens``,
the lengths and the bottom-right causal shift, in the kernel. With a
window or a chunk (JAX's :101-196 bound the bands by them), the lists sort
by the band's true lengths: the key tiles a query tile's band holds (the
kernels' KeyRange), the query rows that see a key tile (QueryRange).
"""

from typing import NamedTuple, Optional, Tuple

import torch

Q_PAD_SEG = -1  # a query token in no sequence (rows -> fully masked)
K_PAD_SEG = -2  # a key token in no sequence (never equals a query segment)

__all__ = ["K_PAD_SEG", "Q_PAD_SEG", "VarlenMeta", "compute_varlen_meta",
           "num_tiles_bound", "sequence_lengths", "varlen_tiles"]


class VarlenMeta(NamedTuple):
    # per-token vectors, (total_q,) or (total_k,) int32
    seg_q: torch.Tensor
    pos_q: torch.Tensor
    seg_k: torch.Tensor
    pos_k: torch.Tensor
    sq_of_q: torch.Tensor  # query length of the token's sequence (0: none)
    sk_of_q: torch.Tensor  # key length of the token's sequence (0: none)
    # per-sequence lengths the kernels use, (b,) int32
    lens_q: torch.Tensor
    lens_k: torch.Tensor
    # work lists, (tiles, 2) int32 of (sequence or -1, first local row)
    q_tiles: torch.Tensor
    k_tiles: torch.Tensor
    schedule: torch.Tensor
    k_schedule: torch.Tensor


def sequence_lengths(cu_seqlens, seqused=None):
    """(b,) int32 rows of each sequence: ``seqused`` where given, cut to the
    ``cu_seqlens`` deltas (a sequence never reads past its own tokens)."""
    cu = cu_seqlens.to(torch.int32)
    lens = cu[1:] - cu[:-1]
    if seqused is not None:
        lens = torch.minimum(lens, seqused.to(lens.device, torch.int32))
    return lens


def num_tiles_bound(batch: int, max_seqlen: int, total: int, block: int) -> int:
    """Tiles of ``block`` rows that sequences of at most ``max_seqlen`` rows
    within ``total`` packed rows can need: the smaller of b x
    ceil(max_seqlen / block) and ceil(total / block) + b (at least 1)."""
    per_seq = batch * -(-max(int(max_seqlen), 0) // block)
    return max(1, min(per_seq, -(-int(total) // block) + batch))


def varlen_tiles(lengths, num_tiles: int, block: int):
    """The work list of tiles of ``block`` rows over sequences of
    ``lengths`` (b,) rows: (num_tiles, 2) int32 of (sequence, first local
    row), sequence -1 past the last tile. ``num_tiles`` must bound the
    tiles the lengths need. Built with torch ops on lengths' device."""
    b = lengths.numel()
    ntiles = (lengths.long() + block - 1) // block
    ends = torch.cumsum(ntiles, 0)
    tidx = torch.arange(num_tiles, device=lengths.device)
    seq = torch.searchsorted(ends, tidx, right=True).clamp(max=b - 1)
    first = (tidx - (ends[seq] - ntiles[seq])) * block
    seq = torch.where(tidx < ends[-1], seq, -1)
    return torch.stack([seq, first], 1).to(torch.int32).contiguous()


def _token_meta(cu, used_len, total: int, pad_seg: int):
    """seg / pos / used of every packed token (JAX ``_token_meta``)."""
    b = cu.numel() - 1
    idx = torch.arange(total, dtype=torch.int32, device=cu.device)
    seg = (torch.searchsorted(cu, idx, right=True) - 1).clamp(0, b - 1)
    pos = idx - cu[seg]
    used = (idx < cu[b]) & (pos < used_len[seg])
    return torch.where(used, seg, pad_seg).to(torch.int32), pos, used


def _chunk_lo(x, chunk: int):
    """x rounded down (floor) to a multiple of chunk."""
    return torch.div(x, chunk, rounding_mode="floor") * chunk


def _band_tiles(q_tiles, lens_q, lens_k, block_q: int, block_k: int,
                causal: bool, window=(None, None), chunk: int = 0):
    """KV tiles in each query tile's band (bottom-right causal, and the
    window and chunk when given), -1 for a dead tile."""
    seq = q_tiles[:, 0].long()
    row0 = q_tiles[:, 1].long()
    s = seq.clamp(min=0)
    lq, lk = lens_q.long()[s], lens_k.long()[s]
    left, right = window
    if left is not None or (not causal and right is not None) or chunk > 0:
        # csrc/common.cuh KeyRange: keys [c_lo, c_hi] of the tile's rows
        shift = lk - lq
        r_hi = torch.minimum(row0 + block_q, lq) - 1
        c_lo = torch.zeros_like(row0)
        c_hi = lk - 1
        right = 0 if causal else right
        if right is not None:
            c_hi = torch.minimum(c_hi, r_hi + shift + right)
        if left is not None:
            c_lo = torch.maximum(c_lo, row0 + shift - left)
        if chunk > 0:
            c_lo = torch.maximum(c_lo, _chunk_lo(row0 + shift, chunk))
            c_hi = torch.minimum(
                c_hi, _chunk_lo(r_hi + shift, chunk) + chunk - 1)
        band = torch.where(c_hi < c_lo, 0,
                           c_hi.clamp(min=0) // block_k - c_lo // block_k + 1)
        return torch.where(seq >= 0, band, -1)
    band = (lk + block_k - 1) // block_k
    if causal:
        col_hi = torch.minimum(row0 + block_q, lq) - 1 + lk - lq
        band = torch.where(col_hi < 0, 0,
                           torch.minimum(band, col_hi.clamp(min=0) // block_k + 1))
    return torch.where(seq >= 0, band, -1)


def _key_band(k_tiles, lens_q, lens_k, block_k: int, causal: bool,
              window=(None, None), chunk: int = 0):
    """Query rows that see each key tile's first key (bottom-right causal),
    or with a window or chunk the rows between the first and the last that
    see some key of the tile; -1 for a dead tile."""
    seq = k_tiles[:, 0].long()
    s = seq.clamp(min=0)
    lq, lk = lens_q.long()[s], lens_k.long()[s]
    left, right = window
    if left is not None or (not causal and right is not None) or chunk > 0:
        # csrc/common.cuh QueryRange: rows [r_lo, r_hi] of the tile's keys
        shift = lk - lq
        n0 = k_tiles[:, 1].long()
        c_hi = torch.minimum(n0 + block_k, lk) - 1
        r_lo = torch.zeros_like(n0)
        r_hi = lq - 1
        right = 0 if causal else right
        if right is not None:
            r_lo = torch.maximum(r_lo, n0 - shift - right)
        if left is not None:
            r_hi = torch.minimum(r_hi, c_hi - shift + left)
        if chunk > 0:
            r_lo = torch.maximum(r_lo, _chunk_lo(n0, chunk) - shift)
            r_hi = torch.minimum(
                r_hi, _chunk_lo(c_hi, chunk) + chunk - 1 - shift)
        return torch.where(seq >= 0, (r_hi - r_lo + 1).clamp(min=0), -1)
    rows = lq
    if causal:  # row r sees key n0 when n0 <= r + lk - lq
        rows = (lq - (k_tiles[:, 1].long() - (lk - lq)).clamp(min=0)).clamp(min=0)
    return torch.where(seq >= 0, rows, -1)


def compute_varlen_meta(
    cu_seqlens_q,  # (b+1,) int32
    cu_seqlens_k,  # (b+1,) int32
    max_seqlen_q: int,
    max_seqlen_k: int,
    total_q: int,
    total_k: int,
    *,
    causal: bool,
    seqused_q=None,  # (b,) int32, overrides the cu deltas
    seqused_k=None,
    block_q: int = 64,
    block_k: int = 64,
    schedule_block_q: Optional[int] = None,
    schedule_block_k: Optional[int] = None,
    device: Optional[torch.device] = None,
    window_size: Tuple[Optional[int], Optional[int]] = (None, None),
    attention_chunk: int = 0,
) -> VarlenMeta:
    """The per-token vectors and the work lists of packed sequences, on
    ``device`` (cu_seqlens_q's by default). ``max_seqlen_q/k`` must bound
    the sequences' lengths: they size the work lists. The schedule's tiles
    have ``schedule_block_q`` rows (``block_q`` when None); its bands count
    ``schedule_block_k``-key tiles (``block_k`` when None). ``window_size``
    (left, right; None for no bound) and ``attention_chunk`` order the
    lists by the band's lengths; the lists hold the same tiles either
    way."""
    device = device or cu_seqlens_q.device
    cu_q = cu_seqlens_q.to(device, torch.int32)
    cu_k = cu_seqlens_k.to(device, torch.int32)
    b = cu_q.numel() - 1
    len_q, len_k = cu_q[1:] - cu_q[:-1], cu_k[1:] - cu_k[:-1]
    used_q = len_q if seqused_q is None else seqused_q.to(device, torch.int32)
    used_k = len_k if seqused_k is None else seqused_k.to(device, torch.int32)

    seg_q, pos_q, q_used = _token_meta(cu_q, used_q, total_q, Q_PAD_SEG)
    seg_k, pos_k, _ = _token_meta(cu_k, used_k, total_k, K_PAD_SEG)
    seg_c = seg_q.long().clamp(0, b - 1)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    sq_of_q = torch.where(q_used, used_q[seg_c], zero)
    sk_of_q = torch.where(q_used, used_k[seg_c], zero)

    lens_q = sequence_lengths(cu_q, used_q)
    lens_k = sequence_lengths(cu_k, used_k)
    q_tiles = varlen_tiles(
        lens_q, num_tiles_bound(b, max_seqlen_q, total_q, block_q), block_q)
    k_tiles = varlen_tiles(
        lens_k, num_tiles_bound(b, max_seqlen_k, total_k, block_k), block_k)
    bq_s = schedule_block_q or block_q
    s_tiles = q_tiles if bq_s == block_q else varlen_tiles(
        lens_q, num_tiles_bound(b, max_seqlen_q, total_q, bq_s), bq_s)
    band = _band_tiles(s_tiles, lens_q, lens_k, bq_s,
                       schedule_block_k or block_k, causal, window_size,
                       attention_chunk)
    order = torch.sort(band, descending=True, stable=True).indices
    k_order = torch.sort(_key_band(k_tiles, lens_q, lens_k, block_k, causal,
                                   window_size, attention_chunk),
                         descending=True, stable=True).indices
    return VarlenMeta(
        seg_q=seg_q, pos_q=pos_q.to(torch.int32), seg_k=seg_k,
        pos_k=pos_k.to(torch.int32), sq_of_q=sq_of_q.to(torch.int32),
        sk_of_q=sk_of_q.to(torch.int32), lens_q=lens_q, lens_k=lens_k,
        q_tiles=q_tiles, k_tiles=k_tiles,
        schedule=s_tiles[order].contiguous(),
        k_schedule=k_tiles[k_order].contiguous())
