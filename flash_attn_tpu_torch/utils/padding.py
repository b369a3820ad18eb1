"""Padded <-> packed (varlen) conversion (port of
flash_attn_tpu/utils/padding.py).

As in JAX, shapes stay static: the packed tensor has b * s rows, the kept
tokens front-packed and a zero tail, and ``max_seqlen`` is s. So nothing is
read back to the host (no ``nonzero``), and the varlen kernels see the tail
as rows in no sequence (past ``cu_seqlens[-1]``), which they leave at zero.
Every function is differentiable in its tensor input.
"""

from typing import Optional

import torch

__all__ = ["index_first_axis", "pad_input", "unpad_input",
           "unpad_input_for_concatenated_sequences"]


def _front_pack(hidden_states, keep):
    """(packed, indices): the rows of hidden_states (b, s, ...) where keep
    (b, s) is True, front-packed in order by a stable sort, the tail
    zeroed."""
    b, s = keep.shape[:2]
    flat_keep = keep.reshape(-1)
    indices = torch.argsort((~flat_keep).to(torch.int8), stable=True)
    flat = hidden_states.reshape((b * s,) + hidden_states.shape[2:])
    packed = flat[indices]
    valid = torch.arange(b * s, device=keep.device) < flat_keep.sum()
    packed = torch.where(valid.reshape((-1,) + (1,) * (packed.dim() - 1)),
                         packed, torch.zeros((), dtype=packed.dtype,
                                             device=packed.device))
    return packed, indices


def _cu_seqlens(seqlens):
    return torch.nn.functional.pad(torch.cumsum(seqlens, 0), (1, 0)).to(
        torch.int32)


def unpad_input(hidden_states, attention_mask, unused_mask=None):
    """hidden_states (b, s, ...), attention_mask (b, s) bool (True = keep),
    unused_mask (b, s) bool (True = allocated but unused, counted in
    cu_seqlens and not in seqused). Returns (packed (b*s, ...), indices
    (b*s,) int64, cu_seqlens (b+1,) int32, max_seqlen = s, seqused (b,)
    int32)."""
    b, s = attention_mask.shape[:2]
    all_mask = (attention_mask if unused_mask is None
                else attention_mask | unused_mask)
    seqlens = all_mask.sum(-1, dtype=torch.int32)
    seqused = attention_mask.sum(-1, dtype=torch.int32)
    packed, indices = _front_pack(hidden_states, all_mask)
    return packed, indices, _cu_seqlens(seqlens), int(s), seqused


def pad_input(packed, indices, batch: int, seqlen: int):
    """Inverse of :func:`unpad_input`: scatter the packed rows (b*s, ...)
    back to (batch, seqlen, ...) through ``indices``."""
    flat = packed.new_zeros((batch * seqlen,) + packed.shape[1:])
    n = packed.shape[0]
    flat = flat.index_copy(0, indices[:n], packed)
    return flat.reshape((batch, seqlen) + packed.shape[1:])


def unpad_input_for_concatenated_sequences(
    hidden_states,             # (b, s, ...)
    attention_mask_in_length,  # (b, s) int: the lengths of the samples
                               # concatenated into each row, then zeros
    max_segments: Optional[int] = None,
):
    """Pack rows that each hold several samples back to back, with one
    cu_seqlens entry per sample. Returns (packed (b*s, ...), indices,
    cu_seqlens, max_seqlen). With ``max_segments=None`` the lengths are
    read on the host (as JAX does, and the reference's ``nonzero``), and
    max_seqlen is the longest sample; with a bound, cu_seqlens is
    (max_segments + 1,), padded with repeated totals, and max_seqlen = s."""
    b, s = attention_mask_in_length.shape
    lengths = attention_mask_in_length.reshape(-1).to(torch.int32)
    if max_segments is None:
        nz = lengths[lengths > 0]
        seqlens = nz
        max_seqlen = int(nz.max()) if nz.numel() else 0
    else:
        order = torch.argsort((lengths == 0).to(torch.int8), stable=True)
        seqlens = lengths[order][:max_segments]
        max_seqlen = int(s)
    row_total = attention_mask_in_length.sum(-1)
    token_mask = (torch.arange(s, device=row_total.device)[None, :]
                  < row_total[:, None])
    packed, indices = _front_pack(hidden_states, token_mask)
    return packed, indices, _cu_seqlens(seqlens), max_seqlen


def index_first_axis(x, indices):
    """Rows ``indices`` of a flattened (b*s, ...) tensor."""
    return torch.index_select(x, 0, indices)
