"""softcap and ALiBi: the score map of the forward kernels (B1, B4, B8).

In the JAX package's order (flash_attn_tpu/kernels/flash_fwd.py:180-247,
flash_decode.py:245-254, flash_varlen_paged.py:225-233): the natural-scale
score s = q k^T scale, then the cap, tanh(s / softcap) softcap, then
ALiBi's bias times the query head's slope, then the mask. The bias is
col - (sk - 1) under causal masking, relative to the last key and not to
the row (flash_fwd.py:243-245; the decode kernel takes each batch row's own
cache length as sk), and -|row + sk - sq - col| otherwise. Outputs match
the row-relative form, since softmax cancels a per-row constant; the lse
does not, and every forward here keeps JAX's form.

Here: the map on torch tensors for the plain versions (:func:`score_map`),
the slopes in the (b, h) fp32 form the kernels read (:func:`slopes_bh`) and
the arguments the C entry points take (:func:`slope_args`).
"""

from typing import Optional

import torch


def has_score(softcap: float, alibi_slopes) -> bool:
    """Whether a call maps its scores (the kernels' SCORE instantiations)."""
    return softcap > 0.0 or alibi_slopes is not None


def slopes_bh(alibi_slopes, b: int, h: int, device=None):
    """The slopes as (b, h) fp32 on ``device`` with the head dim
    contiguous: a (h,) vector broadcast over the batch (a stride-0 view), a
    (b, h) tensor as it is; None stays None. Raises ValueError for any
    other shape."""
    if alibi_slopes is None:
        return None
    s = alibi_slopes.to(device or alibi_slopes.device,
                        torch.float32).contiguous()
    if s.shape == (h,):
        return s[None].expand(b, h)
    if s.shape != (b, h):
        raise ValueError(f"alibi_slopes: shape {tuple(s.shape)}, want ({h},) "
                         f"or ({b}, {h})")
    return s


def slope_args(slopes):
    """(pointer, batch stride) of :func:`slopes_bh`'s slopes for a C entry
    point; (None, 0) without slopes. The caller holds ``slopes`` until the
    launch."""
    if slopes is None:
        return None, 0
    return slopes.data_ptr(), slopes.stride(0)


def alibi_bias(rows, cols, sq, sk, causal: bool):
    """ALiBi's bias in fp32 for query rows ``rows`` against keys ``cols``
    (the three broadcast; ``sq`` and ``sk`` ints or per-sequence tensors)."""
    if causal:
        return (cols - (sk - 1)).float()
    return -(rows + (sk - sq) - cols).abs().float()


def score_map(s, softcap: float = 0.0, slopes: Optional[torch.Tensor] = None,
              bias=None):
    """Natural-scale fp32 scores ``s`` after the cap and ALiBi: ``slopes``
    broadcast against s with ``bias`` (:func:`alibi_bias`)."""
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    if slopes is not None:
        s = s + slopes * bias
    return s
