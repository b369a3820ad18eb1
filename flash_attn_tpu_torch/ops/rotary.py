"""Rotary position embeddings (port of flash_attn_tpu/ops/rotary.py).

 - rotary_dim = 2 * cos.shape[-1]; only x[..., :rotary_dim] is rotated.
 - non-interleaved (GPT-NeoX style): pairs are the two halves.
 - interleaved (GPT-J style): pairs are even/odd lanes.
 - seqlen_offsets shifts the position index, as an int or per batch row.
 - with cu_seqlens, x is packed (total, h, d) and each token's position is
   its index within its sequence.
 - conjugate rotates by the negated angle (the inverse rotation).
cos/sin are cast to x's type before the rotation, as in the JAX package;
the rotation itself is computed in fp32 and rounded once.
"""

from typing import Optional, Union

import torch

__all__ = ["apply_rotary_emb", "apply_rotary_emb_qkv_", "apply_rotary_emb_kv_"]


def _rotate(x, cos, sin, interleaved: bool, conjugate: bool = False):
    """x (..., s, h, d); cos/sin (..., s, rot/2) already at x's positions."""
    rot = cos.shape[-1] * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    cos = cos.unsqueeze(-2).float()  # insert the head axis
    sin = sin.unsqueeze(-2).float()
    if conjugate:
        sin = -sin
    xf = x_rot.float()
    if interleaved:
        x1, x2 = xf[..., ::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).flatten(-2)
    else:
        x1, x2 = xf.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    out = out.to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if x_pass.shape[-1] else out


def apply_rotary_emb(
    x,    # (b, s, h, d), or packed (total, h, d) with cu_seqlens
    cos,  # (s_max, rot_dim / 2)
    sin,
    interleaved: bool = False,
    seqlen_offsets: Union[int, torch.Tensor] = 0,
    cu_seqlens=None,  # (b + 1,) int32
    max_seqlen: Optional[int] = None,
    conjugate: bool = False,
):
    """Rotate x at positions offset + [0, s), or, packed, at each token's
    position within its sequence (plus its sequence's offset). Positions
    past the end of the table take its last row, as the JAX gather does;
    so do the packed tail's tokens (past cu_seqlens[-1]), which JAX counts
    in the last sequence. ``max_seqlen`` is accepted for the JAX signature;
    the table's length bounds the positions."""
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    last = cos.shape[0] - 1
    if cu_seqlens is not None:
        cu = cu_seqlens.to(x.device, torch.long)
        idx = torch.arange(x.shape[0], device=x.device)
        seg = (torch.searchsorted(cu, idx, right=True) - 1).clamp(
            0, cu.numel() - 2)
        pos = idx - cu[seg]
        if isinstance(seqlen_offsets, int):
            pos = pos + seqlen_offsets
        else:
            pos = pos + seqlen_offsets.to(x.device, torch.long)[seg]
        pos = pos.clamp(max=last)
        return _rotate(x, cos[pos], sin[pos], interleaved, conjugate)
    s_len = x.shape[1]
    pos = torch.arange(s_len, device=x.device)
    if isinstance(seqlen_offsets, int):
        pos = (pos + seqlen_offsets).clamp(max=last)
        return _rotate(x, cos[pos], sin[pos], interleaved, conjugate)
    pos = pos[None, :] + seqlen_offsets.to(x.device, torch.long)[:, None]
    pos = pos.clamp(max=last)
    return _rotate(x, cos[pos], sin[pos], interleaved, conjugate)


def apply_rotary_emb_qkv_(
    qkv,  # (b, s, 3, h, d)
    cos,
    sin,
    interleaved: bool = False,
    seqlen_offsets: Union[int, torch.Tensor] = 0,
):
    """Rotary on q and k of packed qkv; v passes through. Returns a new
    tensor, as the JAX function does (its trailing underscore names the
    reference's in-place op)."""
    q = apply_rotary_emb(qkv[:, :, 0], cos, sin, interleaved, seqlen_offsets)
    k = apply_rotary_emb(qkv[:, :, 1], cos, sin, interleaved, seqlen_offsets)
    return torch.stack([q, k, qkv[:, :, 2]], dim=2)


def apply_rotary_emb_kv_(
    kv,  # (b, s, 2, h, d)
    cos,
    sin,
    interleaved: bool = False,
    seqlen_offsets: Union[int, torch.Tensor] = 0,
):
    """Rotary on k of packed kv; v passes through (a new tensor)."""
    k = apply_rotary_emb(kv[:, :, 0], cos, sin, interleaved, seqlen_offsets)
    return torch.stack([k, kv[:, :, 1]], dim=2)
