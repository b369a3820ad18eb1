"""Golden reference attention and the repo's numerics contract.

Port of flash_attn_tpu/utils/testing.py ``attention_ref`` (:177) and
``check_against_ref`` (:306), for the masks the port supports, with the
paged-cache references of the serving engine (``paged_to_linear``,
``attention_varlen_paged_ref``). The contract: a kernel's output, computed in bf16/fp16, must satisfy

    max|out - ref_fp32| <= 2 * max|ref_lowprec - ref_fp32| + atol

where ``ref_lowprec`` is the same full-matrix attention computed in the
kernel's precision (``upcast=False``). Gradients are held the same way,
against autograd through the reference (``attention_ref_grads``).
"""

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["attention_ref", "attention_ref_grads", "attention_varlen_paged_ref",
           "check_against_ref", "paged_to_linear"]


def attention_ref(
    q,  # (b, sq, h, d)
    k,  # (b, sk, h_k, d)
    v,  # (b, sk, h_k, dv)
    key_padding_mask=None,  # (b, sk) bool, True = keep
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    upcast: bool = True,
):
    """Full-matrix attention, fp32 by default (``upcast``), else in the
    inputs' type. Bottom-right aligned causal mask (over the unpadded key
    count), GQA head replication, zero output for rows that see no key.
    Returns (output (b, sq, h, dv), attention (b, h, sq, sk))."""
    dtype_og = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
    g = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    seqlen_q, seqlen_k = q.shape[1], k.shape[1]
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bthd,bshd->bhts", q * softmax_scale, k)
    neg_inf = float("-inf")
    if key_padding_mask is not None:
        scores = scores.masked_fill(~key_padding_mask[:, None, None, :], neg_inf)
    if causal:
        row = torch.arange(seqlen_q, device=q.device)[:, None]
        col = torch.arange(seqlen_k, device=q.device)[None, :]
        sk = (seqlen_k if key_padding_mask is None
              else key_padding_mask.sum(-1).reshape(-1, 1, 1, 1))
        scores = scores.masked_fill(col > row + sk - seqlen_q, neg_inf)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - torch.where(torch.isneginf(m), 0.0, m))
    e = torch.where(torch.isneginf(scores), 0.0, e)
    denom = e.sum(dim=-1, keepdim=True)
    attention = (e / torch.where(denom == 0, 1.0, denom)).to(v.dtype)
    output = torch.einsum("bhts,bshd->bthd", attention, v)
    return output.to(dtype_og), attention.to(dtype_og)


def attention_ref_grads(q, k, v, dout, causal: bool = False,
                        softmax_scale: Optional[float] = None,
                        upcast: bool = True):
    """(dq, dk, dv) of sum(attention_ref(q, k, v) * dout) by autograd: the
    fp32 reference of a backward (``upcast``), or the low-precision one
    computed in the inputs' type, for :func:`check_against_ref`."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out, _ = attention_ref(*leaves, causal=causal,
                               softmax_scale=softmax_scale, upcast=upcast)
        return torch.autograd.grad(out, leaves, dout.to(out.dtype))


def paged_to_linear(k_pages, block_table, lengths):
    """Gather a paged cache (num_pages, h_k, page_size, d) through its block
    table (b, max_pages) into the linear layout (b, h_k, max_pages *
    page_size, d), zero at positions >= lengths (b,). Table entries out of
    range read the nearest page, as the kernels clamp them."""
    num_pages, h_k, page_size, d = k_pages.shape
    b, width = block_table.shape
    table = block_table.to(k_pages.device, torch.long).clamp(0, num_pages - 1)
    lin = k_pages[table].permute(0, 2, 1, 3, 4).reshape(
        b, h_k, width * page_size, d)
    pos = torch.arange(width * page_size, device=k_pages.device)
    keep = pos[None, :] < lengths.to(k_pages.device, torch.long)[:, None]
    return lin * keep[:, None, :, None].to(lin.dtype)


def attention_varlen_paged_ref(q, k_pages, v_pages, cu_seqlens_q, seqlens_k,
                               block_table, seqused_q=None,
                               causal: bool = False,
                               softmax_scale: Optional[float] = None,
                               upcast: bool = True):
    """Packed-varlen attention over a paged cache, one :func:`attention_ref`
    call per sequence. Sequence i owns the packed rows cu_seqlens_q[i] ..
    cu_seqlens_q[i + 1]; its first seqused_q[i] rows (all when seqused_q
    is None) attend to its first seqlens_k[i] keys with bottom-right causal
    alignment, the rest give zeros. Returns out (total_q, h, dv)."""
    cu = cu_seqlens_q.tolist()
    lens_k = seqlens_k.tolist()
    used = (seqused_q.tolist() if seqused_q is not None
            else [hi - lo for lo, hi in zip(cu[:-1], cu[1:])])
    k_lin = paged_to_linear(k_pages, block_table, seqlens_k).transpose(1, 2)
    v_lin = paged_to_linear(v_pages, block_table, seqlens_k).transpose(1, 2)
    out = torch.zeros(q.shape[:2] + v_pages.shape[-1:], dtype=q.dtype,
                      device=q.device)
    for i, (lo, lq, lk) in enumerate(zip(cu[:-1], used, lens_k)):
        if lq == 0 or lk == 0:
            continue
        o, _ = attention_ref(q[None, lo:lo + lq], k_lin[i:i + 1, :lk],
                             v_lin[i:i + 1, :lk], causal=causal,
                             softmax_scale=softmax_scale, upcast=upcast)
        out[lo:lo + lq] = o[0]
    return out


def check_against_ref(out, out_ref_fp32, out_ref_lowprec, *, mult: float = 2.0,
                      atol: float = 1e-5, msg: str = ""):
    """The reference numerics contract: kernel error <= mult x low-precision
    reference error (+ a small absolute floor). Raises AssertionError;
    returns (err, err_lowprec)."""
    def f32(x):
        return x.detach().float().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x, dtype=np.float32)

    out, ref, ref_lp = f32(out), f32(out_ref_fp32), f32(out_ref_lowprec)
    err = float(np.abs(out - ref).max())
    err_lp = float(np.abs(ref_lp - ref).max())
    if not err <= mult * err_lp + atol:
        raise AssertionError(
            f"{msg} kernel max err {err:.3e} > {mult} x lowprec ref err "
            f"{err_lp:.3e} + {atol:.1e}")
    return err, err_lp
