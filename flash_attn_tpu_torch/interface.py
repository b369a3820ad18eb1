"""Public attention API: ``flash_attn_func`` and ``flash_attn_varlen_func``,
both differentiable, with their packed forms.

Port of flash_attn_tpu/interface.py ``flash_attn_func`` (:208) and its
``jax.custom_vjp`` (:98-205) as a ``torch.autograd.Function``. Takes and
returns (batch, seqlen, nheads, head_dim) tensors; the forward runs the
kernel of kernels/flash_fwd.py, the backward those of kernels/flash_bwd.py
(the plain versions for CPU tensors). ``flash_attn_varlen_func`` (:403-496,
``custom_vjp`` :323-400) takes packed (total, nheads, head_dim) tensors: its
dense route runs the persistent forward of kernels/flash_varlen_persistent.py
and the backward of kernels/flash_varlen.py; its ``block_table=`` route
(:499-546), the chunked prefill of the serving engine, runs
kernels/flash_varlen_paged.py, forward only, or, with the MLA second query
``qv``, kernels/flash_paged_prefill.py (JAX sends ``qv`` there only when d
or dv is not a multiple of 128, :520-527, and otherwise concatenates q and
qv for B8, :528-543: a split for the TPU's 128 lanes; the function is the
same). The packed forms (:594-680) slice q, k and v out of one tensor.
"""

import math
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.config import (
    VARLEN_FWD_TILE,
    normalize_window,
)
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd
from flash_attn_tpu_torch.kernels.flash_paged_prefill import (
    flash_attention_paged_prefill_varlen,
)
from flash_attn_tpu_torch.kernels.flash_varlen import (
    flash_attention_varlen_bwd,
    varlen_meta,
)
from flash_attn_tpu_torch.kernels.flash_varlen_paged import (
    flash_attention_varlen_paged_fwd,
)
from flash_attn_tpu_torch.kernels.flash_varlen_persistent import (
    flash_attention_varlen_fwd_persistent,
)

__all__ = ["flash_attn_func", "flash_attn_kvpacked_func",
           "flash_attn_qkvpacked_func", "flash_attn_varlen_func",
           "flash_attn_varlen_kvpacked_func",
           "flash_attn_varlen_qkvpacked_func", "reject_unsupported",
           "require_no_grad"]


def require_no_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: forward only; it serves the engine's prefill and decode "
            "steps, which take no gradient in the JAX package either. Call "
            "it under torch.no_grad() or torch.inference_mode().")


def reject_unsupported(name: str, roadmap_item: str = "", **args) -> None:
    """Raise for every argument set away from its default (value None,
    False, 0 or a (None, None) window), naming the ROADMAP.md item that
    ports it when one is given."""
    for key, val in args.items():
        if key == "dropout_p" and val > 0:
            # The JAX trainer never turns dropout on (deterministic=True).
            raise NotImplementedError(
                f"{name}: dropout_p={val!r} is not ported yet: dropout (the "
                "B9 hash inside the kernels) is ROADMAP.md queue A, item 7")
        if val is None or val is False or (
                isinstance(val, (int, float)) and val == 0) or (
                isinstance(val, tuple) and val == (None, None)):
            continue
        raise NotImplementedError(
            f"{name}: {key}={val!r} is not ported yet (ROADMAP.md "
            f"{roadmap_item or 'lists the arguments still to port'})")


def _reconstruct_s_dmask(q, k, lse, softmax_scale: float, causal: bool):
    """The (b, h, sq, sk) fp32 attention probabilities that
    ``return_attn_probs`` returns (JAX ``_reconstruct_s_dmask``,
    flash_attn_tpu/interface.py:44): scores rebuilt with torch ops from q
    and k (GQA by grouping query heads), bottom-right causal, normalised by
    the kernel's own lse; 0 where masked and on rows that see no key. A
    testing aid, not a kernel."""
    b, sq, h, d = q.shape
    sk, h_k = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, h_k, h // h_k, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf * softmax_scale,
                          k.float()).reshape(b, h, sq, sk)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows + (sk - sq), float("-inf"))
    seen = torch.isfinite(lse)[..., None]
    probs = torch.exp(scores - torch.where(seen, lse[..., None], 0.0))
    return torch.where(seen & torch.isfinite(scores), probs, 0.0)


def _kernel_layout(dout):
    """dout as the kernels read it: 16-byte chunks along the head dim
    (autograd may hand a cotangent in any layout)."""
    if dout.stride(-1) != 1 or any(st % 8 for st in dout.stride()[:-1]) \
            or dout.data_ptr() % 16:
        return dout.contiguous()
    return dout


class _FlashAttn(torch.autograd.Function):
    """out, lse = attention(q, k, v) on (b, s, h, d) tensors; the lse is an
    inspection output whose cotangent is dropped, as in JAX."""

    @staticmethod
    def forward(ctx, q, k, v, softmax_scale, causal, deterministic):
        out_t, lse = flash_attention_fwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            softmax_scale=softmax_scale, causal=causal)
        out = out_t.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (softmax_scale, causal, deterministic)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        softmax_scale, causal, deterministic = ctx.args
        dout = _kernel_layout(dout)
        dq, dk, dv = flash_attention_bwd(
            dout.transpose(1, 2), q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), out.transpose(1, 2), lse,
            softmax_scale=softmax_scale, causal=causal,
            deterministic=deterministic)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None)


def flash_attn_func(
    q,
    k,
    v,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[Optional[int], Optional[int]] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    learnable_sink=None,
    dropout_rng=None,
    q_descale=None,
    k_descale=None,
    v_descale=None,
    qv=None,
    score_mod=None,
    mask_mod=None,
    aux_tensors=None,
):
    """q (batch, seqlen_q, nheads, head_dim), k/v (batch, seqlen_k,
    nheads_k, head_dim) with nheads % nheads_k == 0. Causal masking is
    bottom-right aligned. Returns out (batch, seqlen_q, nheads, head_dim);
    with ``return_attn_probs``, (out, lse (batch, nheads, seqlen_q) fp32,
    S_dmask): the (batch, nheads, seqlen_q, seqlen_k) fp32 probabilities
    normalised by lse, rebuilt with torch ops as JAX does (for tests, not
    gradients). Differentiable in q, k and v: ``deterministic`` (the
    default, as in JAX) runs the dK/dV and dQ backward kernels, each
    writing its gradient once; False runs the fused backward with atomic
    dQ. Only dense causal/non-causal attention is ported; every other
    option raises NotImplementedError (ROADMAP.md queue A, item 7)."""
    reject_unsupported(
        "flash_attn_func", roadmap_item="queue A, item 7", dropout_p=dropout_p,
        window_size=normalize_window(tuple(window_size)), softcap=softcap,
        alibi_slopes=alibi_slopes, attention_chunk=attention_chunk,
        sink_token_length=sink_token_length, learnable_sink=learnable_sink,
        dropout_rng=dropout_rng, q_descale=q_descale, k_descale=k_descale,
        v_descale=v_descale, qv=qv, score_mod=score_mod, mask_mod=mask_mod,
        aux_tensors=aux_tensors)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = _FlashAttn.apply(q, k, v, softmax_scale, causal, deterministic)
    if not return_attn_probs:
        return out
    with torch.no_grad():
        s_dmask = _reconstruct_s_dmask(q, k, lse, softmax_scale, causal)
    return out, lse, s_dmask


class _FlashAttnVarlen(torch.autograd.Function):
    """out, lse = packed varlen attention; the forward is the persistent
    kernel (B7), the backward the dK/dV + dQ kernels (B6). ``meta`` holds
    the work lists of both; the lse is an inspection output whose cotangent
    is dropped, as in JAX."""

    @staticmethod
    def forward(ctx, q, k, v, cu_seqlens_q, cu_seqlens_k, seqused_q,
                seqused_k, meta, max_seqlen_q, max_seqlen_k, softmax_scale,
                causal):
        args = (cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
                seqused_q, seqused_k, softmax_scale, causal)
        out, lse = flash_attention_varlen_fwd_persistent(q, k, v, *args,
                                                         meta=meta)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args, ctx.meta = args, meta
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_varlen_bwd(
            _kernel_layout(dout), q, k, v, out, lse, *ctx.args, meta=ctx.meta)
        return (dq, dk, dv) + (None,) * 9


def flash_attn_varlen_func(
    q,  # (total_q, nheads, head_dim)
    k,  # (total_k, nheads_k, head_dim); paged: (num_pages, nheads_k, page_size, head_dim)
    v,
    cu_seqlens_q,  # (batch + 1,) int32
    cu_seqlens_k,  # (batch + 1,) int32, or None with block_table and seqused_k
    max_seqlen_q: int,
    max_seqlen_k: int,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[Optional[int], Optional[int]] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    seqused_q=None,
    seqused_k=None,
    attention_chunk: int = 0,
    learnable_sink=None,
    qv=None,
    dropout_rng=None,
    block_table=None,  # (batch, max_pages) int32: k/v are paged caches
    q_descale=None,
    k_descale=None,
    v_descale=None,
    scheduler_metadata=None,
):
    """Packed varlen attention. Sequence i owns query rows cu_seqlens_q[i]
    .. cu_seqlens_q[i + 1] (its first seqused_q[i] when given) and the same
    range of keys; ``max_seqlen_q/k`` bound the sequences' lengths. Causal
    masking is bottom-right aligned per sequence. Rows in no sequence (the
    packed tail of ``unpad_input``) give zeros.

    Without ``block_table``: k/v are packed (total_k, nheads_k, head_dim),
    differentiable in q, k and v; ``deterministic`` is accepted and changes
    nothing (the backward always writes each gradient once, as in JAX);
    ``scheduler_metadata`` from :func:`get_scheduler_metadata` reuses the
    work lists. Returns out (total_q, nheads, head_dim); with
    ``return_attn_probs``, (out, lse (nheads, total_q) fp32, None).

    With ``block_table``: k/v are paged caches (num_pages, nheads_k,
    page_size, head_dim), each sequence's key count from ``seqused_k`` (or
    the deltas of ``cu_seqlens_k``), forward only (as in JAX, where paged
    attention has no backward); with ``return_attn_probs``, (out, lse).
    ``qv`` (total_q, nheads, head_dim_v) is the MLA second query, scored
    against v (DeepSeek's absorbed chunked prefill); out is then (total_q,
    nheads, head_dim_v) and the scale defaults to 1/sqrt(head_dim +
    head_dim_v).

    Window, softcap, ALiBi, chunking, sinks, dropout, descales, and ``qv``
    without ``block_table``, raise NotImplementedError (ROADMAP.md queue A,
    item 7)."""
    reject_unsupported(
        "flash_attn_varlen_func", roadmap_item="queue A, item 7",
        dropout_p=dropout_p,
        window_size=normalize_window(tuple(window_size)), softcap=softcap,
        alibi_slopes=alibi_slopes, attention_chunk=attention_chunk,
        learnable_sink=learnable_sink, dropout_rng=dropout_rng,
        qv=qv if block_table is None else None,
        q_descale=q_descale, k_descale=k_descale, v_descale=v_descale)
    if block_table is not None:
        if scheduler_metadata is not None:
            raise NotImplementedError(
                "flash_attn_varlen_func: scheduler_metadata with block_table "
                "is not ported yet (ROADMAP.md queue A, item 7)")
        require_no_grad("flash_attn_varlen_func", q, k, v, qv)
        if seqused_k is None:
            seqused_k = cu_seqlens_k[1:] - cu_seqlens_k[:-1]
        if qv is not None:
            out, lse = flash_attention_paged_prefill_varlen(
                q, k, v, cu_seqlens_q, int(max_seqlen_q), seqused_k,
                block_table, seqused_q=seqused_q, qv=qv,
                softmax_scale=softmax_scale, causal=causal)
            return (out, lse) if return_attn_probs else out
        out, lse = flash_attention_varlen_paged_fwd(
            q, k, v, cu_seqlens_q, int(max_seqlen_q), seqused_k, block_table,
            seqused_q=seqused_q, softmax_scale=softmax_scale, causal=causal)
        return (out, lse) if return_attn_probs else out
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    meta = None
    if scheduler_metadata is not None:
        if (scheduler_metadata.block_q, scheduler_metadata.block_k) != (
                VARLEN_FWD_TILE.block_q, VARLEN_FWD_TILE.block_k):
            raise ValueError(
                "flash_attn_varlen_func: scheduler_metadata tiles "
                f"{scheduler_metadata.block_q} x {scheduler_metadata.block_k}"
                f", the kernels' are {VARLEN_FWD_TILE}")
        meta = scheduler_metadata.meta
        away = [name for name, t in meta._asdict().items()
                if t.device != q.device]
        if away:
            # the kernels would read these through host pointers
            raise ValueError(
                "flash_attn_varlen_func: scheduler_metadata tensors "
                f"{away} are not on q's device {q.device} (build it with "
                "cu_seqlens_q on that device, or get_scheduler_metadata("
                "device=...))")
    meta = varlen_meta(q, k, cu_seqlens_q, cu_seqlens_k, int(max_seqlen_q),
                       int(max_seqlen_k), seqused_q, seqused_k, causal, meta)
    out, lse = _FlashAttnVarlen.apply(
        q, k, v, cu_seqlens_q, cu_seqlens_k, seqused_q, seqused_k, meta,
        int(max_seqlen_q), int(max_seqlen_k), softmax_scale, causal)
    return (out, lse, None) if return_attn_probs else out


def flash_attn_varlen_qkvpacked_func(
    qkv,  # (total, 3, nheads, head_dim)
    cu_seqlens,
    max_seqlen: int,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
):
    """:func:`flash_attn_varlen_func` on q, k, v = qkv[:, 0], [:, 1], [:, 2]
    with one cu_seqlens for both sides."""
    return flash_attn_varlen_func(
        qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens, cu_seqlens,
        max_seqlen, max_seqlen, dropout_p=dropout_p,
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, alibi_slopes=alibi_slopes,
        deterministic=deterministic, return_attn_probs=return_attn_probs)


def flash_attn_varlen_kvpacked_func(
    q,  # (total_q, nheads, head_dim)
    kv,  # (total_k, 2, nheads_k, head_dim)
    cu_seqlens_q,
    cu_seqlens_k,
    max_seqlen_q: int,
    max_seqlen_k: int,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
):
    """:func:`flash_attn_varlen_func` on k, v = kv[:, 0], kv[:, 1]."""
    return flash_attn_varlen_func(
        q, kv[:, 0], kv[:, 1], cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
        max_seqlen_k, dropout_p=dropout_p, softmax_scale=softmax_scale,
        causal=causal, window_size=window_size, softcap=softcap,
        alibi_slopes=alibi_slopes, deterministic=deterministic,
        return_attn_probs=return_attn_probs)


def flash_attn_qkvpacked_func(
    qkv,  # (batch, seqlen, 3, nheads, head_dim)
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    dropout_rng=None,
):
    """:func:`flash_attn_func` on q, k, v = qkv[:, :, 0], [:, :, 1],
    [:, :, 2]."""
    return flash_attn_func(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dropout_p=dropout_p,
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, alibi_slopes=alibi_slopes,
        deterministic=deterministic, return_attn_probs=return_attn_probs,
        dropout_rng=dropout_rng)


def flash_attn_kvpacked_func(
    q,  # (batch, seqlen_q, nheads, head_dim)
    kv,  # (batch, seqlen_k, 2, nheads_k, head_dim)
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    dropout_rng=None,
):
    """:func:`flash_attn_func` on k, v = kv[:, :, 0], kv[:, :, 1]."""
    return flash_attn_func(
        q, kv[:, :, 0], kv[:, :, 1], dropout_p=dropout_p,
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, alibi_slopes=alibi_slopes,
        deterministic=deterministic, return_attn_probs=return_attn_probs,
        dropout_rng=dropout_rng)
