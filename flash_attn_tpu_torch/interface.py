"""Public attention API: ``flash_attn_func``, differentiable, and
``flash_attn_varlen_func`` over a paged cache, forward only.

Port of flash_attn_tpu/interface.py ``flash_attn_func`` (:208) and its
``jax.custom_vjp`` (:98-205) as a ``torch.autograd.Function``. Takes and
returns (batch, seqlen, nheads, head_dim) tensors; the forward runs the
kernel of kernels/flash_fwd.py, the backward those of kernels/flash_bwd.py
(the plain versions for CPU tensors). ``flash_attn_varlen_func`` (:403) is
ported for its ``block_table=`` route (:499-546), the chunked prefill of
the serving engine, through kernels/flash_varlen_paged.py.
"""

import math
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.config import normalize_window
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd
from flash_attn_tpu_torch.kernels.flash_varlen_paged import (
    flash_attention_varlen_paged_fwd,
)

__all__ = ["flash_attn_func", "flash_attn_varlen_func", "require_no_grad",
           "reject_unsupported"]


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
        # The kernels read 16-byte chunks along the head dim; autograd may
        # hand dout in any layout.
        if dout.stride(-1) != 1 or any(st % 8 for st in dout.stride()[:-1]) \
                or dout.data_ptr() % 16:
            dout = dout.contiguous()
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
    None). Differentiable in q, k and v: ``deterministic`` (the default, as
    in JAX) runs the dK/dV and dQ backward kernels, each writing its
    gradient once; False runs the fused backward with atomic dQ. Only dense
    causal/non-causal attention is ported; every other option raises
    NotImplementedError."""
    reject_unsupported(
        "flash_attn_func", dropout_p=dropout_p,
        window_size=normalize_window(tuple(window_size)), softcap=softcap,
        alibi_slopes=alibi_slopes, attention_chunk=attention_chunk,
        sink_token_length=sink_token_length, learnable_sink=learnable_sink,
        dropout_rng=dropout_rng, q_descale=q_descale, k_descale=k_descale,
        v_descale=v_descale, qv=qv, score_mod=score_mod, mask_mod=mask_mod,
        aux_tensors=aux_tensors)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = _FlashAttn.apply(q, k, v, softmax_scale, causal, deterministic)
    return (out, lse, None) if return_attn_probs else out


def flash_attn_varlen_func(
    q,  # (total_q, nheads, head_dim)
    k,  # paged: (num_pages, nheads_k, page_size, head_dim)
    v,
    cu_seqlens_q,  # (batch + 1,) int32
    cu_seqlens_k,  # (batch + 1,) int32, or None with seqused_k
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
    """Packed varlen attention over a paged KV cache, forward only (as in
    JAX, where paged attention has no backward).

    With ``block_table``, ``k``/``v`` are paged caches (num_pages, nheads_k,
    page_size, head_dim), and each sequence's key count comes from
    ``seqused_k`` (or the deltas of ``cu_seqlens_k``). Query rows are packed
    by ``cu_seqlens_q``; ``seqused_q`` gives each sequence's true query
    length inside a padded layout. Causal masking is bottom-right aligned.
    Returns out (total_q, nheads, head_dim); with ``return_attn_probs``,
    (out, lse (nheads, total_q) fp32). Window, softcap, ALiBi, chunking,
    sinks, descales and ``qv`` raise NotImplementedError (ROADMAP.md queue
    A, item 7); so does the dense varlen route without ``block_table``
    (queue A, item 5)."""
    if block_table is None:
        raise NotImplementedError(
            "flash_attn_varlen_func: only the paged route (block_table=) is "
            "ported; dense packed varlen attention (the B6/B7 kernels) is "
            "ROADMAP.md queue A, item 5")
    reject_unsupported(
        "flash_attn_varlen_func", roadmap_item="queue A, item 7",
        dropout_p=dropout_p,
        window_size=normalize_window(tuple(window_size)), softcap=softcap,
        alibi_slopes=alibi_slopes, attention_chunk=attention_chunk,
        learnable_sink=learnable_sink, qv=qv, dropout_rng=dropout_rng,
        q_descale=q_descale, k_descale=k_descale, v_descale=v_descale,
        scheduler_metadata=scheduler_metadata)
    require_no_grad("flash_attn_varlen_func", q, k, v)
    if seqused_k is None:
        seqused_k = cu_seqlens_k[1:] - cu_seqlens_k[:-1]
    out, lse = flash_attention_varlen_paged_fwd(
        q, k, v, cu_seqlens_q, int(max_seqlen_q), seqused_k, block_table,
        seqused_q=seqused_q, softmax_scale=softmax_scale, causal=causal)
    return (out, lse) if return_attn_probs else out
