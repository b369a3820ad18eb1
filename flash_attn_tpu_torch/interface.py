"""Public attention API: ``flash_attn_func``, differentiable.

Port of flash_attn_tpu/interface.py ``flash_attn_func`` (:208) and its
``jax.custom_vjp`` (:98-205) as a ``torch.autograd.Function``. Takes and
returns (batch, seqlen, nheads, head_dim) tensors; the forward runs the
kernel of kernels/flash_fwd.py, the backward those of kernels/flash_bwd.py
(the plain versions for CPU tensors).
"""

import math
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.config import normalize_window
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd

__all__ = ["flash_attn_func", "require_no_grad", "reject_unsupported"]


def require_no_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: forward only; it is a decode step, which takes no "
            "gradient in the JAX package either (the engine is ROADMAP.md "
            "queue A, item 3). Call it under torch.no_grad() or "
            "torch.inference_mode().")


def reject_unsupported(name: str, **args) -> None:
    """Raise for every argument set away from its default (value None,
    False, 0 or a (None, None) window)."""
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
            f"{name}: {key}={val!r} is not ported yet (ROADMAP.md lists the "
            "arguments still to port)")


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
