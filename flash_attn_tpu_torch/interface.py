"""Public attention API: ``flash_attn_func`` and ``flash_attn_varlen_func``,
both differentiable, with their packed forms.

Port of flash_attn_tpu/interface.py ``flash_attn_func`` (:208) and its
``jax.custom_vjp`` (:98-205) as a ``torch.autograd.Function``. Takes and
returns (batch, seqlen, nheads, head_dim) tensors; the forward runs the
kernel of kernels/flash_fwd.py, the backward those of kernels/flash_bwd.py
(the plain versions for CPU tensors). ``flash_attn_varlen_func`` (:403-496,
``custom_vjp`` :323-400) takes packed (total, nheads, head_dim) tensors: its
dense route runs the persistent forward of kernels/flash_varlen_persistent.py
and the backward of kernels/flash_varlen.py. Both train through the band
masks (``flash_attn_func``: a window, attention_chunk and sink tokens; the
dense varlen route: a window and attention_chunk), the band kept beside
the forward's residuals as JAX's custom_vjp keeps it among its nondiff
arguments, and through softcap and ALiBi (the kernels' score
instantiations, forward and backward; the slopes an input whose gradient
is zero, as JAX returns), and with a learnable sink (one logit a query
head, in every forward kernel's epilogue; its gradient an epilogue of
torch ops over the backward's delta, as JAX's :185-200 and :384-394 are
XLA ops: dispatch/sink.py). The dense varlen route sends ALiBi to B6's
forward (kernels/flash_varlen.py) and every other call to the persistent
B7, as JAX does (:347-352). The varlen ``block_table=``
route (:499-546), the chunked prefill of the serving engine, runs
kernels/flash_varlen_paged.py, forward only (with a sliding window,
softcap and the learnable sink; ALiBi raises, as JAX's route drops the
slopes), or,
with the MLA second query
``qv``, kernels/flash_paged_prefill.py (JAX sends ``qv`` there only when d
or dv is not a multiple of 128, :520-527, and otherwise concatenates q and
qv for B8, :528-543: a split for the TPU's 128 lanes; the function is the
same; the sink too). The packed forms (:594-680) slice q, k and v out of
one tensor, and take no sink, as in JAX.
"""

import math
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.band import band_valid, has_band
from flash_attn_tpu_torch.dispatch.config import (
    FWD_TILE,
    normalize_window,
)
from flash_attn_tpu_torch.dispatch.kvquant import combined_descales
from flash_attn_tpu_torch.dispatch.score import (
    alibi_bias,
    score_map,
    slopes_bh,
)
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd
from flash_attn_tpu_torch.kernels.flash_paged_prefill import (
    flash_attention_paged_prefill_varlen,
)
from flash_attn_tpu_torch.kernels.flash_varlen import (
    flash_attention_varlen_bwd,
    flash_attention_varlen_fwd,
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
    """Raise before any kernel runs when a gradient is asked of a
    forward-only route."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: forward only; it serves the engine's prefill and decode "
            "steps, which take no gradient in the JAX package either. Call "
            "it under torch.no_grad() or torch.inference_mode().")


def _described(val) -> str:
    """An argument as a refusal names it: a tensor by its shape and dtype
    (its values would fill the message), anything else by its repr."""
    if isinstance(val, torch.Tensor):
        return f"<tensor of shape {tuple(val.shape)}, {val.dtype}>"
    return repr(val)


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
            f"{name}: {key}={_described(val)} is not ported yet (ROADMAP.md "
            f"{roadmap_item or 'lists the arguments still to port'})")


def _reconstruct_s_dmask(q, k, lse, softmax_scale: float, causal: bool,
                         window_size=(None, None), sink_token_length: int = 0,
                         attention_chunk: int = 0, softcap: float = 0.0,
                         alibi_slopes=None):
    """The (b, h, sq, sk) fp32 attention probabilities that
    ``return_attn_probs`` returns (JAX ``_reconstruct_s_dmask``,
    flash_attn_tpu/interface.py:44): scores rebuilt with torch ops from q
    and k (GQA by grouping query heads), capped and biased as the kernel
    maps them (dispatch/score.py), bottom-right causal and under the band,
    normalised by the kernel's own lse; 0 where masked and on rows that see
    no key (with a learnable sink the rows then sum to less than 1, as in
    JAX, where the lse holds the sink). A testing aid, not a kernel."""
    b, sq, h, d = q.shape
    sk, h_k = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, h_k, h // h_k, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf * softmax_scale,
                          k.float()).reshape(b, h, sq, sk)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    slopes = slopes_bh(alibi_slopes, b, h, q.device)
    if slopes is not None:
        slopes = slopes[..., None, None]
    scores = score_map(scores, softcap, slopes,
                       alibi_bias(rows, cols, sq, sk, causal))
    if causal or has_band(causal, window_size, attention_chunk):
        valid = band_valid(rows, cols, sk - sq, causal, window_size,
                           sink_token_length, attention_chunk)
        scores = scores.masked_fill(~valid, float("-inf"))
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


def _slopes_grad(ctx, alibi_slopes):
    """The slopes' cotangent: zeros when asked for (JAX returns zeros,
    flash_attn_tpu/interface.py:182-184: the slopes are not learned)."""
    if alibi_slopes is None or not ctx.needs_input_grad[3]:
        return None
    return torch.zeros_like(alibi_slopes)


def _sink_for_grad(ctx, learnable_sink):
    """The sink for the backward kernels' wrappers when its gradient is
    asked for (they then return it after dv), else None."""
    if learnable_sink is None or not ctx.needs_input_grad[4]:
        return None
    return learnable_sink


class _FlashAttn(torch.autograd.Function):
    """out, lse = attention(q, k, v) on (b, s, h, d) tensors under the
    causal bound, ``band`` (window_size, sink_token_length and
    attention_chunk), the score map (``softcap``, ``alibi_slopes``), which
    the backward applies as the forward did, and the learnable sink, whose
    gradient is the backward's epilogue; the lse is an inspection output
    whose cotangent is dropped, as in JAX, and the slopes' gradient is
    zero."""

    @staticmethod
    def forward(ctx, q, k, v, alibi_slopes, learnable_sink, softmax_scale,
                causal, deterministic, band, softcap):
        score = dict(softcap=softcap, alibi_slopes=alibi_slopes)
        out_t, lse = flash_attention_fwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            softmax_scale=softmax_scale, causal=causal, **band, **score,
            learnable_sink=learnable_sink)
        out = out_t.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, lse, alibi_slopes,
                              learnable_sink)
        ctx.args = (softmax_scale, causal, deterministic, band, softcap)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, alibi_slopes, learnable_sink = ctx.saved_tensors
        softmax_scale, causal, deterministic, band, softcap = ctx.args
        dout = _kernel_layout(dout)
        sink = _sink_for_grad(ctx, learnable_sink)
        dq, dk, dv, *dsink = flash_attention_bwd(
            dout.transpose(1, 2), q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), out.transpose(1, 2), lse,
            softmax_scale=softmax_scale, causal=causal,
            deterministic=deterministic, **band, softcap=softcap,
            alibi_slopes=alibi_slopes, learnable_sink=sink)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                _slopes_grad(ctx, alibi_slopes),
                dsink[0].to(sink.dtype) if dsink else None,
                None, None, None, None, None)


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
    """q (batch, seqlen_q, nheads, head_dim), k (batch, seqlen_k, nheads_k,
    head_dim), v (batch, seqlen_k, nheads_k, head_dim_v) with nheads %
    nheads_k == 0. Causal masking is bottom-right aligned. Returns out
    (batch, seqlen_q, nheads, head_dim_v);
    with ``return_attn_probs``, (out, lse (batch, nheads, seqlen_q) fp32,
    S_dmask): the (batch, nheads, seqlen_q, seqlen_k) fp32 probabilities
    normalised by lse, rebuilt with torch ops as JAX does (for tests, not
    gradients). Differentiable in q, k and v: ``deterministic`` (the
    default, as in JAX) runs the dK/dV and dQ backward kernels, each
    writing its gradient once; False runs the fused backward with atomic
    dQ. On the card the forward and the backward take head dims 64, 80,
    96, 128 and 256 (HEAD_DIMS), and head_dim 192 beside head_dim_v 128
    (DENSE_HEAD_DIMS: DeepSeek's MLA when it is not absorbed, without the
    band and the score map, which raise NotImplementedError there); other
    head dims raise ValueError. ``qv`` (batch, seqlen_q, nheads,
    head_dim_v), the MLA second query scored against v, runs as JAX's
    (flash_attn_tpu/interface.py:257-276) by the concatenation q.k^T +
    qv.v^T = [q, qv].[k, v]^T: the kernels at head_dim + head_dim_v beside
    head_dim_v, forward and backward (dqv a slice of the concatenation's
    gradient, v's the P V side plus the score side), the scale 1/sqrt(
    head_dim + head_dim_v) unless given; on the card (64, 128) alone
    reaches a compiled pair (192, 128).
    ``window_size`` (left, right; -1 or None for no bound),
    ``attention_chunk`` and ``sink_token_length`` mask as in JAX
    (dispatch/band.py), forward and backward (the kernels' band
    instantiations, in both ``deterministic`` modes). ``softcap`` (0: none)
    and ``alibi_slopes`` ((nheads,) or (batch, nheads), fp32) map the
    scores as JAX's do (dispatch/score.py; the lse in JAX's form), forward
    and backward (the kernels' score instantiations, with or without a
    band); a ``requires_grad`` slopes tensor gets a zero gradient, as in
    JAX. ``learnable_sink`` ((nheads,), any float type on q's device: one
    natural-log logit a query head, not scaled, capped or biased) adds one
    more logit to every row's softmax (dispatch/sink.py; a row that sees
    no key gives out 0 and lse equal to its sink), forward and backward
    in both ``deterministic`` modes; a ``requires_grad`` sink gets its
    gradient in its own type. Every other option (descales, with ``qv`` or
    without) raises NotImplementedError (ROADMAP.md queue A, item 7)."""
    reject_unsupported(
        "flash_attn_func", roadmap_item="queue A, item 7", dropout_p=dropout_p,
        dropout_rng=dropout_rng, q_descale=q_descale, k_descale=k_descale,
        v_descale=v_descale, score_mod=score_mod, mask_mod=mask_mod,
        aux_tensors=aux_tensors)
    if qv is not None:
        # one differentiable concatenation ahead of the kernels, as JAX's
        # autodiff sees it
        q = torch.cat([q, qv], dim=-1)
        k = torch.cat([k, v], dim=-1)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    window_size = normalize_window(tuple(window_size))
    band = dict(window_size=window_size, sink_token_length=sink_token_length,
                attention_chunk=attention_chunk)
    out, lse = _FlashAttn.apply(q, k, v, alibi_slopes, learnable_sink,
                                softmax_scale, causal, deterministic, band,
                                softcap)
    if not return_attn_probs:
        return out
    with torch.no_grad():
        s_dmask = _reconstruct_s_dmask(q, k, lse, softmax_scale, causal,
                                       **band, softcap=softcap,
                                       alibi_slopes=alibi_slopes)
    return out, lse, s_dmask


class _FlashAttnVarlen(torch.autograd.Function):
    """out, lse = packed varlen attention; the forward is the persistent
    kernel (B7), or with ALiBi B6's forward (as JAX routes it), the
    backward the dK/dV + dQ kernels (B6), all under ``band`` (window_size
    and attention_chunk), the score map (``softcap``, ``alibi_slopes``) and
    the learnable sink, whose gradient is the backward's epilogue.
    ``meta`` holds the work lists of both; the lse is an inspection output
    whose cotangent is dropped, as in JAX, and the slopes' gradient is
    zero."""

    @staticmethod
    def forward(ctx, q, k, v, alibi_slopes, learnable_sink, cu_seqlens_q,
                cu_seqlens_k, seqused_q, seqused_k, meta, max_seqlen_q,
                max_seqlen_k, softmax_scale, causal, band, softcap):
        args = (cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
                seqused_q, seqused_k, softmax_scale, causal)
        score = dict(softcap=softcap, alibi_slopes=alibi_slopes)
        fwd = (flash_attention_varlen_fwd if alibi_slopes is not None
               else flash_attention_varlen_fwd_persistent)
        out, lse = fwd(q, k, v, *args, meta=meta, **band, **score,
                       learnable_sink=learnable_sink)
        ctx.save_for_backward(q, k, v, out, lse, alibi_slopes,
                              learnable_sink)
        ctx.args, ctx.meta, ctx.band, ctx.softcap = args, meta, band, softcap
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, alibi_slopes, learnable_sink = ctx.saved_tensors
        sink = _sink_for_grad(ctx, learnable_sink)
        dq, dk, dv, *dsink = flash_attention_varlen_bwd(
            _kernel_layout(dout), q, k, v, out, lse, *ctx.args, meta=ctx.meta,
            **ctx.band, softcap=ctx.softcap, alibi_slopes=alibi_slopes,
            learnable_sink=sink)
        return (dq, dk, dv, _slopes_grad(ctx, alibi_slopes),
                dsink[0].to(sink.dtype) if dsink else None) + (None,) * 11


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

    ``window_size`` (left, right; -1 or None for no bound) masks both
    routes as in JAX, and ``attention_chunk`` the dense one (each sequence
    as the dense functions mask a batch row; forward and backward, the
    kernels' band instantiations). The varlen routes take no sink tokens,
    as in JAX. ``softcap`` caps the paged route's scores (B8's score
    instantiation, forward only) and, with ``block_table`` and no ``qv``,
    ``q_descale``, ``k_descale`` and ``v_descale`` ((batch, nheads_k) fp32,
    a missing one counting as ones) over pages of q's type or of 1-byte
    codes (float8_e4m3fn, int8): the scores are scaled by q_descale ·
    k_descale before the cap and the output by v_descale, in q's type, as
    JAX's B8 (flash_varlen_paged.py:225-241, :276-277); ``learnable_sink``
    ((nheads,), one logit a query head, dispatch/sink.py) on both routes and
    both paged kernels, differentiable on the dense route (its gradient in
    its own type); the dense route takes softcap and
    ``alibi_slopes`` ((nheads,) or (batch, nheads) fp32, each sequence its
    row) forward and backward (the kernels' score instantiations; ALiBi
    through B6's forward, as JAX routes it), the slopes' gradient zero. A
    window, softcap or descales with ``qv``, dropout, descales on the dense
    route, an fp8 q, and ``qv`` without ``block_table``, raise
    NotImplementedError (ROADMAP.md queue A, item
    7). On the card both routes take head dims 64, 80, 96, 128 and 256
    (HEAD_DIMS). JAX's paged route drops
    ``attention_chunk`` and ``alibi_slopes``
    without a word (flash_attn_tpu/interface.py:447-456); here both raise
    (ROADMAP.md queue C)."""
    window_size = normalize_window(tuple(window_size))
    if block_table is not None and alibi_slopes is not None:
        raise NotImplementedError(
            "flash_attn_varlen_func: alibi_slopes with block_table is not "
            "ported: the JAX package's paged route drops the slopes without "
            "a word (flash_attn_tpu/interface.py:447-456), so that a "
            "prefix-cached ALiBi model there attends without positions "
            "(ROADMAP.md queue C)")
    reject_unsupported(
        "flash_attn_varlen_func", roadmap_item="queue A, item 7",
        dropout_p=dropout_p,
        window_size=window_size if qv is not None else (None, None),
        softcap=softcap if qv is not None else 0.0,
        attention_chunk=attention_chunk if block_table is not None else 0,
        dropout_rng=dropout_rng, qv=qv if block_table is None else None)
    descaled = any(x is not None for x in (q_descale, k_descale, v_descale))
    if descaled and (block_table is None or qv is not None):
        raise NotImplementedError(
            "flash_attn_varlen_func: descales are ported on the paged route "
            "without qv (B8) alone; the dense route's and B8p's are not "
            "ported yet (ROADMAP.md queue A, item 7)")
    if q.element_size() == 1:
        raise NotImplementedError(
            f"flash_attn_varlen_func: a {q.dtype} q is not ported yet (fp8 "
            "q/k/v are ROADMAP.md queue A, item 7)")
    if block_table is not None:
        if scheduler_metadata is not None:
            raise NotImplementedError(
                "flash_attn_varlen_func: scheduler_metadata with block_table "
                "is not ported yet (ROADMAP.md queue A, item 7)")
        require_no_grad("flash_attn_varlen_func", q, k, v, qv,
                        learnable_sink)
        if seqused_k is None:
            seqused_k = cu_seqlens_k[1:] - cu_seqlens_k[:-1]
        if qv is not None:
            out, lse = flash_attention_paged_prefill_varlen(
                q, k, v, cu_seqlens_q, int(max_seqlen_q), seqused_k,
                block_table, seqused_q=seqused_q, qv=qv,
                softmax_scale=softmax_scale, causal=causal,
                learnable_sink=learnable_sink)
            return (out, lse) if return_attn_probs else out
        qk_descale, v_scale = combined_descales(
            cu_seqlens_q.shape[0] - 1, k.shape[1], q_descale, k_descale,
            v_descale, q.device)
        out, lse = flash_attention_varlen_paged_fwd(
            q, k, v, cu_seqlens_q, int(max_seqlen_q), seqused_k, block_table,
            seqused_q=seqused_q, softmax_scale=softmax_scale, causal=causal,
            window_size=window_size, softcap=softcap, qk_descale=qk_descale,
            v_descale=v_scale, learnable_sink=learnable_sink)
        return (out, lse) if return_attn_probs else out
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    meta = None
    if scheduler_metadata is not None:
        if (scheduler_metadata.block_q, scheduler_metadata.block_k) != (
                FWD_TILE.block_q, FWD_TILE.block_k):
            raise ValueError(
                "flash_attn_varlen_func: scheduler_metadata tiles "
                f"{scheduler_metadata.block_q} x {scheduler_metadata.block_k}"
                f", the forward's are {FWD_TILE}")
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
    band = dict(window_size=window_size, attention_chunk=attention_chunk)
    meta = varlen_meta(q, k, cu_seqlens_q, cu_seqlens_k, int(max_seqlen_q),
                       int(max_seqlen_k), seqused_q, seqused_k, causal, meta,
                       **band)
    out, lse = _FlashAttnVarlen.apply(
        q, k, v, alibi_slopes, learnable_sink, cu_seqlens_q, cu_seqlens_k,
        seqused_q, seqused_k, meta, int(max_seqlen_q), int(max_seqlen_k),
        softmax_scale, causal, band, softcap)
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
