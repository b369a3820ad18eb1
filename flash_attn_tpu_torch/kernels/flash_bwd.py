"""Dense attention backward: the CUDA kernels of ``csrc/flash_bwd.cu`` (wgmma
and TMA, csrc/sm90.cuh) and their plain PyTorch versions.

Port of flash_attn_tpu/kernels/flash_bwd.py ``flash_attention_bwd`` (:362,
the deterministic dK/dV + dQ kernels) and flash_bwd_fused.py
``flash_attention_bwd_fused`` (:318) / ``flash_attention_bwd_auto`` (:601);
the causal diagonal launch of flash_bwd_split.py is the kernels' masked
phase. The band masks (``window_size``, ``attention_chunk``,
``sink_token_length``: flash_bwd.py:103-139, flash_bwd_fused.py:363-383,
dispatch/band.py) run in the kernels' band instantiations, which walk only
the tiles of the band; a call without a band (or whose window reaches
every key) runs the band-free ones, the kernels of the earlier releases
bit for bit. ``softcap`` and ``alibi_slopes`` (flash_bwd.py:38-154
``_scores_log2``, dispatch/score.py) run in the kernels' score
instantiations, with or without a band: each rebuilt score is mapped as
the forward maps it and, under a cap, dS is multiplied by the tanh
derivative (flash_bwd.py:143-152); ALiBi changes no gradient of q, k or v.
Layout (b, h, s, d) as in the JAX kernels. delta = rowsum(dO * O),
an XLA op before the JAX kernels (flash_bwd.py:406-413), is the preprocess
kernel here; the fused path's final fp32 -> input-type cast of dQ stays a
torch op. With a ``learnable_sink`` the kernels run as they are (the lse
folds the sink in) and the sink's gradient is an epilogue of torch ops
over the preprocess kernel's delta (dispatch/sink.py sink_grad), as it is
an XLA epilogue in JAX (interface.py:185-200). v (and so out and dO) may
have a head dim of its own, 128 beside q's and k's 192 (HEAD_DIM_PAIRS:
DeepSeek's MLA trained without absorbing it), in instantiations of their
own (csrc/flash_bwd_192.cu) without the band and the score map, as JAX's
kernels take dv (flash_bwd.py:363-386, flash_bwd_fused.py:58-71). A tensor
on the CPU takes the plain versions; a CUDA tensor launches the kernels or
raises.
"""

import math
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.band import (
    band_args,
    band_valid,
    has_band,
    reach_window,
)
from flash_attn_tpu_torch.dispatch.config import (
    DENSE_BWD_ROW_PAD,
    DENSE_HEAD_DIMS,
    check_head_dims,
    dense_bwd_tiles,
    refuse_dv_forms,
)
from flash_attn_tpu_torch.dispatch.score import (
    alibi_bias,
    has_score,
    slope_args,
    slopes_bh,
)
from flash_attn_tpu_torch.dispatch.sink import sink_arg, sink_grad
from flash_attn_tpu_torch.kernels import _build

# Kernel launches since the last reset (plain calls not counted): both
# paths run fa_bwd_preprocess first; the deterministic path then runs
# fa_bwd_dkdv and fa_bwd_dq, the fused path one fa_bwd_dkdv that adds dQ
# into an fp32 buffer. The *_band and *_score counters count the band and
# the score instantiations' launches among them, the *_dv ones those at a v
# head dim of its own (192 / 128).
launches_preprocess = 0
launches_dkdv = 0
launches_dq = 0
launches_fused = 0
launches_dkdv_band = 0
launches_dq_band = 0
launches_fused_band = 0
launches_dkdv_score = 0
launches_dq_score = 0
launches_fused_score = 0
launches_preprocess_dv = 0
launches_dkdv_dv = 0
launches_dq_dv = 0
launches_fused_dv = 0

Window = Tuple[Optional[int], Optional[int]]


def bwd_preprocess_plain(do, out, lse, row_pad: int = 1):
    """What ``fa_bwd_preprocess`` computes: delta = rowsum(dO * O) in fp32
    and lse2 = lse * log2(e) (+inf where lse is -inf, so that P = 2^(S *
    scale * log2(e) - lse2) is 0 there), both (b, h, sq_pad) with sq_pad
    the next multiple of ``row_pad``; padded rows hold delta 0 and lse2
    +inf. do/out (b, h, sq, dv), lse (b, h, sq) natural-log."""
    sq = do.shape[2]
    pad = -(-sq // row_pad) * row_pad - sq
    delta = (do.float() * out.float()).sum(-1)
    lse2 = torch.where(lse == float("-inf"), float("inf"),
                       lse.float() * math.log2(math.e))
    return (torch.nn.functional.pad(delta, (0, pad), value=0.0),
            torch.nn.functional.pad(lse2, (0, pad), value=float("inf")))


def flash_attention_bwd_plain(do, q, k, v, out, lse,
                              softmax_scale: Optional[float] = None,
                              causal: bool = False,
                              window_size: Window = (None, None),
                              sink_token_length: int = 0,
                              attention_chunk: int = 0, softcap: float = 0.0,
                              alibi_slopes=None, learnable_sink=None):
    """Gradients of attention in fp32 from the saved forward. q (b, h, sq,
    d), do/out (b, h, sq, dv), k (b, h_k, sk, d), v (b, h_k, sk, dv), lse
    (b, h, sq) natural-log, -inf
    for rows that see no key; the scores mapped by ``softcap`` and
    ``alibi_slopes`` ((h,) or (b, h)) as the forward maps them
    (dispatch/score.py), then masked by the causal bound and the band
    (dispatch/band.py band_valid); under a cap dS is multiplied by the tanh
    derivative, 1 - tanh(s / softcap)^2 (JAX's ds_chain). Returns (dq, dk,
    dv) in q's, k's and v's types and shapes; a GQA group's gradients sum
    into its KV head; with ``learnable_sink`` (h,) (folded into lse by the
    forward) also its gradient, (h,) fp32."""
    sink = sink_arg("flash_bwd", learnable_sink, q.shape[1], q.device)
    b, h, sq, d = q.shape
    h_k, sk = k.shape[1], k.shape[2]
    group = h // h_k
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    dtanh = None
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        dtanh = 1.0 - t * t
        s = t * softcap
    slopes = slopes_bh(alibi_slopes, b, h, q.device)
    if slopes is not None:
        s = s + slopes[..., None, None] * alibi_bias(rows, cols, sq, sk,
                                                     causal)
    if causal or has_band(causal, window_size, attention_chunk):
        valid = band_valid(rows, cols, sk - sq, causal, window_size,
                           sink_token_length, attention_chunk)
        s = s.masked_fill(~valid, float("-inf"))
    lse_safe = torch.where(torch.isfinite(lse), lse.float(), float("inf"))
    p = torch.exp(s - lse_safe[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = bwd_preprocess_plain(do, out, lse)[0][..., None]
    ds = p * (dp - delta)
    if dtanh is not None:
        ds = ds * dtanh
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = dk.unflatten(1, (h_k, group)).sum(2)
    dv = dv.unflatten(1, (h_k, group)).sum(2)
    grads = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if sink is None:
        return grads
    return grads + (sink_grad(sink, lse.float(), delta[..., 0], 1),)


def _strides(x):
    """(batch, seq, head) element strides of a (b, h, s, d) view."""
    return x.stride(0), x.stride(2), x.stride(1)


def bwd_preprocess(do, out, lse, dq_accum=None, d: Optional[int] = None):
    """The preprocess kernel: (delta, lse2) as
    ``bwd_preprocess_plain(do, out, lse, DENSE_BWD_ROW_PAD)``, reading dO
    and O once in their own type; with ``dq_accum`` ((b, sq, h, d) fp32,
    contiguous) given, it also zeroes it for the fused backward. do/out
    (b, h, sq, dv) with the head dim contiguous, lse (b, h, sq); ``d``: q's
    head dim (dv unless given). A tensor on the CPU takes the plain
    version. CUDA: bf16/fp16, (d, dv) in DENSE_HEAD_DIMS (at 192 / 128 the
    sum runs over dv's 128 columns, the clearing over d's 192)."""
    if do.device.type == "cpu":
        if dq_accum is not None:
            dq_accum.zero_()
        return bwd_preprocess_plain(do, out, lse, DENSE_BWD_ROW_PAD)
    b, h, sq, dv = do.shape
    d = dv if d is None else d
    if do.dtype not in (torch.bfloat16, torch.float16) \
            or out.shape != do.shape or lse.shape != (b, h, sq) or sq == 0:
        raise ValueError(
            f"bwd_preprocess kernel: do {tuple(do.shape)} {do.dtype}, out "
            f"{tuple(out.shape)}, lse {tuple(lse.shape)}; needs bf16/fp16 "
            f"and sq > 0")
    check_head_dims("bwd_preprocess", d, d, dv, DENSE_HEAD_DIMS)
    for name, x in (("do", do), ("out", out)):
        _build.check_operand("bwd_preprocess", name, x, do.dtype, do.device)
    if dq_accum is not None and (dq_accum.shape != (b, sq, h, d)
                                 or dq_accum.dtype != torch.float32
                                 or not dq_accum.is_contiguous()):
        raise ValueError("bwd_preprocess kernel: dq_accum must be a "
                         "contiguous (b, sq, h, d) fp32 tensor")
    lse = lse.float().contiguous()
    sq_pad = -(-sq // DENSE_BWD_ROW_PAD) * DENSE_BWD_ROW_PAD
    delta = torch.empty((b, h, sq_pad), dtype=torch.float32, device=do.device)
    lse2 = torch.empty_like(delta)
    global launches_preprocess, launches_preprocess_dv
    with torch.cuda.device(do.device):
        err = _build.load_library().fa_bwd_preprocess(
            do.data_ptr(), out.data_ptr(), lse.data_ptr(), lse2.data_ptr(),
            delta.data_ptr(),
            None if dq_accum is None else dq_accum.data_ptr(),
            b, sq, sq_pad, h, d, dv, *_strides(do), *_strides(out),
            int(do.dtype == torch.bfloat16),
            torch.cuda.current_stream(do.device).cuda_stream)
        _build.check(err, "fa_bwd_preprocess")
        launches_preprocess += 1
        launches_preprocess_dv += dv != d
    return delta, lse2


def flash_attention_bwd(do, q, k, v, out, lse,
                        softmax_scale: Optional[float] = None,
                        causal: bool = False, deterministic: bool = True,
                        window_size: Window = (None, None),
                        sink_token_length: int = 0,
                        attention_chunk: int = 0, softcap: float = 0.0,
                        alibi_slopes=None, learnable_sink=None):
    """dq, dk, dv for attention saved by ``flash_attention_fwd``. Layouts as
    :func:`flash_attention_bwd_plain`, any strides with the head dim
    contiguous and 16-byte aligned starts and strides (the kernels load
    tiles by TMA). The preprocess kernel computes delta first; then
    ``deterministic`` runs the dK/dV kernel and the dQ kernel, each writing
    its gradient once; otherwise one fused launch adds dQ into an fp32
    buffer with atomics (run-to-run bits may differ). Returns (b, h, s, d)
    views of (b, s, h, d) tensors in the inputs' type (dv's (b, h_k, sk,
    dv)). CUDA: bf16/fp16, d = dv in HEAD_DIMS (80 on the tile plan of 96,
    256 on blocks of 64 rows, dense_bwd_tiles) or (d, dv) = (192, 128)
    (DENSE_HEAD_DIMS; neither the band nor the score map there,
    NotImplementedError), h % h_k == 0. ``window_size`` (left, right) with
    None for no bound, ``sink_token_length`` and ``attention_chunk`` as in
    the forward
    (dispatch/band.py): with a band, both paths launch the kernels' band
    instantiations. ``softcap`` (0: none) and ``alibi_slopes`` ((h,) or
    (b, h), read in fp32) as the forward took them (dispatch/score.py):
    with either, both paths launch the kernels' score instantiations.
    ``learnable_sink`` (h,): the forward's sink, whose gradient, (h,) fp32
    from the preprocess's delta and lse (dispatch/sink.py sink_grad),
    follows dv in the result."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            do, q, k, v, out, lse, softmax_scale, causal, window_size,
            sink_token_length, attention_chunk, softcap, alibi_slopes,
            learnable_sink)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    b, h, sq, d = q.shape
    bk_, h_k, sk, dk_ = k.shape
    dv_ = v.shape[-1]
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"flash_bwd kernel: dtype {q.dtype} (bf16/fp16 only)")
    check_head_dims("flash_bwd", d, dk_, dv_, DENSE_HEAD_DIMS)
    if bk_ != b or h % h_k or v.shape[:3] != k.shape[:3] \
            or do.shape != (b, h, sq, dv_) or out.shape != do.shape \
            or lse.shape != (b, h, sq):
        raise ValueError(
            f"flash_bwd kernel: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, do {tuple(do.shape)}, out "
            f"{tuple(out.shape)}, lse {tuple(lse.shape)}")
    if b > 65535 or h > 65535:
        raise ValueError("flash_bwd kernel: batch and heads must be <= 65535")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do), ("out", out)):
        _build.check_operand("flash_bwd", name, x, q.dtype, q.device)
    sink = sink_arg("flash_bwd", learnable_sink, h, q.device)
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    window = reach_window(window_size, causal, sq, sk)
    band = has_band(causal, window, attention_chunk)
    score = has_score(softcap, alibi_slopes)
    refuse_dv_forms("flash_bwd", d, dv_, band, score)
    # Gradients are allocated (b, s, h, d) so that the public bshd views
    # are contiguous; they are returned as their (b, h, s, d) views.
    alloc = torch.zeros if sq == 0 or sk == 0 else torch.empty
    dk = alloc((b, sk, h_k, d), dtype=k.dtype, device=q.device)
    dv = alloc((b, sk, h_k, dv_), dtype=v.dtype, device=q.device)
    dq = alloc((b, sq, h, d), dtype=q.dtype, device=q.device)
    if sq == 0 or sk == 0:  # out is 0: so is dsink
        grads = dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
        return grads if sink is None else grads + (torch.zeros_like(sink),)
    # the fused path's fp32 dQ, zeroed by the preprocess kernel
    dq_accum = None if deterministic else torch.empty(
        (b, sq, h, d), dtype=torch.float32, device=q.device)
    delta, lse2 = bwd_preprocess(do, out, lse, dq_accum, d)
    sq_pad = delta.shape[-1]
    slopes = slopes_bh(alibi_slopes, b, h, q.device)
    banded = (*band_args(causal, window, sink_token_length, attention_chunk),
              int(band), float(softcap), *slope_args(slopes))
    dkdv_tile, dq_tile = dense_bwd_tiles(d, dv_)
    own_dv = dv_ != d
    lib = _build.load_library()
    is_bf16 = int(q.dtype == torch.bfloat16)
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse2.data_ptr(), delta.data_ptr())
    strides = (*_strides(q), *_strides(k), *_strides(v), *_strides(do))
    global launches_dkdv, launches_dq, launches_fused
    global launches_dkdv_band, launches_dq_band, launches_fused_band
    global launches_dkdv_score, launches_dq_score, launches_fused_score
    global launches_dkdv_dv, launches_dq_dv, launches_fused_dv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_bwd_dkdv(
            *operands, dk.data_ptr(), dv.data_ptr(),
            None if dq_accum is None else dq_accum.data_ptr(),
            b, sq, sk, sq_pad, h, h_k, d, dv_, dkdv_tile.block_q,
            dkdv_tile.block_k, *strides,
            dk.stride(0), dk.stride(1), dk.stride(2),
            dv.stride(0), dv.stride(1), dv.stride(2),
            scale, int(causal), *banded, is_bf16, stream)
        _build.check(err, "fa_bwd_dkdv")
        if deterministic:
            launches_dkdv += 1
            launches_dkdv_band += band
            launches_dkdv_score += score
            launches_dkdv_dv += own_dv
            err = lib.fa_bwd_dq(
                *operands, dq.data_ptr(), b, sq, sk, sq_pad, h, h_k, d, dv_,
                dq_tile.block_q, dq_tile.block_k, *strides,
                dq.stride(0), dq.stride(1), dq.stride(2),
                scale, int(causal), *banded, is_bf16, stream)
            _build.check(err, "fa_bwd_dq")
            launches_dq += 1
            launches_dq_band += band
            launches_dq_score += score
            launches_dq_dv += own_dv
        else:
            launches_fused += 1
            launches_fused_band += band
            launches_fused_score += score
            launches_fused_dv += own_dv
            dq.copy_(dq_accum)
    grads = dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    if sink is None:
        return grads
    return grads + (sink_grad(sink, lse.float(), delta[..., :sq], 1),)
