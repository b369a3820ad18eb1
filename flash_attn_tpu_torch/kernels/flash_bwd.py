"""Dense attention backward: the CUDA kernels of ``csrc/flash_bwd.cu`` (wgmma
and TMA, csrc/bwd_sm90.cuh) and their plain PyTorch versions.

Port of flash_attn_tpu/kernels/flash_bwd.py ``flash_attention_bwd`` (:362,
the deterministic dK/dV + dQ kernels) and flash_bwd_fused.py
``flash_attention_bwd_fused`` (:318) / ``flash_attention_bwd_auto`` (:601);
the causal diagonal launch of flash_bwd_split.py is the kernels' masked
phase. Layout (b, h, s, d) as in the JAX kernels. delta = rowsum(dO * O),
an XLA op before the JAX kernels (flash_bwd.py:406-413), is the preprocess
kernel here; the fused path's final fp32 -> input-type cast of dQ stays a
torch op. A tensor on the CPU takes the plain versions; a CUDA tensor
launches the kernels or raises.
"""

import math
from typing import Optional

import torch

from flash_attn_tpu_torch.dispatch.config import (
    DENSE_BWD_ROW_PAD,
    DENSE_BWD_TILES,
    KERNEL_HEAD_DIMS,
)
from flash_attn_tpu_torch.kernels import _build

# Kernel launches since the last reset (plain calls not counted): both
# paths run fa_bwd_preprocess first; the deterministic path then runs
# fa_bwd_dkdv and fa_bwd_dq, the fused path one fa_bwd_dkdv that adds dQ
# into an fp32 buffer.
launches_preprocess = 0
launches_dkdv = 0
launches_dq = 0
launches_fused = 0


def bwd_preprocess_plain(do, out, lse, row_pad: int = 1):
    """What ``fa_bwd_preprocess`` computes: delta = rowsum(dO * O) in fp32
    and lse2 = lse * log2(e) (+inf where lse is -inf, so that P = 2^(S *
    scale * log2(e) - lse2) is 0 there), both (b, h, sq_pad) with sq_pad
    the next multiple of ``row_pad``; padded rows hold delta 0 and lse2
    +inf. do/out (b, h, sq, d), lse (b, h, sq) natural-log."""
    sq = do.shape[2]
    pad = -(-sq // row_pad) * row_pad - sq
    delta = (do.float() * out.float()).sum(-1)
    lse2 = torch.where(lse == float("-inf"), float("inf"),
                       lse.float() * math.log2(math.e))
    return (torch.nn.functional.pad(delta, (0, pad), value=0.0),
            torch.nn.functional.pad(lse2, (0, pad), value=float("inf")))


def flash_attention_bwd_plain(do, q, k, v, out, lse,
                              softmax_scale: Optional[float] = None,
                              causal: bool = False):
    """Gradients of attention in fp32 from the saved forward. do/q/out
    (b, h, sq, d), k/v (b, h_k, sk, d), lse (b, h, sq) natural-log, -inf
    for rows that see no key. Returns (dq, dk, dv) in q's, k's and v's
    types and shapes; a GQA group's gradients sum into its KV head."""
    b, h, sq, d = q.shape
    h_k, sk = k.shape[1], k.shape[2]
    group = h // h_k
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows + (sk - sq), float("-inf"))
    lse_safe = torch.where(torch.isfinite(lse), lse.float(), float("inf"))
    p = torch.exp(s - lse_safe[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = bwd_preprocess_plain(do, out, lse)[0][..., None]
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = dk.unflatten(1, (h_k, group)).sum(2)
    dv = dv.unflatten(1, (h_k, group)).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(x):
    """(batch, seq, head) element strides of a (b, h, s, d) view."""
    return x.stride(0), x.stride(2), x.stride(1)


def bwd_preprocess(do, out, lse, dq_accum=None):
    """The preprocess kernel: (delta, lse2) as
    ``bwd_preprocess_plain(do, out, lse, DENSE_BWD_ROW_PAD)``, reading dO
    and O once in their own type; with ``dq_accum`` ((b, sq, h, d) fp32,
    contiguous) given, it also zeroes it for the fused backward. do/out
    (b, h, sq, d) with the head dim contiguous, lse (b, h, sq). A tensor on
    the CPU takes the plain version. CUDA: bf16/fp16, d in {64, 128}."""
    if do.device.type == "cpu":
        if dq_accum is not None:
            dq_accum.zero_()
        return bwd_preprocess_plain(do, out, lse, DENSE_BWD_ROW_PAD)
    b, h, sq, d = do.shape
    if do.dtype not in (torch.bfloat16, torch.float16) \
            or d not in KERNEL_HEAD_DIMS or out.shape != do.shape \
            or lse.shape != (b, h, sq) or sq == 0:
        raise ValueError(
            f"bwd_preprocess kernel: do {tuple(do.shape)} {do.dtype}, out "
            f"{tuple(out.shape)}, lse {tuple(lse.shape)}; needs bf16/fp16, "
            f"d in {KERNEL_HEAD_DIMS} and sq > 0")
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
    global launches_preprocess
    with torch.cuda.device(do.device):
        err = _build.load_library().fa_bwd_preprocess(
            do.data_ptr(), out.data_ptr(), lse.data_ptr(), lse2.data_ptr(),
            delta.data_ptr(),
            None if dq_accum is None else dq_accum.data_ptr(),
            b, sq, sq_pad, h, d, *_strides(do), *_strides(out),
            int(do.dtype == torch.bfloat16),
            torch.cuda.current_stream(do.device).cuda_stream)
        _build.check(err, "fa_bwd_preprocess")
        launches_preprocess += 1
    return delta, lse2


def flash_attention_bwd(do, q, k, v, out, lse,
                        softmax_scale: Optional[float] = None,
                        causal: bool = False, deterministic: bool = True):
    """dq, dk, dv for attention saved by ``flash_attention_fwd``. Layouts as
    :func:`flash_attention_bwd_plain`, any strides with the head dim
    contiguous and 16-byte aligned starts and strides (the kernels load
    tiles by TMA). The preprocess kernel computes delta first; then
    ``deterministic`` runs the dK/dV kernel and the dQ kernel, each writing
    its gradient once; otherwise one fused launch adds dQ into an fp32
    buffer with atomics (run-to-run bits may differ). Returns (b, h, s, d)
    views of (b, s, h, d) tensors in the inputs' type. CUDA: bf16/fp16, d
    in {64, 128}, h % h_k == 0."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(do, q, k, v, out, lse,
                                         softmax_scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    b, h, sq, d = q.shape
    bk_, h_k, sk, dk_ = k.shape
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"flash_bwd kernel: dtype {q.dtype} (bf16/fp16 only)")
    if d not in KERNEL_HEAD_DIMS or dk_ != d or v.shape != k.shape:
        raise ValueError(
            f"flash_bwd kernel: head dims q {d}, k {dk_}, v {v.shape[-1]}; "
            f"needs equal dims in {KERNEL_HEAD_DIMS}")
    if bk_ != b or h % h_k or do.shape != q.shape or out.shape != q.shape \
            or lse.shape != (b, h, sq):
        raise ValueError(
            f"flash_bwd kernel: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"do {tuple(do.shape)}, out {tuple(out.shape)}, "
            f"lse {tuple(lse.shape)}")
    if b > 65535 or h > 65535:
        raise ValueError("flash_bwd kernel: batch and heads must be <= 65535")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do), ("out", out)):
        _build.check_operand("flash_bwd", name, x, q.dtype, q.device)
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    # Gradients are allocated (b, s, h, d) so that the public bshd views
    # are contiguous; they are returned as their (b, h, s, d) views.
    alloc = torch.zeros if sq == 0 or sk == 0 else torch.empty
    dk = alloc((b, sk, h_k, d), dtype=k.dtype, device=q.device)
    dv = alloc((b, sk, h_k, d), dtype=v.dtype, device=q.device)
    dq = alloc((b, sq, h, d), dtype=q.dtype, device=q.device)
    if sq == 0 or sk == 0:
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    # the fused path's fp32 dQ, zeroed by the preprocess kernel
    dq_accum = None if deterministic else torch.empty(
        (b, sq, h, d), dtype=torch.float32, device=q.device)
    delta, lse2 = bwd_preprocess(do, out, lse, dq_accum)
    sq_pad = delta.shape[-1]
    dkdv_tile, dq_tile = DENSE_BWD_TILES
    lib = _build.load_library()
    is_bf16 = int(q.dtype == torch.bfloat16)
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse2.data_ptr(), delta.data_ptr())
    strides = (*_strides(q), *_strides(k), *_strides(v), *_strides(do))
    global launches_dkdv, launches_dq, launches_fused
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_bwd_dkdv(
            *operands, dk.data_ptr(), dv.data_ptr(),
            None if dq_accum is None else dq_accum.data_ptr(),
            b, sq, sk, sq_pad, h, h_k, d, dkdv_tile.block_q,
            dkdv_tile.block_k, *strides,
            dk.stride(0), dk.stride(1), dk.stride(2),
            dv.stride(0), dv.stride(1), dv.stride(2),
            scale, int(causal), is_bf16, stream)
        _build.check(err, "fa_bwd_dkdv")
        if deterministic:
            launches_dkdv += 1
            err = lib.fa_bwd_dq(
                *operands, dq.data_ptr(), b, sq, sk, sq_pad, h, h_k, d,
                dq_tile.block_q, dq_tile.block_k, *strides,
                dq.stride(0), dq.stride(1), dq.stride(2),
                scale, int(causal), is_bf16, stream)
            _build.check(err, "fa_bwd_dq")
            launches_dq += 1
        else:
            launches_fused += 1
            dq.copy_(dq_accum)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
