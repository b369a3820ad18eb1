"""Dense attention backward: the CUDA kernels of ``csrc/flash_bwd.cu`` and
their plain PyTorch version.

Port of flash_attn_tpu/kernels/flash_bwd.py ``flash_attention_bwd`` (:362,
the deterministic dK/dV + dQ kernels) and flash_bwd_fused.py
``flash_attention_bwd_fused`` (:318) / ``flash_attention_bwd_auto`` (:601);
the causal diagonal launch of flash_bwd_split.py is the kernels' masked
phase. Layout (b, h, s, d) as in the JAX kernels. delta = rowsum(dO * O)
and the fused path's dQ cast stay torch ops, as they were XLA ops in JAX.
A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernels or raises.
"""

import math
from typing import Optional

import torch

from flash_attn_tpu_torch.dispatch.config import KERNEL_HEAD_DIMS, get_bwd_config
from flash_attn_tpu_torch.kernels import _build

# Kernel launches since the last reset (plain calls not counted): the
# deterministic path runs fa_bwd_dkdv then fa_bwd_dq, the fused path one
# fa_bwd_dkdv with atomic dQ.
launches_dkdv = 0
launches_dq = 0
launches_fused = 0


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
    delta = (dof * out.float()).sum(-1, keepdim=True)
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


def flash_attention_bwd(do, q, k, v, out, lse,
                        softmax_scale: Optional[float] = None,
                        causal: bool = False, deterministic: bool = True):
    """dq, dk, dv for attention saved by ``flash_attention_fwd``. Layouts as
    :func:`flash_attention_bwd_plain`, any strides with the head dim
    contiguous. ``deterministic`` runs the dK/dV kernel and then the dQ
    kernel, each writing its gradient once; otherwise one fused launch adds
    dQ into an fp32 buffer with atomics (run-to-run bits may differ).
    Returns (b, h, s, d) views of (b, s, h, d) tensors in the inputs' type.
    CUDA: bf16/fp16, d in {64, 128}, h % h_k == 0."""
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
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _build.check_operand("flash_bwd", name, x, q.dtype, q.device)
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    lse = lse.float().contiguous()
    delta = (do.float() * out.float()).sum(-1).contiguous()  # (b, h, sq)
    # Gradients are allocated (b, s, h, d) so that the public bshd views
    # are contiguous; they are returned as their (b, h, s, d) views.
    alloc = torch.zeros if sq == 0 or sk == 0 else torch.empty
    dk = alloc((b, sk, h_k, d), dtype=k.dtype, device=q.device)
    dv = alloc((b, sk, h_k, d), dtype=v.dtype, device=q.device)
    dq = alloc((b, sq, h, d), dtype=q.dtype, device=q.device)
    if sq == 0 or sk == 0:
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    dq_accum = None if deterministic else torch.zeros(
        (b, sq, h, d), dtype=torch.float32, device=q.device)
    dkdv_tile, dq_tile = get_bwd_config(d)
    lib = _build.load_library()
    is_bf16 = int(q.dtype == torch.bfloat16)
    global launches_dkdv, launches_dq, launches_fused
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if dq_accum is None else dq_accum.data_ptr(),
            b, sq, sk, h, h_k, d, dkdv_tile.block_q, dkdv_tile.block_k,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do),
            dk.stride(0), dk.stride(1), dk.stride(2),
            dv.stride(0), dv.stride(1), dv.stride(2),
            scale, int(causal), is_bf16, int(not deterministic), stream)
        _build.check(err, "fa_bwd_dkdv")
        if deterministic:
            launches_dkdv += 1
            err = lib.fa_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                b, sq, sk, h, h_k, d, dq_tile.block_q, dq_tile.block_k,
                *_strides(q), *_strides(k), *_strides(v), *_strides(do),
                dq.stride(0), dq.stride(1), dq.stride(2),
                scale, int(causal), is_bf16, stream)
            _build.check(err, "fa_bwd_dq")
            launches_dq += 1
        else:
            launches_fused += 1
            dq.copy_(dq_accum)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
