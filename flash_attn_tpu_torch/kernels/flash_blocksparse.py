"""Block-sparse attention (B10): the CUDA kernels of
``csrc/flash_blocksparse.cu`` and their plain PyTorch versions.

Port of flash_attn_tpu/kernels/flash_blocksparse.py: ``blockmask_to_kv_indices``
(:35), ``flash_attention_blocksparse_fwd`` (:162, kernel ``_bs_kernel`` :46),
``flash_attention_blocksparse_bwd`` (:367, kernel ``_bs_bwd_kernel`` :225)
and the differentiable ``flash_attention_blocksparse`` (:457, a
``custom_vjp``) as a ``torch.autograd.Function``.

JAX's semantics, kept: q tile i of ``bq`` rows attends the key tiles
``kv_indices[i, :kv_num[i]]`` of ``bk`` keys each, in full, intersected
with the bottom-right causal mask (key c <= row r + sk - sq) when
``causal``; entries past ``kv_num[i]`` are ignored and a tile listed twice
counts twice (the kernels walk the list). ``bq = min(block_q,
next_pow2(sq))``; ``bk`` is ``block_k`` halved while above 128 and not
dividing sk (:179-183), and the lists are read in those units
(:func:`effective_tiles`). A row that sees no key gives out 0, lse -inf and
zero gradients. The port also skips an index outside [0, sk / bk), which
JAX would read out of bounds.

Layout (h, s, d) for one batch entry, as in JAX (whose callers
``jax.vmap`` it), or (b, h, s, d): ``torch.func.vmap`` cannot map through a
ctypes launch, so the batch is a leading dim, the mask either shared
((nq,), (nq, nk): JAX's ``in_axes=(0, 0, 0, None, None)``) or per entry
((b, nq), (b, nq, nk)). There is no ``interpret``: a tensor on the CPU
takes the plain version, a CUDA tensor launches the kernels or raises.
delta = rowsum(dO * O) and the dK/dV kernel's inverse lists are built with
torch ops on the device (JAX's delta is an XLA op, :403), with no read
back to the host.
"""

import math
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.config import KERNEL_HEAD_DIMS
from flash_attn_tpu_torch.kernels import _build

__all__ = ["blockmask_to_kv_indices", "flash_attention_blocksparse",
           "flash_attention_blocksparse_bwd", "flash_attention_blocksparse_fwd"]

# Kernel launches since the last reset (plain calls not counted).
launches_fwd = 0
launches_dkdv = 0
launches_dq = 0

_TILE = 64  # rows and keys of the kernels' tiles (fwd_tile.cuh, bwd_tile.cuh)
_ITEM7 = "ROADMAP.md queue A, item 7"


def blockmask_to_kv_indices(blockmask):
    """(..., nq, nk) bool -> (kv_num (..., nq) int32, kv_indices (..., nq,
    nk) int32): each row's listed tiles first, in ascending order (a stable
    argsort of ~blockmask, as JAX's :35-43)."""
    order = torch.argsort((~blockmask).to(torch.int8), dim=-1, stable=True)
    return blockmask.sum(-1, dtype=torch.int32), order.to(torch.int32)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def effective_tiles(sq: int, sk: int, block_q: int = 512,
                    block_k: int = 512) -> Tuple[int, int]:
    """(bq, bk): the rows of a q tile of ``kv_num`` and the keys of a tile
    of ``kv_indices``, by JAX's rule (:179-183): bq = min(block_q,
    next_pow2(sq)); bk = block_k halved while above 128 and not dividing
    sk. Raises ValueError where JAX asserts that bk divides sk."""
    bq = min(block_q, _next_pow2(sq))
    bk = block_k
    while bk > 128 and sk % bk:
        bk //= 2
    if sk % bk:
        raise ValueError(
            f"flash_blocksparse: seqlen_k {sk} is not a multiple of the key "
            f"tile {bk} (block_k={block_k}, halved while above 128)")
    return bq, bk


def _check_bwd_shapes(sk: int, d: int, dv: int) -> None:
    if sk % 128 or d % 8 or dv % 8:
        raise ValueError(
            "flash_blocksparse backward: needs seqlen_k % 128 == 0 and head "
            f"dims that are multiples of 8 (JAX :399-400); got seqlen_k {sk},"
            f" head dims {d}, {dv}")


def _batched(q, k, v, kv_num, kv_indices, nq):
    """(b, h, s, d) views of q, k and v, the mask as (b, nq) and (b, nq,
    nl) views, and whether the inputs were one batch entry."""
    single = q.dim() == 3
    if single:
        q, k, v = q[None], k[None], v[None]
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_blocksparse: q, k, v must be (h, s, d) or "
                         f"(b, h, s, d); got {tuple(q.shape)}")
    b = q.shape[0]
    if kv_num.dim() not in (1, 2) or kv_indices.dim() != kv_num.dim() + 1 \
            or (single and kv_num.dim() != 1):
        raise ValueError(
            f"flash_blocksparse: kv_num {tuple(kv_num.shape)} and kv_indices "
            f"{tuple(kv_indices.shape)} must be (nq,) and (nq, nk), or per "
            "batch entry (b, nq) and (b, nq, nk)")
    if kv_num.dim() == 1:
        kv_num, kv_indices = kv_num[None], kv_indices[None]
    if kv_num.shape[0] not in (1, b) or kv_indices.shape[0] != kv_num.shape[0] \
            or kv_num.shape[1] < nq or kv_indices.shape[1] < nq:
        raise ValueError(
            f"flash_blocksparse: kv_num {tuple(kv_num.shape)} and kv_indices "
            f"{tuple(kv_indices.shape)} do not cover {nq} q tiles of "
            f"{b} batch entries")
    nl = kv_indices.shape[-1]
    kv_num = kv_num[:, :nq].expand(b, nq)
    kv_indices = kv_indices[:, :nq].expand(b, nq, nl)
    return q, k, v, kv_num, kv_indices, single


def _tile_counts(kv_num, kv_indices, nk: int):
    """(b, nq, nk) int64: how many times each q tile lists each key tile
    (entries past kv_num and indices outside [0, nk) not counted)."""
    b, nq, nl = kv_indices.shape
    idx = kv_indices.long()
    listed = (torch.arange(nl, device=idx.device) < kv_num[..., None].long()) \
        & (idx >= 0) & (idx < nk)
    counts = torch.zeros(b, nq, nk + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(-1, torch.where(listed, idx, nk), listed.long())
    return counts[..., :nk]


def _pair_weights(kv_num, kv_indices, sq, sk, bq, bk, causal, dtype):
    """(b, 1, sq, sk): the times each (row, key) pair is attended."""
    w = _tile_counts(kv_num, kv_indices, sk // bk).to(dtype)
    w = w.repeat_interleave(bq, 1)[:, :sq].repeat_interleave(bk, 2)
    if causal:
        rows = torch.arange(sq, device=w.device)[:, None]
        cols = torch.arange(sk, device=w.device)[None, :]
        w = w.masked_fill(cols > rows + (sk - sq), 0)
    return w[:, None]


def _scale(q, softmax_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if softmax_scale is None \
        else softmax_scale


def flash_attention_blocksparse_fwd_plain(
        q, k, v, kv_num, kv_indices, softmax_scale: Optional[float] = None,
        causal: bool = False, block_q: int = 512, block_k: int = 512,
        upcast: bool = True):
    """Full-matrix block-sparse attention with torch ops, in fp32 (the
    inputs' type with ``upcast=False``: the low-precision reference of the
    2x rule, differentiable through autograd). Any head dims and dtypes.
    Returns out in q's type and lse fp32, (h, sq, dv) and (h, sq), or with
    a leading batch dim."""
    sq, sk = q.shape[-2], k.shape[-2]
    bq, bk = effective_tiles(sq, sk, block_q, block_k)
    q4, k4, v4, num, idx, single = _batched(q, k, v, kv_num, kv_indices,
                                            -(-sq // bq))
    ct = torch.float32 if upcast else q.dtype
    w = _pair_weights(num, idx, sq, sk, bq, bk, causal, ct)
    s = torch.matmul(q4.to(ct), k4.to(ct).transpose(-1, -2)) \
        * _scale(q, softmax_scale)
    s = s.masked_fill(w == 0, float("-inf"))
    m = s.amax(-1, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(s - m) * w
    l = e.sum(-1, keepdim=True)
    p = e / torch.where(l == 0, 1.0, l)
    out = torch.matmul(p, v4.to(ct)).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1).float()  # log 0: -inf, no key seen
    return (out[0], lse[0]) if single else (out, lse)


def flash_attention_blocksparse_bwd_plain(
        do, q, k, v, out, lse, kv_num, kv_indices,
        softmax_scale: Optional[float] = None, causal: bool = False,
        block_q: int = 512, block_k: int = 512):
    """Gradients of block-sparse attention in fp32 from the saved forward
    (lse natural-log, -inf for rows that see no key). Returns (dq, dk, dv)
    fp32 in the inputs' layouts."""
    sq, sk = q.shape[-2], k.shape[-2]
    _check_bwd_shapes(sk, q.shape[-1], v.shape[-1])
    bq, bk = effective_tiles(sq, sk, block_q, block_k)
    q4, k4, v4, num, idx, single = _batched(q, k, v, kv_num, kv_indices,
                                            -(-sq // bq))
    scale = _scale(q, softmax_scale)
    shape4 = q4.shape[:-1]
    do4, out4 = do.reshape(*shape4, -1).float(), out.reshape(*shape4, -1)
    lse4 = lse.reshape(shape4).float()
    qf, kf, vf = q4.float(), k4.float(), v4.float()
    w = _pair_weights(num, idx, sq, sk, bq, bk, causal, torch.float32)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = s.masked_fill(w == 0, float("-inf"))
    lse_safe = torch.where(torch.isfinite(lse4), lse4, float("inf"))
    p = torch.exp(s - lse_safe[..., None]) * w
    dp = torch.matmul(do4, vf.transpose(-1, -2))
    delta = (do4 * out4.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), do4)
    return (dq[0], dk[0], dv[0]) if single else (dq, dk, dv)


def kv_to_q_lists(kv_num, kv_indices, nk: int):
    """The inverse of the kv lists, for the dK/dV kernel: for each key tile
    j, the q tiles that list it, ascending (a q tile listing j twice appears
    twice). kv_num (b, nq), kv_indices (b, nq, nl) -> (q_num (b, nk),
    q_indices (b, nk, nq * nl)) int32 on the same device, built with torch
    ops (no read back to the host); entries past q_num are not read."""
    b, nq, nl = kv_indices.shape
    cum = _tile_counts(kv_num, kv_indices, nk).transpose(1, 2).cumsum(-1)
    pos = torch.arange(nq * nl, device=cum.device).expand(b, nk, nq * nl)
    q_idx = torch.searchsorted(cum.contiguous(), pos.contiguous(), right=True)
    return (cum[..., -1].to(torch.int32).contiguous(),
            q_idx.clamp(max=nq - 1).to(torch.int32).contiguous())


def _check_kernel(name, q, k, v, kv_num, kv_indices, bq, bk):
    """What the kernels take; ValueError for the rest, naming ROADMAP.md
    queue A item 7 where JAX takes the form."""
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"{name} kernel: dtype {q.dtype}; the kernels take "
                         f"bf16/fp16 ({_ITEM7})")
    b, h, sq, d = q.shape
    dv = v.shape[-1]
    if d != dv or k.shape[-1] != d or d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{name} kernel: head dims q {d}, k {k.shape[-1]}, v {dv}; the "
            f"kernels take equal dims in {KERNEL_HEAD_DIMS} ({_ITEM7})")
    if bq % _TILE or bk % _TILE:
        raise ValueError(
            f"{name} kernel: tiles {bq} x {bk} (after JAX's rule); the "
            f"kernels take multiples of {_TILE} ({_ITEM7})")
    if k.shape[:2] != (b, h) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{name} kernel: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if b > 65535 or h > 65535:
        raise ValueError(f"{name} kernel: batch and heads must be <= 65535")
    for arg, x in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(name, arg, x, q.dtype, q.device)
    for arg, x in (("kv_num", kv_num), ("kv_indices", kv_indices)):
        if x.dtype != torch.int32 or x.device != q.device:
            raise ValueError(
                f"{name} kernel: {arg} is {x.dtype} on {x.device}; the "
                f"kernels read int32 on q's device {q.device}")


def _strides(x):
    """(batch, head, row) element strides of a (b, h, s, d) tensor."""
    return x.stride(0), x.stride(1), x.stride(2)


def flash_attention_blocksparse_fwd(
        q, k, v, kv_num, kv_indices, softmax_scale: Optional[float] = None,
        causal: bool = False, block_q: int = 512, block_k: int = 512):
    """q (h, sq, d) or (b, h, sq, d), k/v (..., sk, d/dv), kv_num (nq,) or
    (b, nq), kv_indices (nq, nk) or (b, nq, nk) in the tiles of
    :func:`effective_tiles`. Returns out (..., sq, dv) in q's type and lse
    (..., sq) fp32. CUDA: bf16/fp16, d == dv in {64, 128}, effective tiles
    that are multiples of 64, the lists int32 on q's device."""
    if q.device.type == "cpu":
        return flash_attention_blocksparse_fwd_plain(
            q, k, v, kv_num, kv_indices, softmax_scale, causal, block_q,
            block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_blocksparse: unsupported device {q.device}")
    sq, sk = q.shape[-2], k.shape[-2]
    bq, bk = effective_tiles(sq, sk, block_q, block_k)
    q4, k4, v4, num, idx, single = _batched(q, k, v, kv_num, kv_indices,
                                            -(-sq // bq))
    _check_kernel("flash_blocksparse_fwd", q4, k4, v4, num, idx, bq, bk)
    b, h, _, d = q4.shape
    # the kernel writes every row, out 0 and lse -inf where it sees no key
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq:
        num, idx = num.contiguous(), idx.contiguous()
        lib = _build.load_library()
        with torch.cuda.device(q.device):
            err = lib.fa_blocksparse_fwd(
                q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
                lse.data_ptr(), num.data_ptr(), idx.data_ptr(), b, h, sq, sk,
                d, bq, bk, idx.shape[-1], *_strides(q4), *_strides(k4),
                *_strides(v4), _scale(q, softmax_scale), int(causal),
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "fa_blocksparse_fwd")
        global launches_fwd
        launches_fwd += 1
    return (out[0], lse[0]) if single else (out, lse)


def flash_attention_blocksparse_bwd(
        do, q, k, v, out, lse, kv_num, kv_indices,
        softmax_scale: Optional[float] = None, causal: bool = False,
        block_q: int = 512, block_k: int = 512):
    """Deterministic block-sparse backward: (dq, dk, dv) fp32 in q's, k's
    and v's layouts. Needs seqlen_k % 128 == 0 and head dims that are
    multiples of 8, as JAX. CUDA: what the forward takes; the dK/dV kernel
    (one block per 64 keys, over the q tiles that list them) and then the
    dQ kernel (one block per 64 rows, over their kv list), each writing its
    gradient once."""
    sq, sk = q.shape[-2], k.shape[-2]
    _check_bwd_shapes(sk, q.shape[-1], v.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_blocksparse_bwd_plain(
            do, q, k, v, out, lse, kv_num, kv_indices, softmax_scale, causal,
            block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_blocksparse: unsupported device {q.device}")
    bq, bk = effective_tiles(sq, sk, block_q, block_k)
    q4, k4, v4, num, idx, single = _batched(q, k, v, kv_num, kv_indices,
                                            -(-sq // bq))
    _check_kernel("flash_blocksparse_bwd", q4, k4, v4, num, idx, bq, bk)
    b, h, _, d = q4.shape
    do4 = do.reshape(q4.shape)
    _build.check_operand("flash_blocksparse_bwd", "do", do4, q.dtype,
                         q.device)
    if out.shape != do.shape or lse.shape != q.shape[:-1]:
        raise ValueError(
            f"flash_blocksparse_bwd kernel: shapes do {tuple(do.shape)}, out "
            f"{tuple(out.shape)}, lse {tuple(lse.shape)}")
    lse4 = lse.reshape(b, h, sq).float().contiguous()
    delta = (do4.float() * out.reshape(q4.shape).float()).sum(-1).contiguous()
    # the kernels write every row; with no keys dq is 0 and nothing runs
    alloc = torch.empty if sq and sk else torch.zeros
    dq = alloc((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = alloc((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv = alloc((b, h, sk, d), dtype=torch.float32, device=q.device)
    if sq and sk:
        num, idx = num.contiguous(), idx.contiguous()
        q_num, q_idx = kv_to_q_lists(num, idx, sk // bk)
        lib = _build.load_library()
        common = (b, h, sq, sk, d, bq, bk)
        strides = (*_strides(q4), *_strides(k4), *_strides(v4),
                   *_strides(do4))
        tail = (_scale(q, softmax_scale), int(causal),
                int(q.dtype == torch.bfloat16))
        global launches_dkdv, launches_dq
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.fa_blocksparse_bwd_dkdv(
                q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), do4.data_ptr(),
                lse4.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), q_num.data_ptr(), q_idx.data_ptr(), *common,
                q_idx.shape[-1], *strides, *tail, stream)
            _build.check(err, "fa_blocksparse_bwd_dkdv")
            launches_dkdv += 1
            err = lib.fa_blocksparse_bwd_dq(
                q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), do4.data_ptr(),
                lse4.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                num.data_ptr(), idx.data_ptr(), *common, idx.shape[-1],
                *strides, *tail, stream)
            _build.check(err, "fa_blocksparse_bwd_dq")
            launches_dq += 1
    return (dq[0], dk[0], dv[0]) if single else (dq, dk, dv)


class _BlockSparseAttn(torch.autograd.Function):
    """out = block-sparse attention; the backward casts the fp32 gradients
    to the inputs' types, and kv_num / kv_indices take none (JAX's
    ``custom_vjp``, :454-487)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_num, kv_indices, softmax_scale, causal,
                block_q, block_k):
        out, lse = flash_attention_blocksparse_fwd(
            q, k, v, kv_num, kv_indices, softmax_scale, causal, block_q,
            block_k)
        ctx.save_for_backward(q, k, v, kv_num, kv_indices, out, lse)
        ctx.args = (softmax_scale, causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_num, kv_indices, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_blocksparse_bwd(
            g.contiguous(), q, k, v, out, lse, kv_num, kv_indices, *ctx.args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 6


def flash_attention_blocksparse(q, k, v, kv_num, kv_indices,
                                softmax_scale: Optional[float] = None,
                                causal: bool = False, block_q: int = 512,
                                block_k: int = 512):
    """Differentiable block-sparse attention (out only; the lse comes from
    :func:`flash_attention_blocksparse_fwd`). Layouts as that function."""
    return _BlockSparseAttn.apply(q, k, v, kv_num, kv_indices, softmax_scale,
                                  causal, block_q, block_k)
