"""Golden reference attention and the repo's numerics contract.

Port of flash_attn_tpu/utils/testing.py ``attention_ref`` (:177, with
query and key padding masks, the sliding window, sink tokens and chunks,
softcap and ALiBi), ``attn_bias_from_alibi_slopes`` (:115),
``construct_local_mask`` (:34), ``construct_chunk_mask`` (:81),
``generate_random_padding_mask`` (:154) and ``check_against_ref`` (:306),
for the masks the port supports, with the
packed-varlen references (``attention_varlen_ref`` and its gradients) and
the paged-cache references of the serving engine (``paged_to_linear``,
``attention_varlen_paged_ref``). The contract: a kernel's output, computed in bf16/fp16, must satisfy

    max|out - ref_fp32| <= 2 * max|ref_lowprec - ref_fp32| + atol

where ``ref_lowprec`` is the same full-matrix attention computed in the
kernel's precision (``upcast=False``). Gradients are held the same way,
against autograd through the reference (``attention_ref_grads``).
"""

from typing import Optional

import numpy as np
import torch

from flash_attn_tpu_torch.dispatch.config import default_scale

__all__ = ["attention_ref", "attention_ref_grads", "attention_varlen_paged_ref",
           "attention_varlen_ref", "attention_varlen_ref_grads",
           "attn_bias_from_alibi_slopes",
           "check_against_ref", "construct_chunk_mask",
           "construct_local_mask", "generate_random_padding_mask",
           "kept_columns_check", "paged_to_linear"]


def generate_random_padding_mask(max_seqlen: int, batch_size: int, rng,
                                 mode: str = "random",
                                 zero_lengths: bool = False, device=None):
    """(batch_size, max_seqlen) bool, True on each row's first length
    tokens: lengths max_seqlen ("full"), uniform in [max_seqlen - 20,
    max_seqlen] ("random", from 1 unless zero_lengths) or in [max_seqlen //
    3, max_seqlen] ("third"), drawn from the numpy Generator ``rng``; with
    ``zero_lengths``, rows 0, 5, 10, ... and the last have length 0."""
    if mode == "full":
        lengths = np.full(batch_size, max_seqlen)
    elif mode == "random":
        lo = max(0 if zero_lengths else 1, max_seqlen - 20)
        lengths = rng.integers(lo, max_seqlen + 1, batch_size)
    elif mode == "third":
        lengths = rng.integers(max_seqlen // 3, max_seqlen + 1, batch_size)
    else:
        raise ValueError(f"mode {mode!r}")
    if zero_lengths:
        idx = np.arange(batch_size)
        lengths = np.where((idx % 5 == 0) | (idx == batch_size - 1), 0,
                           lengths)
    mask = np.arange(max_seqlen)[None, :] < lengths[:, None]
    return torch.from_numpy(mask).to(device)


def _unpadded_lengths(seqlen_q, seqlen_k, query_padding_mask,
                      key_padding_mask):
    """(sq, sk): the query and key counts, per batch row (b, 1, 1, 1) where
    a padding mask is given."""
    sk = (seqlen_k if key_padding_mask is None
          else key_padding_mask.sum(-1).reshape(-1, 1, 1, 1))
    sq = (seqlen_q if query_padding_mask is None
          else query_padding_mask.sum(-1).reshape(-1, 1, 1, 1))
    return sq, sk


def construct_local_mask(seqlen_q: int, seqlen_k: int,
                         window_size=(None, None),
                         sink_token_length: int = 0,
                         query_padding_mask=None, key_padding_mask=None,
                         device=None):
    """True where a (query row, key) pair is MASKED OUT by the local window,
    bottom-right aligned over the unpadded counts (shift = sk - sq): row i
    sees keys i + shift - left .. i + shift + right, and the first
    ``sink_token_length`` keys whatever the left extent. A None extent is
    no bound (JAX's function needs a right extent). (sq, sk), or (b, 1, sq,
    sk) with a padding mask."""
    row = torch.arange(seqlen_q, device=device)[:, None]
    col = torch.arange(seqlen_k, device=device)[None, :]
    sq, sk = _unpadded_lengths(seqlen_q, seqlen_k, query_padding_mask,
                               key_padding_mask)
    shift = sk - sq
    left, right = window_size
    masked = torch.zeros(torch.broadcast_shapes(
        getattr(shift, "shape", ()), (seqlen_q, seqlen_k)), dtype=torch.bool,
        device=device)
    if right is not None:
        masked = masked | (col > torch.minimum(
            row + shift + right, torch.as_tensor(sk, device=device)))
    if left is not None:
        masked = masked | ((col < row + shift - left)
                           & (col >= sink_token_length))
    return masked


def construct_chunk_mask(seqlen_q: int, seqlen_k: int, attention_chunk: int,
                         query_padding_mask=None, key_padding_mask=None,
                         device=None):
    """True where a pair is MASKED OUT by chunked attention (llama4's): row
    i sees only the keys of the chunk of i + shift, [lo, lo +
    attention_chunk) with lo that position rounded down (floor) to a
    multiple of the chunk."""
    row = torch.arange(seqlen_q, device=device)[:, None]
    col = torch.arange(seqlen_k, device=device)[None, :]
    sq, sk = _unpadded_lengths(seqlen_q, seqlen_k, query_padding_mask,
                               key_padding_mask)
    pos = row + sk - sq
    lo = pos - pos % attention_chunk
    return (col < lo) | (col >= lo + attention_chunk)


def attn_bias_from_alibi_slopes(slopes, seqlen_q: int, seqlen_k: int,
                                query_padding_mask=None,
                                key_padding_mask=None, causal: bool = False):
    """ALiBi's bias, broadcastable to (b, h, sq, sk), from slopes (h,) or
    (b, h): under ``causal`` col - (seqlen_k - 1) (relative to the last key
    of the padded length, whatever the padding: a per-row constant), else
    -|row + sk - sq - col| over the unpadded counts."""
    if slopes.dim() == 1:
        slopes = slopes[None, :]
    slopes = slopes[:, :, None, None].float()
    dev = slopes.device
    if causal:
        bias = torch.arange(-seqlen_k + 1, 1, dtype=torch.float32, device=dev)
        return bias[None, None, None, :] * slopes
    row = torch.arange(seqlen_q, device=dev)[:, None]
    col = torch.arange(seqlen_k, device=dev)[None, :]
    sq, sk = _unpadded_lengths(seqlen_q, seqlen_k, query_padding_mask,
                               key_padding_mask)
    return -slopes * (row + sk - sq - col).abs().float()


def attention_ref(
    q,  # (b, sq, h, d)
    k,  # (b, sk, h_k, d)
    v,  # (b, sk, h_k, dv)
    key_padding_mask=None,  # (b, sk) bool, True = keep
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    upcast: bool = True,
    query_padding_mask=None,  # (b, sq) bool, True = keep
    qv=None,  # (b, sq, h, dv): the MLA second query, scored against v
    window_size=(None, None),
    sink_token_length: int = 0,
    attention_chunk: int = 0,
    softcap: float = 0.0,
    alibi_slopes=None,  # (h,) or (b, h)
    learnable_sink=None,  # (h,)
):
    """Full-matrix attention, fp32 by default (``upcast``), else in the
    inputs' type. Scores are q k^T (+ qv v^T) times the scale, 1/sqrt(d)
    (1/sqrt(d + dv) with ``qv``), capped (tanh(s / softcap) softcap) before
    the masks and biased by ALiBi (:func:`attn_bias_from_alibi_slopes`)
    after them, JAX's order. Bottom-right aligned causal, local
    (``window_size`` (left, right), None for no bound, with
    ``sink_token_length`` sink keys) and chunk masks (over the unpadded
    query and key counts), GQA by grouping the query heads of each KV head
    (K and V are not repeated), zero output for rows that see no key and
    for padded query rows. ``learnable_sink`` adds one more logit a query
    head to each row's softmax, in fp32 whatever the inputs' type (JAX
    utils/testing.py:273-281). Returns (output (b, sq, h, dv), attention
    (b, h, sq, sk))."""
    dtype_og = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
        qv = None if qv is None else qv.float()
    b, seqlen_q, h, d = q.shape
    seqlen_k, h_k, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // h_k
    if softmax_scale is None:
        softmax_scale = default_scale(d, dv, qv is not None)

    def grouped(x):
        return x.reshape(b, seqlen_q, h_k, g, x.shape[-1])

    scores = torch.einsum("btkgd,bskd->bkgts", grouped(q * softmax_scale), k)
    if qv is not None:
        scores = scores + torch.einsum("btkgd,bskd->bkgts",
                                       grouped(qv * softmax_scale), v)
    scores = scores.reshape(b, h, seqlen_q, seqlen_k)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    neg_inf = float("-inf")
    if key_padding_mask is not None:
        scores = scores.masked_fill(~key_padding_mask[:, None, None, :], neg_inf)
    if causal:
        window_size = (window_size[0], 0)
    if window_size != (None, None):
        scores = scores.masked_fill(construct_local_mask(
            seqlen_q, seqlen_k, window_size, sink_token_length,
            query_padding_mask, key_padding_mask, q.device), neg_inf)
    if attention_chunk > 0:
        scores = scores.masked_fill(construct_chunk_mask(
            seqlen_q, seqlen_k, attention_chunk, query_padding_mask,
            key_padding_mask, q.device), neg_inf)
    if alibi_slopes is not None:
        scores = scores + attn_bias_from_alibi_slopes(
            alibi_slopes.to(q.device), seqlen_q, seqlen_k, query_padding_mask,
            key_padding_mask, causal)  # promotes, as jnp's does
    if learnable_sink is None:
        m = scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores - torch.where(torch.isneginf(m), 0.0, m))
        e = torch.where(torch.isneginf(scores), 0.0, e)
        denom = e.sum(dim=-1, keepdim=True)
        attention = (e / torch.where(denom == 0, 1.0, denom)).to(v.dtype)
    else:
        scores32 = scores.float()
        sink = learnable_sink.to(q.device).float().reshape(1, -1, 1, 1)
        m = torch.maximum(sink, scores32.amax(dim=-1, keepdim=True))
        e = torch.exp(scores32 - m)
        e = torch.where(torch.isneginf(scores32), 0.0, e)
        attention = (e / (e.sum(dim=-1, keepdim=True)
                          + torch.exp(sink - m))).to(v.dtype)
    if query_padding_mask is not None:
        attention = attention.masked_fill(
            ~query_padding_mask[:, None, :, None], 0.0)
    output = torch.einsum(
        "bkgts,bskd->btkgd",
        attention.reshape(b, h_k, g, seqlen_q, seqlen_k), v).reshape(
            b, seqlen_q, h, dv)
    if query_padding_mask is not None:
        output = output.masked_fill(~query_padding_mask[:, :, None, None], 0.0)
    return output.to(dtype_og), attention.to(dtype_og)


def attention_ref_grads(q, k, v, dout, causal: bool = False,
                        softmax_scale: Optional[float] = None,
                        upcast: bool = True, softcap: float = 0.0,
                        alibi_slopes=None, learnable_sink=None, **band):
    """(dq, dk, dv) of sum(attention_ref(q, k, v) * dout) by autograd: the
    fp32 reference of a backward (``upcast``), or the low-precision one
    computed in the inputs' type, for :func:`check_against_ref`. ``band``:
    attention_ref's window_size, sink_token_length and attention_chunk;
    ``softcap`` and ``alibi_slopes`` map the scores as attention_ref does
    (the cap before the masks, the bias after them: the masked scores stay
    -inf either way), so that autograd carries the cap's tanh derivative
    into dS as JAX's backward does (flash_bwd.py:143-152). With
    ``learnable_sink`` the result ends with its gradient, (h,) fp32."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        if learnable_sink is not None:
            leaves.append(learnable_sink.detach().float().requires_grad_())
        out, _ = attention_ref(*leaves[:3], causal=causal,
                               softmax_scale=softmax_scale, upcast=upcast,
                               softcap=softcap, alibi_slopes=alibi_slopes,
                               learnable_sink=(leaves[3] if len(leaves) > 3
                                               else None), **band)
        return torch.autograd.grad(out, leaves, dout.to(out.dtype))


def paged_to_linear(k_pages, block_table, lengths):
    """Gather a paged cache (num_pages, h_k, page_size, d) through its block
    table (b, max_pages) into the linear layout (b, h_k, max_pages *
    page_size, d), zero at positions >= lengths (b,). Table entries out of
    range read the nearest page, as the kernels clamp them. Pages of 1-byte
    codes (a quantized cache) come back as their values in fp32."""
    num_pages, h_k, page_size, d = k_pages.shape
    b, width = block_table.shape
    table = block_table.to(k_pages.device, torch.long).clamp(0, num_pages - 1)
    if k_pages.element_size() == 1:
        # gathered as bytes (float8 has no indexing kernel everywhere)
        lin = k_pages.view(torch.uint8)[table].view(k_pages.dtype).float()
    else:
        lin = k_pages[table]
    lin = lin.permute(0, 2, 1, 3, 4).reshape(b, h_k, width * page_size, d)
    pos = torch.arange(width * page_size, device=k_pages.device)
    keep = pos[None, :] < lengths.to(k_pages.device, torch.long)[:, None]
    return lin * keep[:, None, :, None].to(lin.dtype)


def attention_varlen_paged_ref(q, k_pages, v_pages, cu_seqlens_q, seqlens_k,
                               block_table, seqused_q=None,
                               causal: bool = False,
                               softmax_scale: Optional[float] = None,
                               upcast: bool = True, qv=None,
                               window_size=(None, None),
                               softcap: float = 0.0):
    """Packed-varlen attention over a paged cache, one :func:`attention_ref`
    call per sequence. Sequence i owns the packed rows cu_seqlens_q[i] ..
    cu_seqlens_q[i + 1]; its first seqused_q[i] rows (all when seqused_q
    is None) attend to its first seqlens_k[i] keys with bottom-right causal
    alignment (and ``window_size``, and the scores capped by
    ``softcap``), the rest give zeros. ``qv`` (total_q,
    h, dv) adds qv v^T to the scores. Returns out (total_q, h, dv)."""
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
        o, _ = attention_ref(
            q[None, lo:lo + lq], k_lin[i:i + 1, :lk], v_lin[i:i + 1, :lk],
            causal=causal, softmax_scale=softmax_scale, upcast=upcast,
            qv=None if qv is None else qv[None, lo:lo + lq],
            window_size=window_size, softcap=softcap)
        out[lo:lo + lq] = o[0]
    return out


def _sequences(cu_seqlens_q, cu_seqlens_k, seqused_q, seqused_k):
    """(first row, rows, first key, keys) of each packed sequence, the
    lengths cut to the cu_seqlens deltas."""
    def spans(cu, used):
        cu = cu.tolist()
        lens = [hi - lo for lo, hi in zip(cu[:-1], cu[1:])]
        if used is not None:
            lens = [min(a, u) for a, u in zip(lens, used.tolist())]
        return zip(cu[:-1], lens)

    return [(q0, lq, k0, lk) for (q0, lq), (k0, lk) in zip(
        spans(cu_seqlens_q, seqused_q), spans(cu_seqlens_k, seqused_k))]


def _seq_slopes(alibi_slopes, i: int):
    """Sequence i's slopes (1, h) of (h,) or (b, h) ones, or None."""
    if alibi_slopes is None:
        return None
    return (alibi_slopes if alibi_slopes.dim() == 1
            else alibi_slopes[i])[None]


def attention_varlen_ref(q, k, v, cu_seqlens_q, cu_seqlens_k, seqused_q=None,
                         seqused_k=None, causal: bool = False,
                         softmax_scale: Optional[float] = None,
                         upcast: bool = True, softcap: float = 0.0,
                         alibi_slopes=None):
    """Packed-varlen attention, one :func:`attention_ref` call per
    sequence: sequence i's first seqused_q[i] rows from cu_seqlens_q[i]
    (all of its rows when seqused_q is None) attend to its first
    seqused_k[i] keys from cu_seqlens_k[i], bottom-right causal when
    ``causal``, the scores capped by ``softcap`` and biased by ALiBi with
    the sequence's slopes (``alibi_slopes`` (h,) or (b, h)); every other row
    is zero. Differentiable. Returns out (total_q, h, dv) in q's type."""
    parts, row = [], 0
    for i, (q0, lq, k0, lk) in enumerate(_sequences(
            cu_seqlens_q, cu_seqlens_k, seqused_q, seqused_k)):
        if lk == 0:
            continue  # its rows see no key: zeros
        parts.append(q.new_zeros((q0 - row,) + q.shape[1:-1] + v.shape[-1:]))
        o, _ = attention_ref(q[None, q0:q0 + lq], k[None, k0:k0 + lk],
                             v[None, k0:k0 + lk], causal=causal,
                             softmax_scale=softmax_scale, upcast=upcast,
                             softcap=softcap,
                             alibi_slopes=_seq_slopes(alibi_slopes, i))
        parts.append(o[0])
        row = q0 + lq
    parts.append(q.new_zeros((q.shape[0] - row,) + q.shape[1:-1]
                             + v.shape[-1:]))
    return torch.cat(parts)


def attention_varlen_ref_grads(q, k, v, dout, cu_seqlens_q, cu_seqlens_k,
                               seqused_q=None, seqused_k=None,
                               causal: bool = False,
                               softmax_scale: Optional[float] = None,
                               upcast: bool = True, softcap: float = 0.0,
                               alibi_slopes=None):
    """(dq, dk, dv) of sum(attention_varlen_ref(q, k, v) * dout), one
    sequence at a time (:func:`attention_ref_grads`, with ``softcap`` and
    each sequence's ``alibi_slopes``), in the inputs' types; zero outside
    the sequences."""
    grads = [torch.zeros_like(x) for x in (q, k, v)]
    for i, (q0, lq, k0, lk) in enumerate(_sequences(
            cu_seqlens_q, cu_seqlens_k, seqused_q, seqused_k)):
        if lq == 0 or lk == 0:
            continue
        rows, keys = slice(q0, q0 + lq), slice(k0, k0 + lk)
        g = attention_ref_grads(q[None, rows], k[None, keys], v[None, keys],
                                dout[None, rows], causal=causal,
                                softmax_scale=softmax_scale, upcast=upcast,
                                softcap=softcap,
                                alibi_slopes=_seq_slopes(alibi_slopes, i))
        for out, part, span in zip(grads, g, (rows, keys, keys)):
            out[span] = part[0]
    return tuple(grads)


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


# Written into the columns past the head dim of the outputs in
# kept_columns_check: exact in bf16, fp16 and fp32.
SENTINEL = 768.0


def kept_columns_check(form: str, d: int = 80, row: int = 96,
                       seed: int = 80):
    """On the card: whether the attention kernels at head dim ``d`` (below
    ``row``, a multiple of 16) keep to a row's d columns, reading and
    writing, under ``form``: "plain", "band" (a causal window of 100) or
    "score" (the cap and (b, h) ALiBi slopes at softmax scale 1/d); b = 2
    rows of 300, 8 query heads over 4 KV heads, bf16, causal.

    Reads: q, k, v, out and dout whose heads of d sit in rows of ``row``
    columns, the rest NaN, must give B1's out and lse, B3's gradients, B2's
    dk and dv, B6's and B7's forwards and B6's backward bitwise equal to
    those of contiguous inputs (B2's dq, summed by atomics in a varying
    order, within 1e-2). Writes: with every 16-bit output of last dim d
    allocated as the first d columns of rows of ``row`` whose rest holds
    SENTINEL (the C entry points take the outputs' strides) and B2's fp32
    dQ buffer followed by a SENTINEL tail, every tail must survive and
    every output keep its bits. B6's preprocess, which zeroes the gradient
    rows that lie in no sequence and so takes contiguous gradients, gets
    contiguous ones of its own (these sequences leave no such row, so it
    writes none). Raises AssertionError; returns (the tails checked, B2's
    dq's largest difference)."""
    import math
    from unittest import mock

    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd, flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp
    from flash_attn_tpu_torch.modules.mha import alibi_slopes

    b, s, h, h_k = 2, 300, 8, 4
    slopes = alibi_slopes(h, "cuda")[None] * torch.tensor(
        [[1.0], [1.5]], device="cuda")
    kw = {"plain": {}, "band": dict(window_size=(100, 0)),
          "score": dict(softcap=30.0, softmax_scale=1.0 / d,
                        alibi_slopes=slopes)}[form]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def padded(*shape):
        x = torch.full((*shape, row), float("nan"), device="cuda",
                       dtype=torch.bfloat16)
        x[..., :d] = torch.randn(*shape, d, device="cuda", generator=gen)
        return x[..., :d]

    wide_in = [padded(b, s, n) for n in (h, h_k, h_k, h)]
    dense_in = [x.contiguous() for x in wide_in]
    cu = torch.arange(b + 1, dtype=torch.int32, device="cuda") * s

    def run(q, k, v, do):
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=True,
                                                 **kw)
        if q.stride(2) == row:  # out padded as q is
            wide = torch.full((b, s, h, row), float("nan"), device="cuda",
                              dtype=out.dtype)
            wide[..., :d] = out.transpose(1, 2)
            out = wide[..., :d].transpose(1, 2)
        b3 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                           causal=True, **kw)
        b2 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                           causal=True, deterministic=False,
                                           **kw)
        pk = [x.reshape(b * s, x.shape[2], d) for x in (q, k, v, do)]
        po = out.transpose(1, 2).reshape(b * s, h, d)
        plse = lse.permute(1, 0, 2).reshape(h, b * s).contiguous()
        args = (cu, cu, s, s)
        b6 = flash_varlen.flash_attention_varlen_fwd(*pk[:3], *args,
                                                     causal=True, **kw)
        b7 = fvp.flash_attention_varlen_fwd_persistent(*pk[:3], *args,
                                                       causal=True, **kw)
        b6g = flash_varlen.flash_attention_varlen_bwd(pk[3], *pk[:3], po,
                                                      plse, *args,
                                                      causal=True, **kw)
        bits = [out.transpose(1, 2), lse, *b3, *b2[1:], *b6, *b7, *b6g]
        return [x.contiguous() for x in bits], b2[0]

    want, want_dq2 = run(*dense_in)
    assert all(bool(torch.isfinite(x).all()) for x in want[2:5]), \
        f"{form}: B3's gradients are not finite"
    got, dq2 = run(*wide_in)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), \
        f"{form}: an output over inputs in rows of {row} differs"
    gap = float((dq2.float() - want_dq2.float()).abs().max())
    assert gap <= 1e-2, f"{form}: B2's dq over inputs in rows of {row}: {gap}"

    tails = []
    empty, zeros = torch.empty, torch.zeros

    def tailed(make):
        def alloc(*args, dtype=None, device=None, **kw_):
            shape = tuple(args[0]) if len(args) == 1 and isinstance(
                args[0], (tuple, list, torch.Size)) else args
            if shape and shape[-1] == d and dtype in (torch.bfloat16,
                                                      torch.float16):
                buf = zeros((*shape[:-1], row), dtype=dtype, device=device)
                buf[..., d:] = SENTINEL
                tails.append(buf[..., d:])
                return buf[..., :d]
            if len(shape) == 4 and shape[-1] == d and dtype == torch.float32:
                n = math.prod(shape)  # B2's dQ buffer, contiguous
                buf = zeros(n + 64, dtype=dtype, device=device)
                buf[n:] = SENTINEL
                tails.append(buf[n:])
                return buf[:n].view(shape)
            return make(*args, dtype=dtype, device=device, **kw_)
        return alloc

    pre = flash_varlen.varlen_bwd_preprocess

    def own_grads(do, out, lse, cu_q, cu_k, meta, *grads):
        return pre(do, out, lse, cu_q, cu_k, meta,
                   *(empty(g.shape, dtype=g.dtype, device=g.device)
                     for g in grads))

    with mock.patch.object(flash_varlen, "varlen_bwd_preprocess", own_grads), \
            mock.patch.object(torch, "empty", tailed(empty)), \
            mock.patch.object(torch, "zeros", tailed(zeros)):
        got, dq2 = run(*dense_in)
        torch.cuda.synchronize()
    assert len(tails) >= 12, f"{form}: {len(tails)} outputs allocated"
    assert all(bool((t == SENTINEL).all()) for t in tails), \
        f"{form}: a kernel wrote past column {d}"
    assert all(torch.equal(g, w) for g, w in zip(got, want)), \
        f"{form}: an output written into rows of {row} differs"
    gap = max(gap, float((dq2.float() - want_dq2.float()).abs().max()))
    assert gap <= 1e-2, f"{form}: B2's dq written into rows of {row}: {gap}"
    return len(tails), gap
