"""Packed varlen attention, forward (B6) and backward: the CUDA kernels of
``csrc/flash_varlen_fwd.cu`` (the wgmma/TMA forward tile of
csrc/fwd_sm90.cuh, which the persistent B7 of flash_varlen_persistent.py
runs too) and ``csrc/flash_varlen.cu`` (the backward's preprocess, dK/dV
and dQ kernels on the wgmma/TMA tiles of csrc/bwd_sm90.cuh, which the dense
backward B3 runs too), and their plain PyTorch versions.

Port of flash_attn_tpu/kernels/flash_varlen.py ``flash_attention_varlen_fwd``
(:285) and ``flash_attention_varlen_bwd`` (:807): q (total_q, h, d) and k/v
(total_k, h_k, d) packed by ``cu_seqlens``, ``seqused`` giving each
sequence's true length inside its slot, bottom-right causal masking per
sequence. ``window_size`` and ``attention_chunk`` mask each sequence as
the dense functions mask a batch row (flash_varlen.py:47-76
``_varlen_mask_and_bias``; no sink tokens, as in JAX): a call with a band
launches the kernels' band instantiations. ``softcap`` and ALiBi's
``alibi_slopes`` ((h,) or (b, h), each sequence taking its row's slopes,
flash_varlen.py:369-376; the bias of each sequence's own keys) launch the
kernels' score instantiations, forward and backward, with or without a
band (dispatch/score.py). ``learnable_sink`` (dispatch/sink.py; JAX
flash_varlen.py:260) runs in every forward instantiation's epilogue, and
its gradient is an epilogue of torch ops over the preprocess kernel's
delta (JAX interface.py:384-394). Rows that see no key, rows past
a sequence's length and rows past ``cu_seqlens[-1]`` give out 0 and lse
-inf (the sink under one, as in JAX), and zero gradients. The JAX
kernels tile the flat token axis and mask by segment ids; here the wrapper
builds per-sequence work lists with torch ops (dispatch/varlen_meta.py), so
nothing is read back to the host: one VarlenMeta holds the forward's
schedule of 128-row tiles (FWD_TILE) and the backward's 128-row and 128-key
lists (VARLEN_BWD_TILE). delta = rowsum(dO * O), an XLA op in JAX
(flash_varlen.py:854), is the backward's preprocess kernel here, which
also takes lse to base 2 and zeroes the gradient rows that no tile writes.
A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernels or raises.
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.dispatch.band import (
    band_args,
    has_band,
    reach_window,
)
from flash_attn_tpu_torch.dispatch.config import (
    FWD_TILE,
    HEAD_DIMS,
    VARLEN_BWD_TILE,
    check_head_dims,
    num_sms,
)
from flash_attn_tpu_torch.dispatch.varlen_meta import (
    compute_varlen_meta,
    num_tiles_bound,
)
from flash_attn_tpu_torch.dispatch.score import (
    has_score,
    slope_args,
    slopes_bh,
)
from flash_attn_tpu_torch.dispatch.sink import (
    lse_fill,
    sink_arg,
    sink_grad,
    sink_ptr,
)
from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd_plain
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd_plain

# Kernel launches since the last reset (plain calls not counted): the
# forward, and the backward's preprocess, dK/dV and dQ kernels; the *_band
# and *_score counters count the band and the score instantiations'
# launches among them, launches_fwd_sink the forward's with a learnable
# sink.
launches_fwd = 0
launches_preprocess = 0
launches_dkdv = 0
launches_dq = 0
launches_fwd_band = 0
launches_dkdv_band = 0
launches_dq_band = 0
launches_fwd_score = 0
launches_dkdv_score = 0
launches_dq_score = 0
launches_fwd_sink = 0

Window = Tuple[Optional[int], Optional[int]]

LOG2E = math.log2(math.e)
# Rows the backward's padded lse2 / delta buffers give each sequence beyond
# its own (csrc/flash_varlen.cu SEQ_GAP): room for whole 128-row tiles.
SEQ_GAP = 132


def _host_lengths(cu_seqlens, seqused):
    """(offsets, lengths) of the sequences as host lists, the lengths cut
    to the cu_seqlens deltas."""
    cu = cu_seqlens.tolist()
    lens = [hi - lo for lo, hi in zip(cu[:-1], cu[1:])]
    if seqused is not None:
        lens = [min(a, u) for a, u in zip(lens, seqused.tolist())]
    return cu[:-1], lens


def _heads_first(x):
    """(s, h, d) rows of one sequence as a (1, h, s, d) view."""
    return x.transpose(0, 1)[None]


def seq_slopes(alibi_slopes, cu_seqlens_q, h: int, device=None):
    """ALiBi's slopes as (b, h) fp32, a row a sequence (b + 1 =
    cu_seqlens_q's length; an (h,) vector broadcast over them), or None."""
    return slopes_bh(alibi_slopes, cu_seqlens_q.numel() - 1, h, device)


def flash_attention_varlen_fwd_plain(
        q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q: int,
        max_seqlen_k: int, seqused_q=None, seqused_k=None,
        softmax_scale: Optional[float] = None, causal: bool = False,
        window_size: Window = (None, None), attention_chunk: int = 0,
        softcap: float = 0.0, alibi_slopes=None, learnable_sink=None):
    """One sequence at a time through the dense plain forward (fp32), the
    band, the score map (each sequence's slopes) and the sink per
    sequence. Returns out (total_q, h, dv) in q's type and lse (h, total_q)
    fp32 (the sink on rows in no sequence under one)."""
    total_q, h, _ = q.shape
    sink = sink_arg("flash_varlen_fwd", learnable_sink, h, q.device)
    out = q.new_zeros((total_q, h, v.shape[-1]))
    lse = lse_fill(sink, h, total_q, q.device)
    slopes = seq_slopes(alibi_slopes, cu_seqlens_q, h, q.device)
    for i, ((q0, lq), (k0, lk)) in enumerate(zip(
            zip(*_host_lengths(cu_seqlens_q, seqused_q)),
            zip(*_host_lengths(cu_seqlens_k, seqused_k)))):
        if lq == 0:
            continue
        o, l = flash_attention_fwd_plain(
            _heads_first(q[q0:q0 + lq]), _heads_first(k[k0:k0 + lk]),
            _heads_first(v[k0:k0 + lk]), softmax_scale, causal, window_size,
            attention_chunk=attention_chunk, softcap=softcap,
            alibi_slopes=None if slopes is None else slopes[i:i + 1],
            learnable_sink=sink)
        out[q0:q0 + lq] = o[0].transpose(0, 1)
        lse[:, q0:q0 + lq] = l[0]
    return out, lse


def flash_attention_varlen_bwd_plain(
        do, q, k, v, out, lse, cu_seqlens_q, cu_seqlens_k, max_seqlen_q: int,
        max_seqlen_k: int, seqused_q=None, seqused_k=None,
        softmax_scale: Optional[float] = None, causal: bool = False,
        window_size: Window = (None, None), attention_chunk: int = 0,
        softcap: float = 0.0, alibi_slopes=None, learnable_sink=None):
    """One sequence at a time through the dense plain backward (fp32), the
    band and the score map (each sequence's slopes) per sequence. Returns
    (dq, dk, dv) in q's, k's and v's types, zero outside the sequences; a
    GQA group's gradients sum into its KV head; with ``learnable_sink``
    also its gradient, (h,) fp32, over every packed row."""
    sink = sink_arg("flash_varlen_bwd", learnable_sink, q.shape[1], q.device)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    slopes = seq_slopes(alibi_slopes, cu_seqlens_q, q.shape[1], q.device)
    for i, ((q0, lq), (k0, lk)) in enumerate(zip(
            zip(*_host_lengths(cu_seqlens_q, seqused_q)),
            zip(*_host_lengths(cu_seqlens_k, seqused_k)))):
        if lq == 0 or lk == 0:
            continue
        rows, keys = slice(q0, q0 + lq), slice(k0, k0 + lk)
        g = flash_attention_bwd_plain(
            _heads_first(do[rows]), _heads_first(q[rows]),
            _heads_first(k[keys]), _heads_first(v[keys]),
            _heads_first(out[rows]), lse[None, :, rows], softmax_scale, causal,
            window_size, attention_chunk=attention_chunk, softcap=softcap,
            alibi_slopes=None if slopes is None else slopes[i:i + 1])
        dq[rows] = g[0][0].transpose(0, 1)
        dk[keys] = g[1][0].transpose(0, 1)
        dv[keys] = g[2][0].transpose(0, 1)
    if sink is None:
        return dq, dk, dv
    delta = (do.float() * out.float()).sum(-1).T
    return dq, dk, dv, sink_grad(sink, lse.float(), delta, 0)


def padded_rows(total_q: int, b: int) -> int:
    """Rows (a head) of the backward's padded lse2 / delta buffers for b
    sequences over total_q packed rows."""
    return -(-(total_q + SEQ_GAP * b) // 4) * 4


def padded_row(cu: int, seq: int) -> int:
    """The first padded row of sequence ``seq``, whose packed rows start at
    ``cu`` (csrc/flash_varlen.cu padded_row): a multiple of 4, so that each
    tile's bulk copy of lse2 and delta is 16-byte aligned."""
    return -(-cu // 4) * 4 + SEQ_GAP * seq


def varlen_bwd_preprocess_plain(do, out, lse, cu_seqlens_q, seqused_q=None):
    """What the preprocess kernel computes: delta = rowsum(dO * O) in fp32
    and lse2 = lse * log2(e) (+inf where lse is -inf, so that the tiles'
    P = 2^(S * scale * log2(e) - lse2) is 0 there), each (h,
    padded_rows(total_q, b)), sequence s's rows from padded_row(cu[s], s);
    every other row holds delta 0 and lse2 +inf (the kernel writes those
    of its sequences' whole 128-row tiles only). do/out (total_q, h, d), lse
    (h, total_q) natural-log."""
    total_q, h, _ = do.shape
    starts, lens = _host_lengths(cu_seqlens_q, seqused_q)
    delta = torch.zeros((h, padded_rows(total_q, len(lens))),
                        device=do.device)
    lse2 = torch.full_like(delta, float("inf"))
    row_delta = (do.float() * out.float()).sum(-1).T
    row_lse2 = torch.where(lse == float("-inf"), float("inf"),
                           lse.float() * LOG2E)
    for s, (c, n) in enumerate(zip(starts, lens)):
        p0 = padded_row(c, s)
        delta[:, p0:p0 + n] = row_delta[:, c:c + n]
        lse2[:, p0:p0 + n] = row_lse2[:, c:c + n]
    return delta, lse2


def check_kernel_inputs(name: str, q, k, v, cu_seqlens_q, cu_seqlens_k):
    """What the varlen kernels take: bf16/fp16 (total, heads, d) tensors on
    one card with equal head dims in HEAD_DIMS, h % h_k == 0, 16-byte
    rows, and b + 1 offsets on both sides."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"{name} kernel: dtype {q.dtype} (bf16/fp16 only)")
    if q.dim() != 3 or k.dim() != 3 or v.shape[:-1] != k.shape[:-1]:
        raise ValueError(
            f"{name} kernel: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}; needs (total, heads, d)")
    check_head_dims(name, q.shape[-1], k.shape[-1], v.shape[-1],
                    HEAD_DIMS)
    h, h_k = q.shape[1], k.shape[1]
    if h % h_k or h > 65535 or cu_seqlens_q.numel() != cu_seqlens_k.numel() \
            or cu_seqlens_q.numel() < 2:
        raise ValueError(
            f"{name} kernel: {h} heads over {h_k} KV heads, cu_seqlens of "
            f"{cu_seqlens_q.numel()} and {cu_seqlens_k.numel()} offsets")
    for arg, x in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(name, arg, x, q.dtype, q.device)


def varlen_meta(q, k, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
                seqused_q, seqused_k, causal, meta,
                window_size: Window = (None, None), attention_chunk: int = 0):
    """``meta`` if given (get_scheduler_metadata), else the work lists of
    this call on q's device: the forward's schedule of FWD_TILE's 128-row
    tiles (also the dQ kernel's), and the backward's lists of
    VARLEN_BWD_TILE, each ordered by the band's true lengths."""
    if meta is not None:
        return meta
    return compute_varlen_meta(
        cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k, q.shape[0],
        k.shape[0], causal=causal, seqused_q=seqused_q, seqused_k=seqused_k,
        block_q=VARLEN_BWD_TILE.block_q, block_k=VARLEN_BWD_TILE.block_k,
        schedule_block_q=FWD_TILE.block_q, schedule_block_k=FWD_TILE.block_k,
        device=q.device, window_size=window_size,
        attention_chunk=attention_chunk)


def kernel_band(causal: bool, window_size: Window, attention_chunk: int,
                max_seqlen_q: int, max_seqlen_k: int):
    """(left, right, chunk, band) for the varlen C entry points: the window
    with each extent that reaches every key of every sequence dropped
    (reach_window over max_seqlen_q/k), and band 1 when a band remains (the
    band instantiations) or 0 (the band-free kernels)."""
    window = reach_window(window_size, causal, max_seqlen_q, max_seqlen_k)
    left, right, _, chunk = band_args(causal, window, 0, attention_chunk)
    return left, right, chunk, int(has_band(causal, window, attention_chunk))


def check_meta(name: str, meta, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
               max_seqlen_k, total_q: int, total_k: int, backward: bool):
    """Raise ValueError unless ``meta``'s lists have the lengths of the
    kernels' tiles: the forward's schedule of FWD_TILE rows, or the
    backward's VARLEN_BWD_TILE lists, bounded over this call's packed rows
    or over b x max_seqlen of them (get_scheduler_metadata's)."""
    b = cu_seqlens_q.numel() - 1
    if backward:
        want = {"q_tiles": (VARLEN_BWD_TILE.block_q, max_seqlen_q, total_q),
                "k_tiles": (VARLEN_BWD_TILE.block_k, max_seqlen_k, total_k)}
        want["schedule"] = want["q_tiles"]  # the dQ kernel's order
        want["k_schedule"] = want["k_tiles"]
    else:
        want = {"schedule": (FWD_TILE.block_q, max_seqlen_q, total_q)}
    for field, (block, max_seqlen, total) in want.items():
        n = getattr(meta, field).shape[0]
        if n not in (num_tiles_bound(b, max_seqlen, total, block),
                     num_tiles_bound(b, max_seqlen, b * max_seqlen, block)):
            raise ValueError(
                f"{name}: meta.{field} holds {n} tiles, not the kernels' "
                f"{block}-row ones (build it with get_scheduler_metadata, or "
                f"compute_varlen_meta(block_q={VARLEN_BWD_TILE.block_q}, "
                f"block_k={VARLEN_BWD_TILE.block_k}, schedule_block_q="
                f"{FWD_TILE.block_q}, schedule_block_k={FWD_TILE.block_k}))")


def _as_int32(x, device):
    return x.to(device, torch.int32).contiguous()


def launch_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k, meta, softmax_scale,
               causal: bool, persistent: bool = False, band=(-1, -1, 0, 0),
               softcap: float = 0.0, alibi_slopes=None, sink=None):
    """Allocate out (zeros) and lse (-inf, or the sink's fill: lse_fill)
    and launch, over the sorted work list ``meta.schedule`` of FWD_TILE
    rows, fa_varlen_fwd (B6) or, with ``persistent``,
    fa_varlen_fwd_persistent (B7); ``band`` is :func:`kernel_band`'s;
    ``softcap`` and ``alibi_slopes`` launch the score instantiation;
    ``sink`` is sink_arg's. Returns (out, lse, grid), grid 0 for the
    former."""
    total_q, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    out = torch.zeros((total_q, h, d), dtype=q.dtype, device=q.device)
    lse = lse_fill(sink, h, total_q, q.device)
    tiles = meta.schedule
    cu_q, cu_k, lens_q, lens_k = (_as_int32(x, q.device) for x in (
        cu_seqlens_q, cu_seqlens_k, meta.lens_q, meta.lens_k))
    slopes = seq_slopes(alibi_slopes, cu_seqlens_q, h, q.device)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), cu_q.data_ptr(), cu_k.data_ptr(),
            lens_q.data_ptr(), lens_k.data_ptr(), tiles.data_ptr(),
            tiles.shape[0], total_q, k.shape[0], h, k.shape[1], d,
            FWD_TILE.block_q, FWD_TILE.block_k, q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            out.stride(0), out.stride(1), scale, int(causal), *band,
            float(softcap), *slope_args(slopes), sink_ptr(sink),
            int(q.dtype == torch.bfloat16)]
    lib = _build.load_library()
    grid = ctypes.c_int(0)
    name = "fa_varlen_fwd_persistent" if persistent else "fa_varlen_fwd"
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if persistent:
            err = lib.fa_varlen_fwd_persistent(
                *args, num_sms(q.device.index), ctypes.byref(grid), stream)
        else:
            err = lib.fa_varlen_fwd(*args, stream)
    _build.check(err, name)
    return out, lse, grid.value


def flash_attention_varlen_fwd(
        q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q: int,
        max_seqlen_k: int, seqused_q=None, seqused_k=None,
        softmax_scale: Optional[float] = None, causal: bool = False,
        meta=None, window_size: Window = (None, None),
        attention_chunk: int = 0, softcap: float = 0.0, alibi_slopes=None,
        learnable_sink=None):
    """q (total_q, h, d), k/v (total_k, h_k, d) packed by cu_seqlens_q/k
    (b + 1,); seqused_q/k (b,) true lengths or None; ``max_seqlen_q/k``
    bound the sequences' lengths; ``meta`` a precomputed VarlenMeta whose
    schedule has the kernel's 128-row tiles (FWD_TILE; get_scheduler_metadata
    builds one); ``window_size`` (left, right; None for no bound) and
    ``attention_chunk`` per sequence; ``softcap`` (0: none) and
    ``alibi_slopes`` ((h,) or (b, h), a row a sequence) and
    ``learnable_sink`` (h,) as the dense forward's. Returns (out (total_q,
    h, d) in q's type, lse (h, total_q) fp32). CUDA: one block per (128-row
    q tile, head), the longest KV bands first."""
    if q.device.type == "cpu":
        return flash_attention_varlen_fwd_plain(
            q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
            seqused_q, seqused_k, softmax_scale, causal, window_size,
            attention_chunk, softcap, alibi_slopes, learnable_sink)
    check_kernel_inputs("flash_varlen_fwd", q, k, v, cu_seqlens_q,
                        cu_seqlens_k)
    sink = sink_arg("flash_varlen_fwd", learnable_sink, q.shape[1], q.device)
    if meta is not None:
        check_meta("flash_varlen_fwd", meta, cu_seqlens_q, cu_seqlens_k,
                   max_seqlen_q, max_seqlen_k, q.shape[0], k.shape[0],
                   backward=False)
    if q.shape[0] == 0 or k.shape[0] == 0:  # no row sees a key
        return (torch.zeros_like(q),
                lse_fill(sink, q.shape[1], q.shape[0], q.device))
    meta = varlen_meta(q, k, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                       max_seqlen_k, seqused_q, seqused_k, causal, meta,
                       window_size, attention_chunk)
    band = kernel_band(causal, window_size, attention_chunk, max_seqlen_q,
                       max_seqlen_k)
    out, lse, _ = launch_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k, meta,
                             softmax_scale, causal, band=band,
                             softcap=softcap, alibi_slopes=alibi_slopes,
                             sink=sink)
    global launches_fwd, launches_fwd_band, launches_fwd_score
    global launches_fwd_sink
    launches_fwd += 1
    launches_fwd_band += band[-1]
    launches_fwd_score += has_score(softcap, alibi_slopes)
    launches_fwd_sink += sink is not None
    return out, lse


def varlen_bwd_preprocess(do, out, lse, cu_seqlens_q, cu_seqlens_k, meta,
                          dq, dk, dv):
    """The preprocess kernel: (delta, lse2) as varlen_bwd_preprocess_plain
    on the rows of ``meta.q_tiles``' 128-row tiles (the other rows are left
    unwritten), reading dO and O once in their own type; it also zeroes the
    rows of dq (total_q, h, d) and dk, dv (total_k, h_k, d), contiguous
    tensors on the card, that lie in no sequence. do/out (total_q, h, d)
    with the head dim contiguous, lse (h, total_q) fp32 contiguous. A
    tensor on the CPU takes the plain version (and zeroes dq, dk, dv)."""
    seqused_q = meta.lens_q
    if do.device.type == "cpu":
        for g in (dq, dk, dv):
            g.zero_()
        return varlen_bwd_preprocess_plain(do, out, lse, cu_seqlens_q,
                                           seqused_q)
    total_q, h, d = do.shape
    total_k, h_k, _ = dk.shape
    b = cu_seqlens_q.numel() - 1
    for name, x in (("do", do), ("out", out)):
        _build.check_operand("flash_varlen_bwd_preprocess", name, x, do.dtype,
                             do.device)
    if lse.shape != (h, total_q) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or not all(
                g.is_contiguous() for g in (dq, dk, dv)):
        raise ValueError("flash_varlen_bwd_preprocess kernel: lse must be a "
                         "contiguous (h, total_q) fp32 tensor and the "
                         "gradients contiguous")
    rows = padded_rows(total_q, b)
    delta = torch.empty((h, rows), dtype=torch.float32, device=do.device)
    lse2 = torch.empty_like(delta)
    cu_q, cu_k, lens_q, lens_k = (_as_int32(x, do.device) for x in (
        cu_seqlens_q, cu_seqlens_k, meta.lens_q, meta.lens_k))
    global launches_preprocess
    with torch.cuda.device(do.device):
        err = _build.load_library().fa_varlen_bwd_preprocess(
            do.data_ptr(), out.data_ptr(), lse.data_ptr(), lse2.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            cu_q.data_ptr(), cu_k.data_ptr(), lens_q.data_ptr(),
            lens_k.data_ptr(), meta.q_tiles.data_ptr(),
            meta.q_tiles.shape[0], b, total_q, total_k, h, h_k, d, rows,
            do.stride(0), do.stride(1), out.stride(0), out.stride(1),
            int(do.dtype == torch.bfloat16),
            torch.cuda.current_stream(do.device).cuda_stream)
        _build.check(err, "fa_varlen_bwd_preprocess")
        launches_preprocess += 1
    return delta, lse2


def flash_attention_varlen_bwd(
        do, q, k, v, out, lse, cu_seqlens_q, cu_seqlens_k, max_seqlen_q: int,
        max_seqlen_k: int, seqused_q=None, seqused_k=None,
        softmax_scale: Optional[float] = None, causal: bool = False,
        meta=None, window_size: Window = (None, None),
        attention_chunk: int = 0, softcap: float = 0.0, alibi_slopes=None,
        learnable_sink=None):
    """dq, dk, dv of packed varlen attention saved by a varlen forward.
    do/out (total_q, h, d), lse (h, total_q); the rest as
    :func:`flash_attention_varlen_fwd`. Returns (dq, dk, dv) in the inputs'
    types. CUDA: the preprocess kernel (delta, lse in base 2, the rows in
    no sequence zeroed), then the dK/dV kernel (one block per (128-key
    tile, KV head), the group's heads summed in the block) and the dQ
    kernel (one block per (128-row q tile, head)), each writing its
    gradient once: deterministic; with a band, the dK/dV and dQ kernels'
    band instantiations, with softcap or ALiBi their score instantiations.
    The operands are read by TMA: a view whose strides are not multiples of
    16 bytes, or whose start is not 16-byte aligned, raises ValueError.
    ``learnable_sink`` (h,): the forward's sink, whose gradient, (h,) fp32
    from the preprocess's delta and lse (:func:`varlen_sink_grad`), follows
    dv in the result."""
    if q.device.type == "cpu":
        return flash_attention_varlen_bwd_plain(
            do, q, k, v, out, lse, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
            max_seqlen_k, seqused_q, seqused_k, softmax_scale, causal,
            window_size, attention_chunk, softcap, alibi_slopes,
            learnable_sink)
    check_kernel_inputs("flash_varlen_bwd", q, k, v, cu_seqlens_q,
                        cu_seqlens_k)
    total_q, h, d = q.shape
    total_k, h_k, _ = k.shape
    if do.shape != q.shape or out.shape != q.shape \
            or lse.shape != (h, total_q):
        raise ValueError(
            f"flash_varlen_bwd kernel: shapes q {tuple(q.shape)}, do "
            f"{tuple(do.shape)}, out {tuple(out.shape)}, lse {tuple(lse.shape)}")
    _build.check_operand("flash_varlen_bwd", "do", do, q.dtype, q.device)
    sink = sink_arg("flash_varlen_bwd", learnable_sink, h, q.device)
    if meta is not None:
        check_meta("flash_varlen_bwd", meta, cu_seqlens_q, cu_seqlens_k,
                   max_seqlen_q, max_seqlen_k, total_q, total_k,
                   backward=True)
    if total_q == 0 or total_k == 0:  # no row sees a key: out and dsink 0
        grads = tuple(torch.zeros_like(x) for x in (q, k, v))
        return grads if sink is None else grads + (torch.zeros_like(sink),)
    meta = varlen_meta(q, k, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                       max_seqlen_k, seqused_q, seqused_k, causal, meta,
                       window_size, attention_chunk)
    band = kernel_band(causal, window_size, attention_chunk, max_seqlen_q,
                       max_seqlen_k)
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    dq = torch.empty((total_q, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((total_k, h_k, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((total_k, h_k, d), dtype=v.dtype, device=q.device)
    delta, lse2 = varlen_bwd_preprocess(do, out, lse.float().contiguous(),
                                        cu_seqlens_q, cu_seqlens_k, meta,
                                        dq, dk, dv)
    cu_q, cu_k, lens_q, lens_k = (_as_int32(x, q.device) for x in (
        cu_seqlens_q, cu_seqlens_k, meta.lens_q, meta.lens_k))
    tile = VARLEN_BWD_TILE
    common = [cu_q.data_ptr(), cu_k.data_ptr(), lens_q.data_ptr(),
              lens_k.data_ptr()]
    shape = [cu_seqlens_q.numel() - 1, total_q, total_k, h, h_k, d,
             tile.block_q, tile.block_k, delta.shape[1], q.stride(0),
             q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
             do.stride(0), do.stride(1)]
    operands = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse2.data_ptr(), delta.data_ptr()]
    slopes = seq_slopes(alibi_slopes, cu_seqlens_q, h, q.device)
    score = has_score(softcap, alibi_slopes)
    tail = [scale, int(causal), *band, float(softcap), *slope_args(slopes),
            int(q.dtype == torch.bfloat16)]
    lib = _build.load_library()
    global launches_dkdv, launches_dq, launches_dkdv_band, launches_dq_band
    global launches_dkdv_score, launches_dq_score
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_varlen_bwd_dkdv(
            *operands, dk.data_ptr(), dv.data_ptr(), *common,
            meta.k_schedule.data_ptr(), meta.k_schedule.shape[0], *shape,
            dk.stride(0), dk.stride(1), dv.stride(0), dv.stride(1), *tail,
            stream)
        _build.check(err, "fa_varlen_bwd_dkdv")
        launches_dkdv += 1
        launches_dkdv_band += band[-1]
        launches_dkdv_score += score
        err = lib.fa_varlen_bwd_dq(
            *operands, dq.data_ptr(), *common, meta.schedule.data_ptr(),
            meta.schedule.shape[0], *shape, dq.stride(0), dq.stride(1),
            *tail, stream)
        _build.check(err, "fa_varlen_bwd_dq")
        launches_dq += 1
        launches_dq_band += band[-1]
        launches_dq_score += score
    if sink is None:
        return dq, dk, dv
    return dq, dk, dv, varlen_sink_grad(sink, lse, delta, cu_seqlens_q,
                                        meta.lens_q)


def varlen_sink_grad(sink, lse, delta, cu_seqlens_q, lens_q):
    """dsink (h,) fp32 from the backward preprocess's padded delta (h,
    padded_rows) and lse (h, total_q): each packed row of a sequence reads
    its padded row (padded_row), a row in no sequence (whose out is 0)
    weighs 0."""
    h, total_q = lse.shape
    cu = cu_seqlens_q.to(lse.device, torch.long)
    b = cu.numel() - 1
    tok = torch.arange(total_q, device=lse.device)
    seq = (torch.searchsorted(cu, tok, right=True) - 1).clamp(0, b - 1)
    pos = tok - cu[seq]
    live = (tok >= cu[0]) & (tok < cu[b]) & (pos < lens_q.to(
        lse.device, torch.long)[seq])
    row = torch.where(live, (cu[seq] + 3) // 4 * 4 + SEQ_GAP * seq + pos, 0)
    rows = torch.where(live[None], delta[:, row], 0.0)
    return sink_grad(sink, lse.float(), rows, 0)
