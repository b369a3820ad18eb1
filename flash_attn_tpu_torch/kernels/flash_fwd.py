"""Dense attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` (the
wgmma/TMA tile of csrc/fwd_sm90.cuh) and its plain PyTorch version.

Port of flash_attn_tpu/kernels/flash_fwd.py ``flash_attention_fwd`` (and of
the causal split in flash_fwd_split.py, whose diagonal work the one CUDA
kernel does in a masked phase), with its band masks: ``window_size``,
``attention_chunk`` and ``sink_token_length`` (dispatch/band.py). A call
with a band launches the kernel's band instantiation, which walks only the
key tiles of the band; one without launches the band-free one, which is
the kernel of the earlier releases bit for bit. ``softcap`` and
``alibi_slopes`` (dispatch/score.py) launch the kernel's score
instantiation, with or without the band. ``learnable_sink`` (dispatch/
sink.py) runs in every instantiation's epilogue, read from a runtime
pointer. v may have a head dim of its own, 128 beside q's and k's 192
(DeepSeek's MLA when it is not absorbed: HEAD_DIM_PAIRS), in an
instantiation of its own (csrc/flash_fwd_192.cu) without the band and the
score map. Layout (b, h, s, d) as in the JAX function.
A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises (TMA takes only 16-byte aligned starts and strides: any
other view raises ValueError, nothing is copied).
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
    DENSE_HEAD_DIMS,
    FWD_TILE,
    check_head_dims,
    refuse_dv_forms,
    scale_log2,
)
from flash_attn_tpu_torch.dispatch.score import (
    alibi_bias,
    has_score,
    score_map,
    slope_args,
    slopes_bh,
)
from flash_attn_tpu_torch.dispatch.sink import sink_arg, sink_ptr, with_sink
from flash_attn_tpu_torch.kernels import _build


# Kernel launches since the last reset (plain calls not counted): all of
# them, and those of the band and of the score instantiations, those with a
# learnable sink and those at a v head dim of its own (192 / 128) among
# them.
launches = 0
launches_band = 0
launches_score = 0
launches_sink = 0
launches_dv = 0

Window = Tuple[Optional[int], Optional[int]]


def flash_attention_fwd_plain(q, k, v, softmax_scale: Optional[float] = None,
                              causal: bool = False,
                              window_size: Window = (None, None),
                              sink_token_length: int = 0,
                              attention_chunk: int = 0, softcap: float = 0.0,
                              alibi_slopes=None, learnable_sink=None):
    """Matmul, score map (dispatch/score.py), mask and softmax in fp32. q
    (b, h, sq, d), k/v (b, h_k, sk, d/dv); alibi_slopes (h,) or (b, h);
    learnable_sink (h,) one more logit in each row's softmax. Returns out
    (b, h, sq, dv) in q's type and the natural-log lse (b, h, sq) in fp32,
    -inf (the sink with one) and out 0 for rows that see no key."""
    sink = sink_arg("flash_fwd", learnable_sink, q.shape[1], q.device)
    b, h, sq, d = q.shape
    h_k, sk = k.shape[1], k.shape[2]
    group = h // h_k
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    slopes = slopes_bh(alibi_slopes, b, h, q.device)
    if slopes is not None:
        slopes = slopes[..., None, None]
    s = score_map(s, softcap, slopes, alibi_bias(rows, cols, sq, sk, causal))
    if causal or has_band(causal, window_size, attention_chunk):
        valid = band_valid(rows, cols, sk - sq, causal, window_size,
                           sink_token_length, attention_chunk)
        s = s.masked_fill(~valid, float("-inf"))
    lse = with_sink(torch.logsumexp(s, dim=-1), sink)
    seen = torch.isfinite(lse)
    p = torch.exp(s - torch.where(seen, lse, 0.0)[..., None])
    out = torch.matmul(p, vf).to(q.dtype)
    return out, lse


def flash_attention_fwd(q, k, v, softmax_scale: Optional[float] = None,
                        causal: bool = False,
                        window_size: Window = (None, None),
                        sink_token_length: int = 0,
                        attention_chunk: int = 0, softcap: float = 0.0,
                        alibi_slopes=None, learnable_sink=None):
    """q (b, h, sq, d), k (b, h_k, sk, d), v (b, h_k, sk, dv), any strides
    with the head dim contiguous. Returns (out (b, h, sq, dv) in q's type,
    lse (b, h, sq) fp32). CUDA: bf16/fp16, d = dv in HEAD_DIMS (64, 80, 96,
    128, 256) or (d, dv) = (192, 128) (DENSE_HEAD_DIMS: neither the band
    nor the score map there, NotImplementedError), h % h_k == 0.
    ``window_size`` (left, right) with None for no bound,
    ``sink_token_length`` and ``attention_chunk`` as in the JAX function
    (dispatch/band.py); ``softcap`` (0: none) and ``alibi_slopes`` ((h,) or
    (b, h), read in fp32) as in JAX's (dispatch/score.py);
    ``learnable_sink`` (h,) on q's device, any float type, read in fp32
    (dispatch/sink.py)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, softmax_scale, causal, window_size, sink_token_length,
            attention_chunk, softcap, alibi_slopes, learnable_sink)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    b, h, sq, d = q.shape
    bk_, h_k, sk, dk = k.shape
    dv = v.shape[-1]
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"flash_fwd kernel: dtype {q.dtype} (bf16/fp16 only)")
    check_head_dims("flash_fwd", d, dk, dv, DENSE_HEAD_DIMS)
    if bk_ != b or h % h_k or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_fwd kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if b > 65535 or h > 65535:
        raise ValueError("flash_fwd kernel: batch and heads must be <= 65535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _build.check_operand("flash_fwd", name, x, q.dtype, q.device)
    sink = sink_arg("flash_fwd", learnable_sink, h, q.device)
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    window = reach_window(window_size, causal, sq, sk)
    band = has_band(causal, window, attention_chunk)
    refuse_dv_forms("flash_fwd", d, dv, band,
                    has_score(softcap, alibi_slopes))
    # out is allocated (b, sq, h, dv) so that the public bshd result is
    # contiguous; it is returned as its (b, h, sq, dv) view.
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq == 0 or b == 0:
        return out.transpose(1, 2), lse
    if sk == 0:  # no row sees a key: nothing to launch
        out.zero_()
        if sink is None:
            lse.fill_(float("-inf"))
        else:
            lse.copy_(sink[None, :, None].expand(b, h, sq))
        return out.transpose(1, 2), lse
    slopes = slopes_bh(alibi_slopes, b, h, q.device)
    slope_ptr, slope_sb = slope_args(slopes)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.fa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, h_k, d, dv,
            FWD_TILE.block_q, FWD_TILE.block_k,
            q.stride(0), q.stride(2), q.stride(1),
            k.stride(0), k.stride(2), k.stride(1),
            v.stride(0), v.stride(2), v.stride(1),
            out.stride(0), out.stride(1), out.stride(2),
            scale_log2(scale), int(causal),
            *band_args(causal, window, sink_token_length, attention_chunk),
            int(band), float(softcap), slope_ptr, slope_sb, sink_ptr(sink),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fa_fwd")
    global launches, launches_band, launches_score, launches_sink
    global launches_dv
    launches += 1
    launches_band += band
    launches_score += has_score(softcap, alibi_slopes)
    launches_sink += sink is not None
    launches_dv += dv != d
    return out.transpose(1, 2), lse
