"""Residual-add + LayerNorm / RMSNorm (port of flash_attn_tpu/ops/norm.py).

    out = norm(dropout(x0) * rowscale + residual)

with the pre-norm sum optionally returned for the residual stream, the
parallel-residual form (two streams, one residual add, two norms of the
sum) and the subset (drop-path) forms, which scatter the kept rows of x0
into the stream and keep only the rows an output mask selects. The norm
runs in fp32 with fp32 weights and is cast back to x's type; the residual
sum is taken in fp32 and rounded as the JAX package rounds it. Dropout p >
0 raises: the JAX trainer never turns it on (its model runs
deterministic=True), and it is ROADMAP.md queue A, item 7.
"""

import torch

__all__ = [
    "layer_norm",
    "rms_norm",
    "dropout_add_layer_norm",
    "dropout_add_rms_norm",
    "dropout_add_layer_norm_parallel_residual",
    "dropout_add_layer_norm_subset",
    "dropout_add_rms_norm_subset",
]


def layer_norm(x, weight, bias=None, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _no_dropout(dropout_p: float) -> None:
    if dropout_p > 0.0:
        raise NotImplementedError(
            "dropout_add_*_norm: dropout_p > 0 is not ported yet: dropout "
            "is ROADMAP.md queue A, item 7 (the JAX trainer runs without it)")


def _add(x0, residual, dropout_p: float, rowscale):
    _no_dropout(dropout_p)
    pre = x0
    if rowscale is not None:
        pre = pre * rowscale[..., None].to(pre.dtype)
    if residual is not None:
        out_dtype = residual.dtype if residual.dtype == torch.float32 else x0.dtype
        pre = (pre.float() + residual.float()).to(out_dtype)
    return pre


def dropout_add_layer_norm(x0, residual, weight, bias=None,
                           dropout_p: float = 0.0, epsilon: float = 1e-5,
                           rowscale=None, prenorm: bool = False):
    """out = LN(x0 * rowscale + residual); prenorm also returns the sum."""
    pre = _add(x0, residual, dropout_p, rowscale)
    out = layer_norm(pre, weight, bias, epsilon)
    return (out, pre) if prenorm else out


def dropout_add_rms_norm(x0, residual, weight, bias=None,
                         dropout_p: float = 0.0, epsilon: float = 1e-6,
                         rowscale=None, prenorm: bool = False):
    """out = RMSNorm(x0 * rowscale + residual); prenorm also returns the
    sum. ``bias`` is accepted for a common signature and unused, as in the
    JAX package."""
    pre = _add(x0, residual, dropout_p, rowscale)
    out = rms_norm(pre, weight, epsilon)
    return (out, pre) if prenorm else out


def dropout_add_layer_norm_parallel_residual(
        x0, x1, residual, weight0, bias0, weight1=None, bias1=None,
        dropout_p: float = 0.0, epsilon: float = 1e-5,
        prenorm: bool = False):
    """Two streams, one residual add, two norms of the sum: pre = x0 + x1
    (x1 may be None) + residual, out0 = LN(pre; weight0, bias0) and out1 =
    LN(pre; weight1, bias1), or None without weight1. Returns (out0, out1)
    and, with prenorm, pre as well."""
    _no_dropout(dropout_p)
    pre = x0 if x1 is None else x0 + x1
    if residual is not None:
        pre = (pre.float() + residual.float()).to(x0.dtype)
    out0 = layer_norm(pre, weight0, bias0, epsilon)
    out1 = None if weight1 is None else layer_norm(pre, weight1, bias1,
                                                   epsilon)
    return (out0, out1, pre) if prenorm else (out0, out1)


def _subset_norm(x0, residual, weight, bias, dropout_p, epsilon, layerscale,
                 x0_subset, out_subset, rowscale_const, out_numrows, prenorm,
                 use_rms):
    """The subset (drop-path) variants' shared body. x0 holds only the kept
    rows, packed; x0_subset (b, s) gives each stream row's 1-based row of x0
    (0: dropped, its sum is the residual alone). The kept rows are scaled
    by layerscale (per column) and rowscale_const, scattered into the
    stream, added to the residual and normed; the output keeps the
    out_numrows first rows where out_subset > 0, in order (row 0 of the
    normed stream fills the count when fewer are selected, as JAX's
    nonzero(size=) pads)."""
    _no_dropout(dropout_p)
    b, s_ = x0_subset.shape
    d = x0.shape[-1]
    if layerscale is not None:
        x0 = x0 * layerscale.to(x0.dtype)
    x0 = x0 * rowscale_const
    flat = x0_subset.reshape(-1).long()
    rows = x0.float()[(flat - 1).clamp(0, x0.shape[0] - 1)]
    pre = torch.where((flat > 0)[:, None], rows, 0.0).reshape(b, s_, d)
    if residual is not None:
        pre = pre + residual.float()
    pre = pre.to(residual.dtype if residual is not None else x0.dtype)
    normed = (rms_norm(pre, weight, epsilon) if use_rms
              else layer_norm(pre, weight, bias, epsilon))
    idx = torch.nonzero(out_subset.reshape(-1) > 0).flatten()[:out_numrows]
    idx = torch.nn.functional.pad(idx, (0, int(out_numrows) - idx.numel()))
    out = normed.reshape(-1, d)[idx]
    return (out, pre) if prenorm else out


def dropout_add_layer_norm_subset(
        x0, residual, weight, bias, dropout_p, epsilon, layerscale=None,
        x0_subset=None, out_subset=None, rowscale_const: float = 1.0,
        out_numrows: int = 0, prenorm: bool = False):
    """LayerNorm over the drop-path stream (see _subset_norm)."""
    return _subset_norm(x0, residual, weight, bias, dropout_p, epsilon,
                        layerscale, x0_subset, out_subset, rowscale_const,
                        out_numrows, prenorm, use_rms=False)


def dropout_add_rms_norm_subset(
        x0, residual, weight, dropout_p, epsilon, layerscale=None,
        x0_subset=None, out_subset=None, rowscale_const: float = 1.0,
        out_numrows: int = 0, prenorm: bool = False):
    """RMSNorm over the drop-path stream (see _subset_norm)."""
    return _subset_norm(x0, residual, weight, None, dropout_p, epsilon,
                        layerscale, x0_subset, out_subset, rowscale_const,
                        out_numrows, prenorm, use_rms=True)
