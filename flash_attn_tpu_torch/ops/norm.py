"""Residual-add + LayerNorm / RMSNorm (port of flash_attn_tpu/ops/norm.py).

    out = norm(dropout(x0) * rowscale + residual)

with the pre-norm sum optionally returned for the residual stream. The
norm runs in fp32 with fp32 weights and is cast back to x's type; the
residual sum is taken in fp32 and kept in fp32 when the residual is fp32,
else in x0's type. Dropout p > 0 raises: the JAX trainer never turns it on
(its model runs deterministic=True), and it is ROADMAP.md queue A, item 7.
"""

import torch

__all__ = [
    "layer_norm",
    "rms_norm",
    "dropout_add_layer_norm",
    "dropout_add_rms_norm",
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


def _add(x0, residual, dropout_p: float, rowscale):
    if dropout_p > 0.0:
        raise NotImplementedError(
            "dropout_add_*_norm: dropout_p > 0 is not ported yet: dropout "
            "is ROADMAP.md queue A, item 7 (the JAX trainer runs without it)")
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
