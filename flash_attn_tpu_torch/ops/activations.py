"""Activation helpers (port of flash_attn_tpu/ops/activations.py)."""

import torch
import torch.nn.functional as F

__all__ = ["bias_gelu", "gelu_approx", "sqrelu", "swiglu"]


def gelu_approx(x):
    """tanh-approximated GELU."""
    return F.gelu(x, approximate="tanh")


def bias_gelu(y, bias):
    """gelu_approx(y + bias)."""
    return gelu_approx(y + bias)


def sqrelu(x):
    r = torch.relu(x)
    return r * r


def swiglu(gate, y):
    return F.silu(gate) * y
