"""Activation helpers (port of flash_attn_tpu/ops/activations.py)."""

import torch
import torch.nn.functional as F

__all__ = ["gelu_approx", "sqrelu", "swiglu"]


def gelu_approx(x):
    """tanh-approximated GELU."""
    return F.gelu(x, approximate="tanh")


def sqrelu(x):
    r = torch.relu(x)
    return r * r


def swiglu(gate, y):
    return F.silu(gate) * y
