"""MLP modules (port of flash_attn_tpu/modules/mlp.py ``Mlp`` and
``GatedMlp``). torch ``Linear`` weights are (out, in); the converter in
models/gpt.py transposes flax's (in, out) kernels."""

from typing import Callable, Optional

import torch
from torch import nn

from flash_attn_tpu_torch.ops.activations import gelu_approx, swiglu
from flash_attn_tpu_torch.utils.device import resolve_device


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 activation: Callable = gelu_approx, bias1: bool = True,
                 bias2: bool = True, dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        out_features = out_features or in_features
        self.activation = activation
        self.fc1 = nn.Linear(in_features, hidden_features, bias=bias1,
                             dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden_features, out_features, bias=bias2,
                             dtype=dtype, device=device)

    def forward(self, x):
        return self.fc2(self.activation(self.fc1(x)))


class GatedMlp(nn.Module):
    """SwiGLU / GeGLU MLP: fc1 gives [gate | y] (gate is the first half),
    the hidden width rounded up to a multiple of ``multiple_of``."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 activation: Callable = swiglu, bias1: bool = False,
                 bias2: bool = False, multiple_of: int = 128,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        out_features = out_features or in_features
        hidden = -(-hidden_features // multiple_of) * multiple_of
        self.activation = activation
        self.fc1 = nn.Linear(in_features, 2 * hidden, bias=bias1, dtype=dtype,
                             device=device)
        self.fc2 = nn.Linear(hidden, out_features, bias=bias2, dtype=dtype,
                             device=device)

    def forward(self, x):
        gate, y = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(self.activation(gate, y))
