"""Transformer block (port of flash_attn_tpu/modules/block.py ``Block``):
pre-norm (default) or post-norm residual around a mixer and an MLP, with
the residual-add-norm of ops/norm.py. The norm weights are fp32."""

from typing import Optional

import torch
from torch import nn

from flash_attn_tpu_torch.modules.mha import KVCache
from flash_attn_tpu_torch.ops.norm import (
    dropout_add_layer_norm,
    dropout_add_rms_norm,
)
from flash_attn_tpu_torch.utils.device import resolve_device


class Block(nn.Module):
    def __init__(self, dim: int, mixer: nn.Module, mlp: nn.Module,
                 prenorm: bool = True, use_rms_norm: bool = False,
                 norm_epsilon: float = 1e-5, device=None):
        super().__init__()
        device = resolve_device(device)
        self.mixer = mixer
        self.mlp = mlp
        self.prenorm = prenorm
        self.use_rms_norm = use_rms_norm
        self.norm_epsilon = norm_epsilon

        def param(fill):
            return nn.Parameter(torch.full((dim,), fill, dtype=torch.float32,
                                           device=device))

        self.norm1_weight = param(1.0)
        self.norm2_weight = param(1.0)
        if use_rms_norm:
            self.norm1_bias = self.norm2_bias = None
        else:
            self.norm1_bias = param(0.0)
            self.norm2_bias = param(0.0)

    def forward(self, hidden_states, residual=None, mode: str = "train",
                cache: Optional[KVCache] = None, **mixer_kwargs):
        """Returns (hidden_states, residual); the residual is None in the
        post-norm form. ``mixer_kwargs`` (the serving engine's slot_ids,
        prefill_lengths, prefix_lengths, block_table) go to the mixer."""
        norm = dropout_add_rms_norm if self.use_rms_norm else dropout_add_layer_norm
        eps = self.norm_epsilon
        if self.prenorm:
            normed, residual = norm(hidden_states, residual, self.norm1_weight,
                                    self.norm1_bias, epsilon=eps, prenorm=True)
            attn_out = self.mixer(normed, mode=mode, cache=cache, **mixer_kwargs)
            normed2, residual = norm(attn_out, residual, self.norm2_weight,
                                     self.norm2_bias, epsilon=eps, prenorm=True)
            return self.mlp(normed2), residual
        attn_out = self.mixer(hidden_states, mode=mode, cache=cache,
                              **mixer_kwargs)
        hidden_states = norm(attn_out, hidden_states, self.norm1_weight,
                             self.norm1_bias, epsilon=eps)
        mlp_out = self.mlp(hidden_states)
        hidden_states = norm(mlp_out, hidden_states, self.norm2_weight,
                             self.norm2_bias, epsilon=eps)
        return hidden_states, None
