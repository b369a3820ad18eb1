"""Transformer blocks (port of the JAX package's modules/block.py
``Block`` and ``ParallelBlock``): pre-norm (default) or post-norm
residual around a mixer and an MLP, or the mixer and the MLP side by side
on one residual (GPT-J, GPT-NeoX, Falcon), with the residual-add-norm of
ops/norm.py. The norm weights are fp32."""

from typing import Optional

import torch
from torch import nn

from flash_attn_tpu_torch.modules.mha import KVCache
from flash_attn_tpu_torch.ops.norm import (
    dropout_add_layer_norm,
    dropout_add_rms_norm,
    layer_norm,
    rms_norm,
)
from flash_attn_tpu_torch.utils.device import resolve_device


def _norm_param(dim: int, fill: float, device) -> nn.Parameter:
    return nn.Parameter(torch.full((dim,), fill, dtype=torch.float32,
                                   device=device))


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

        self.norm1_weight = _norm_param(dim, 1.0, device)
        self.norm2_weight = _norm_param(dim, 1.0, device)
        if use_rms_norm:
            self.norm1_bias = self.norm2_bias = None
        else:
            self.norm1_bias = _norm_param(dim, 0.0, device)
            self.norm2_bias = _norm_param(dim, 0.0, device)

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


class ParallelBlock(nn.Module):
    """The mixer and the MLP both read the normed residual and their outputs
    are summed (GPT-J, GPT-NeoX, Falcon). With ``tied_norm`` one norm feeds
    both (GPT-J, Falcon-7B); untied, the MLP reads a second norm of the same
    residual (``norm2_weight``/``norm2_bias``: GPT-NeoX, Falcon's new
    decoder architecture)."""

    def __init__(self, dim: int, mixer: nn.Module, mlp: nn.Module,
                 use_rms_norm: bool = False, norm_epsilon: float = 1e-5,
                 tied_norm: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.mixer = mixer
        self.mlp = mlp
        self.use_rms_norm = use_rms_norm
        self.norm_epsilon = norm_epsilon
        self.norm_weight = _norm_param(dim, 1.0, device)
        self.norm_bias = None if use_rms_norm else _norm_param(dim, 0.0, device)
        self.norm2_weight = self.norm2_bias = None
        if not tied_norm:
            self.norm2_weight = _norm_param(dim, 1.0, device)
            self.norm2_bias = (None if use_rms_norm
                               else _norm_param(dim, 0.0, device))

    def forward(self, hidden_states, residual=None, mode: str = "train",
                cache: Optional[KVCache] = None, **mixer_kwargs):
        """Returns (mixer out + mlp out, residual), as JAX's block does."""
        eps = self.norm_epsilon
        if self.use_rms_norm:
            normed, residual = dropout_add_rms_norm(
                hidden_states, residual, self.norm_weight, epsilon=eps,
                prenorm=True)
        else:
            normed, residual = dropout_add_layer_norm(
                hidden_states, residual, self.norm_weight, self.norm_bias,
                epsilon=eps, prenorm=True)
        normed2 = normed
        if self.norm2_weight is not None:
            # the residual in the compute type, as JAX casts it (block.py:107)
            res = residual.to(hidden_states.dtype)
            normed2 = (rms_norm(res, self.norm2_weight, eps)
                       if self.use_rms_norm else
                       layer_norm(res, self.norm2_weight, self.norm2_bias, eps))
        attn_out = self.mixer(normed, mode=mode, cache=cache, **mixer_kwargs)
        return attn_out + self.mlp(normed2), residual
