"""Token embeddings (port of the JAX package's modules/embedding.py
``GPT2Embeddings`` and models/gpt.py ``_Embeddings``): word
embeddings plus, when ``max_position_embeddings`` > 0, a learned position
table added to them (OPT, StarCoder, GPT-2), in the compute type.

The caller gives the positions. JAX defaults them to ``arange(s)`` and no
serving path passes others, so its decode embeds every new token at
position 0 (models/gpt.py:120); the port's GPT computes them from the
cache offsets instead (:meth:`flash_attn_tpu_torch.models.gpt.GPTModel.positions`).
"""

from typing import Optional

import torch
from torch import nn

from flash_attn_tpu_torch.utils.device import resolve_device

__all__ = ["GPT2Embeddings"]


class GPT2Embeddings(nn.Module):
    def __init__(self, embed_dim: int, vocab_size: int,
                 max_position_embeddings: int = 0, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.word_embeddings = nn.Embedding(vocab_size, embed_dim, dtype=dtype,
                                            device=device)
        self.position_embeddings = (
            nn.Embedding(max_position_embeddings, embed_dim, dtype=dtype,
                         device=device)
            if max_position_embeddings > 0 else None)

    def forward(self, input_ids, position_ids: Optional[torch.Tensor] = None):
        """input_ids (b, s); position_ids (b, s) or (1, s), default
        ``arange(s)``, used only with a position table."""
        x = self.word_embeddings(input_ids)
        if self.position_embeddings is not None:
            if position_ids is None:
                position_ids = torch.arange(input_ids.shape[-1],
                                            device=input_ids.device)[None]
            x = x + self.position_embeddings(position_ids)
        return x
