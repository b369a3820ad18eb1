"""BERT encoder family (port of flash_attn_tpu/models/bert.py).

Post-norm blocks with exact GELU and fp32 LayerNorm parameters, learned
position and token-type embeddings, the pooler, the MLM head (with the
``masked_positions`` gather that runs the vocab projection only at the
masked tokens) and the NSP head. Attention is non-causal: an input without
a mask runs the dense ``flash_attn_func`` (B1); any attention mask packs the
valid tokens with ``unpad_input`` and runs ``flash_attn_varlen_func`` (the
persistent forward B7, the B6 backward), then ``pad_input`` scatters them
back (pad positions get what the packed tail computes, zeros at zero
biases). The varlen work lists are computed once per forward
(``get_scheduler_metadata``) and shared by every layer.

``bert_config_from_hf`` and ``remap_state_dict_hf_bert`` take a Hugging
Face config object and state dict without importing ``transformers``;
``load_jax_params`` fills a model from a flax param tree of numpy arrays
(the JAX model's, or the remapped checkpoint's). Parameters mirror flax's
values: Dense and embedding weights in the compute type, norm weights in
fp32. The JAX default type is float32; on the card the kernels take bf16
or fp16 only.
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flash_attn_tpu_torch.dispatch.scheduler_metadata import (
    get_scheduler_metadata,
)
from flash_attn_tpu_torch.interface import (
    flash_attn_func,
    flash_attn_varlen_func,
)
from flash_attn_tpu_torch.models.gpt import reset_flax_defaults
from flash_attn_tpu_torch.ops.norm import layer_norm
from flash_attn_tpu_torch.utils.device import resolve_device
from flash_attn_tpu_torch.utils.padding import pad_input, unpad_input

__all__ = [
    "BertConfig", "BertModel", "BertForMaskedLM", "BertForPreTraining",
    "bert_config_from_hf", "bert_large", "load_jax_params",
    "remap_state_dict_hf_bert",
]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    use_unpadded: bool = False  # the reference's flag; masked inputs pack
    dtype: torch.dtype = torch.float32


def bert_large(dtype=torch.bfloat16) -> BertConfig:
    """BERT-large at its published width and depth (Hugging Face
    ``bert-large-uncased`` config.json): hidden 1024, 24 layers of 16 heads
    of 64, intermediate 4096, vocab 30522, 512 positions, 2 token types."""
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096,
                      dtype=dtype)


def _norm_params(module: nn.Module, prefix: str, dim: int, device) -> None:
    """``{prefix}_weight`` (ones) and ``{prefix}_bias`` (zeros), fp32."""
    for suffix, fill in (("weight", 1.0), ("bias", 0.0)):
        setattr(module, f"{prefix}_{suffix}", nn.Parameter(torch.full(
            (dim,), fill, dtype=torch.float32, device=device)))


class _BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.hidden_size
        self.Wqkv = nn.Linear(hidden, 3 * hidden, dtype=cfg.dtype,
                              device=device)
        self.out_proj = nn.Linear(hidden, hidden, dtype=cfg.dtype,
                                  device=device)

    def forward(self, x, cu_seqlens=None, max_seqlen=None,
                scheduler_metadata=None):
        """x packed (total, hidden) with cu_seqlens, else (b, s, hidden)
        with no padding (masked inputs pack upstream)."""
        h = self.cfg.num_attention_heads
        d = self.cfg.hidden_size // h
        qkv = self.Wqkv(x).unflatten(-1, (3, h, d))
        if cu_seqlens is not None:
            out = flash_attn_varlen_func(
                qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens, cu_seqlens,
                max_seqlen, max_seqlen, causal=False,
                scheduler_metadata=scheduler_metadata)
        else:
            out = flash_attn_func(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                  causal=False)
        return self.out_proj(out.flatten(-2))


class _BertLayer(nn.Module):
    """Post-norm residual block (BERT style)."""

    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        self.attention = _BertSelfAttention(cfg, device)
        _norm_params(self, "norm1", cfg.hidden_size, device)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                             dtype=cfg.dtype, device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                             dtype=cfg.dtype, device=device)
        _norm_params(self, "norm2", cfg.hidden_size, device)

    def forward(self, x, cu_seqlens=None, max_seqlen=None,
                scheduler_metadata=None):
        eps = self.cfg.layer_norm_eps
        attn = self.attention(x, cu_seqlens, max_seqlen, scheduler_metadata)
        x = layer_norm(x + attn, self.norm1_weight, self.norm1_bias, eps)
        y = self.fc2(F.gelu(self.fc1(x), approximate="none"))
        return layer_norm(x + y, self.norm2_weight, self.norm2_bias, eps)


class _BertPreTrained(nn.Module):
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` with flax's default scales
        (models/gpt.py :func:`reset_flax_defaults`)."""
        reset_flax_defaults(self, generator, lambda name: "norm" in name)


class BertModel(_BertPreTrained):
    def __init__(self, config: BertConfig, with_pooler: bool = False,
                 device=None):
        """``device`` defaults to the CUDA card and raises without one;
        ``device="cpu"`` runs the kernels' plain versions."""
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        hidden = cfg.hidden_size

        def embed(n):
            return nn.Embedding(n, hidden, dtype=cfg.dtype, device=device)

        self.word_embeddings = embed(cfg.vocab_size)
        self.position_embeddings = embed(cfg.max_position_embeddings)
        self.token_type_embeddings = embed(cfg.type_vocab_size)
        _norm_params(self, "emb_norm", hidden, device)
        self.layers = nn.ModuleList(_BertLayer(cfg, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.pooler = (nn.Linear(hidden, hidden, dtype=cfg.dtype,
                                 device=device) if with_pooler else None)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        """input_ids (b, s); attention_mask (b, s) bool, True on the valid
        tokens, which each row holds first. Returns the hidden states (b, s,
        hidden), and with the pooler also tanh(pooler([CLS])) (b, hidden)."""
        cfg = self.config
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type_embeddings(token_type_ids)
        x = layer_norm(x, self.emb_norm_weight, self.emb_norm_bias,
                       cfg.layer_norm_eps)
        if attention_mask is not None:
            # Any padding mask packs the valid tokens: pad keys must be
            # invisible to valid queries, and the dense kernel takes no
            # per-row key count.
            x_un, idx, cu, msl, _ = unpad_input(x, attention_mask.bool())
            h = cfg.num_attention_heads
            md = get_scheduler_metadata(b, msl, msl, h, h,
                                        cfg.hidden_size // h,
                                        cu_seqlens_q=cu, cu_seqlens_k=cu)
            for layer in self.layers:
                x_un = layer(x_un, cu, msl, md)
            x = pad_input(x_un, idx, b, s)
        else:
            for layer in self.layers:
                x = layer(x)
        if self.pooler is not None:
            return x, torch.tanh(self.pooler(x[:, 0]))
        return x


class _MLMHead(nn.Module):
    """transform (dense + gelu + LN) -> vocab decoder, fp32 logits."""

    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                   dtype=cfg.dtype, device=device)
        _norm_params(self, "transform_norm", cfg.hidden_size, device)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                 dtype=cfg.dtype, device=device)

    def forward(self, x):
        x = F.gelu(self.transform(x), approximate="none")
        x = layer_norm(x, self.transform_norm_weight, self.transform_norm_bias,
                       self.cfg.layer_norm_eps)
        return self.decoder(x).float()


def _gather_positions(hidden, masked_positions):
    """hidden (b, s, d) at masked_positions (b, m): (b, m, d)."""
    idx = masked_positions.to(hidden.device, torch.long)
    return torch.gather(hidden, 1, idx[:, :, None].expand(
        -1, -1, hidden.shape[-1]))


class BertForMaskedLM(_BertPreTrained):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = BertModel(config, device=device)
        self.cls = _MLMHead(config, device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                masked_positions=None):
        """With masked_positions (b, m), the vocab head runs only at those
        tokens and the logits are (b, m, vocab); without, (b, s, vocab).
        fp32."""
        hidden = self.bert(input_ids, attention_mask, token_type_ids)
        if masked_positions is not None:
            hidden = _gather_positions(hidden, masked_positions)
        return self.cls(hidden)


class BertForPreTraining(_BertPreTrained):
    """MLM + next-sentence-prediction heads."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = BertModel(config, with_pooler=True, device=device)
        self.cls = _MLMHead(config, device)
        self.seq_relationship = nn.Linear(config.hidden_size, 2,
                                          dtype=config.dtype, device=device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                masked_positions=None):
        """Returns (MLM logits as BertForMaskedLM's, NSP logits (b, 2)),
        fp32."""
        hidden, pooled = self.bert(input_ids, attention_mask, token_type_ids)
        if masked_positions is not None:
            hidden = _gather_positions(hidden, masked_positions)
        return self.cls(hidden), self.seq_relationship(pooled).float()


# ---------------------------------------------------------------------------
# Parameters from flax trees and Hugging Face checkpoints
# ---------------------------------------------------------------------------

def _bert_arrays(bert: BertModel, tree, prefix: str, out: Dict) -> None:
    def dense(name, p):
        out[f"{prefix}{name}.weight"] = p["kernel"].T
        out[f"{prefix}{name}.bias"] = p["bias"]

    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{prefix}{name}.weight"] = tree[name]["embedding"]
    for name in ("emb_norm_weight", "emb_norm_bias"):
        out[prefix + name] = tree[name]
    for i in range(len(bert.layers)):
        lp, pre = tree[f"layers_{i}"], f"layers.{i}."
        dense(pre + "attention.Wqkv", lp["attention"]["Wqkv"])
        dense(pre + "attention.out_proj", lp["attention"]["out_proj"])
        dense(pre + "fc1", lp["fc1"])
        dense(pre + "fc2", lp["fc2"])
        for name in ("norm1_weight", "norm1_bias", "norm2_weight",
                     "norm2_bias"):
            out[prefix + pre + name] = lp[name]
    if bert.pooler is not None:
        dense("pooler", tree["pooler"])


def jax_param_arrays(model: nn.Module, params) -> Dict[str, np.ndarray]:
    """The arrays of a flax BertModel / BertForMaskedLM /
    BertForPreTraining param tree (nested dicts of numpy arrays) by the
    names of ``model.named_parameters()``, in torch layouts (flax Dense
    kernels are (in, out), torch Linear weights (out, in)). Raises if the
    two do not name the same parameters."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(model, BertModel):
        _bert_arrays(model, params, "", out)
    else:
        _bert_arrays(model.bert, params["bert"], "bert.", out)
        cls = params["cls"]
        for name in ("transform", "decoder"):
            out[f"cls.{name}.weight"] = cls[name]["kernel"].T
            out[f"cls.{name}.bias"] = cls[name]["bias"]
        for name in ("transform_norm_weight", "transform_norm_bias"):
            out[f"cls.{name}"] = cls[name]
        if isinstance(model, BertForPreTraining):
            sr = params["seq_relationship"]
            out["seq_relationship.weight"] = sr["kernel"].T
            out["seq_relationship.bias"] = sr["bias"]
    names = {name for name, _ in model.named_parameters()}
    if names != set(out):
        raise ValueError(f"param tree and model differ: {names ^ set(out)}")
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, params) -> nn.Module:
    """Fill a BERT model from a flax param tree given as nested dicts of
    numpy arrays. Values are cast to each parameter's type."""
    named = dict(model.named_parameters())
    for name, arr in jax_param_arrays(model, params).items():
        named[name].copy_(torch.from_numpy(np.array(arr)).to(named[name].dtype))
    return model


def bert_config_from_hf(hf_config, dtype=torch.float32,
                        use_unpadded: bool = False) -> BertConfig:
    """A BertConfig from a Hugging Face BertConfig (any object with its
    fields)."""
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        use_unpadded=use_unpadded,
        dtype=dtype,
    )


def remap_state_dict_hf_bert(state_dict, cfg: BertConfig):
    """A Hugging Face BertForMaskedLM / BertForPreTraining state dict as the
    flax param tree of the JAX model (nested dicts of fp32 numpy arrays,
    for :func:`load_jax_params`): query/key/value fused into Wqkv, Linear
    weights transposed to flax's (in, out)."""
    sd = {k: np.asarray(v.float().cpu().numpy() if hasattr(v, "float") else v)
          for k, v in state_dict.items()}

    def dense(prefix):
        return {"kernel": sd[prefix + ".weight"].T,
                "bias": sd[prefix + ".bias"]}

    emb = "bert.embeddings."
    bert = {
        "word_embeddings": {"embedding": sd[emb + "word_embeddings.weight"]},
        "position_embeddings": {
            "embedding": sd[emb + "position_embeddings.weight"]},
        "token_type_embeddings": {
            "embedding": sd[emb + "token_type_embeddings.weight"]},
        "emb_norm_weight": sd[emb + "LayerNorm.weight"],
        "emb_norm_bias": sd[emb + "LayerNorm.bias"],
    }
    for i in range(cfg.num_hidden_layers):
        pre = f"bert.encoder.layer.{i}."
        att = pre + "attention.self."
        bert[f"layers_{i}"] = {
            "attention": {
                "Wqkv": {
                    "kernel": np.concatenate(
                        [sd[att + n + ".weight"] for n in
                         ("query", "key", "value")], axis=0).T,
                    "bias": np.concatenate(
                        [sd[att + n + ".bias"] for n in
                         ("query", "key", "value")]),
                },
                "out_proj": dense(pre + "attention.output.dense"),
            },
            "norm1_weight": sd[pre + "attention.output.LayerNorm.weight"],
            "norm1_bias": sd[pre + "attention.output.LayerNorm.bias"],
            "fc1": dense(pre + "intermediate.dense"),
            "fc2": dense(pre + "output.dense"),
            "norm2_weight": sd[pre + "output.LayerNorm.weight"],
            "norm2_bias": sd[pre + "output.LayerNorm.bias"],
        }
    if "bert.pooler.dense.weight" in sd:
        bert["pooler"] = dense("bert.pooler.dense")
    params = {"bert": bert}
    if "cls.predictions.transform.dense.weight" in sd:
        params["cls"] = {
            "transform": dense("cls.predictions.transform.dense"),
            "transform_norm_weight":
                sd["cls.predictions.transform.LayerNorm.weight"],
            "transform_norm_bias":
                sd["cls.predictions.transform.LayerNorm.bias"],
            # HF ties decoder.weight to the word embeddings; its bias is
            # separate
            "decoder": {
                "kernel": sd["cls.predictions.decoder.weight"].T,
                "bias": sd.get("cls.predictions.decoder.bias",
                               sd.get("cls.predictions.bias")),
            },
        }
    if "cls.seq_relationship.weight" in sd:
        params["seq_relationship"] = dense("cls.seq_relationship")
    return params
