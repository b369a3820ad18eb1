"""Llama-family HF adapter (port of the JAX package's models/llama.py
``llama_config_to_gpt_config`` and ``remap_state_dict_hf_llama``): a HF
``LlamaConfig`` (or any object with its attributes) as a
:class:`~flash_attn_tpu_torch.models.gpt.GPTConfig`, and a HF Llama state
dict as the port's own, keyed by ``GPTLMHeadModel.named_parameters()``
names, ready for ``model.load_state_dict``.

torch Linear weights are (out, in) in both, so the remap only concatenates
(q, k, v into ``Wqkv``; gate, up into the gated ``fc1``, gate first) and
renames; the tensors keep their type and device, and the rest are the
caller's own tensors, not copies.
"""

from typing import Dict

import torch

from flash_attn_tpu_torch.models.gpt import GPTConfig

__all__ = ["llama_config_to_gpt_config", "remap_state_dict_hf_llama"]


def llama_config_to_gpt_config(hf_cfg, dtype=torch.float32,
                               max_decode_seqlen: int = 2048) -> GPTConfig:
    return GPTConfig(
        vocab_size=hf_cfg.vocab_size,
        n_positions=0,  # rotary
        n_embd=hf_cfg.hidden_size,
        n_layer=hf_cfg.num_hidden_layers,
        n_head=hf_cfg.num_attention_heads,
        n_head_kv=getattr(hf_cfg, "num_key_value_heads",
                          hf_cfg.num_attention_heads),
        n_inner=hf_cfg.intermediate_size,
        rotary_emb_fraction=1.0,
        rotary_emb_base=getattr(hf_cfg, "rope_theta", 10000.0),
        rotary_emb_interleaved=False,  # HF rotate_half = split halves
        use_rms_norm=True,
        glu_act=True,
        qkv_proj_bias=getattr(hf_cfg, "attention_bias", False),
        out_proj_bias=getattr(hf_cfg, "attention_bias", False),
        mlp_bias=getattr(hf_cfg, "mlp_bias", False),
        norm_epsilon=hf_cfg.rms_norm_eps,
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        max_decode_seqlen=max_decode_seqlen,
        dtype=dtype,
    )


def remap_state_dict_hf_llama(state_dict: Dict[str, torch.Tensor],
                              cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """HF Llama state dict -> the port's GPTLMHeadModel state dict."""
    sd = state_dict
    out = {"transformer.embeddings.word_embeddings.weight":
           sd["model.embed_tokens.weight"]}
    for i in range(cfg.n_layer):
        src, dst = f"model.layers.{i}.", f"transformer.layers.{i}."
        attn = src + "self_attn."
        out[dst + "norm1_weight"] = sd[src + "input_layernorm.weight"]
        out[dst + "norm2_weight"] = sd[src + "post_attention_layernorm.weight"]
        for part in ("weight", "bias") if cfg.qkv_proj_bias else ("weight",):
            out[dst + f"mixer.Wqkv.{part}"] = torch.cat(
                [sd[attn + f"{p}_proj.{part}"] for p in "qkv"])
        out[dst + "mixer.out_proj.weight"] = sd[attn + "o_proj.weight"]
        if cfg.out_proj_bias:
            out[dst + "mixer.out_proj.bias"] = sd[attn + "o_proj.bias"]
        for part in ("weight", "bias") if cfg.mlp_bias else ("weight",):
            out[dst + f"mlp.fc1.{part}"] = torch.cat(
                [sd[src + f"mlp.gate_proj.{part}"],
                 sd[src + f"mlp.up_proj.{part}"]])
            out[dst + f"mlp.fc2.{part}"] = sd[src + f"mlp.down_proj.{part}"]
    out["transformer.ln_f_weight"] = sd["model.norm.weight"]
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = sd["lm_head.weight"]
    return out
