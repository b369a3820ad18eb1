"""HF config and checkpoint adapters for GPT-NeoX (Pythia), GPT-J, Falcon,
OPT, BigCode (StarCoder), BTLM and Baichuan (port of the JAX package's
models/hf_adapters.py). Each ``*_config_to_gpt_config``
reads a HF config (or any object with its attributes) into a
:class:`~flash_attn_tpu_torch.models.gpt.GPTConfig`; each
``remap_state_dict_hf_*`` turns a HF state dict into the port's own, keyed
by ``GPTLMHeadModel.named_parameters()`` names, for
``model.load_state_dict``. Tensors keep their type and device; torch Linear
weights are (out, in) on both sides, so a remap reorders fused QKV rows,
concatenates and renames, and passes the other tensors through.

Where the JAX adapters differ, the port follows the HF model:
 - GPT-J's ``gelu_new`` is the tanh GELU (JAX takes the exact one);
 - Falcon's new decoder architecture carries ``ln_mlp`` into the second
   norm of the block (JAX drops it, and its model then lacks a parameter);
 - GPT-NeoX and Falcon without the parallel residual map onto the
   sequential block's norm names (JAX names them as a parallel block's);
 - GPT-J's ``lm_head.bias``, which neither model has a place for, raises
   when it is not zero (JAX drops it);
 - OPT with a post-norm block or a projected embedding raises (JAX reads
   them as OPT-6.7B's pre-norm shape);
 - Falcon with ``alibi`` (Falcon-RW) raises: JAX's adapter ignores the flag
   and maps the model as a rotary one (ROADMAP.md queue C).
BTLM and Baichuan-13B take ALiBi positions (``use_alibi``), served and
trained. BTLM's head dim 80 serves on the card (the forward kernels' 80
instantiations: prefill, decode and the engines) and trains on the CPU
alone: the card's backward kernels take 64, 96, 128 and 256 (ROADMAP.md
queue A, item 7).
"""

from typing import Dict

import torch

from flash_attn_tpu_torch.models.gpt import GPTConfig

__all__ = [
    "gpt_neox_config_to_gpt_config", "remap_state_dict_hf_gpt_neox",
    "gptj_config_to_gpt_config", "remap_state_dict_hf_gptj",
    "falcon_config_to_gpt_config", "remap_state_dict_hf_falcon",
    "opt_config_to_gpt_config", "remap_state_dict_hf_opt",
    "bigcode_config_to_gpt_config", "remap_state_dict_hf_bigcode",
    "btlm_config_to_gpt_config", "remap_state_dict_hf_btlm",
    "baichuan_config_to_gpt_config", "remap_state_dict_hf_baichuan",
]

StateDict = Dict[str, torch.Tensor]


def _norms(cfg: GPTConfig, first: str, second: str):
    """The port's names for a HF block's norms ``first`` and ``second``:
    the parallel block's norm and, when untied, norm2; else the sequential
    block's norm1 and norm2."""
    if cfg.parallel_block:
        names = {"norm": first}
        if not cfg.parallel_block_tied_norm:
            names["norm2"] = second
        return names
    return {"norm1": first, "norm2": second}


def _copy_norms(out: StateDict, sd: StateDict, dst: str, src: str,
                names: Dict[str, str], bias: bool = True) -> None:
    for ours, theirs in names.items():
        out[f"{dst}{ours}_weight"] = sd[f"{src}{theirs}.weight"]
        if bias:
            out[f"{dst}{ours}_bias"] = sd[f"{src}{theirs}.bias"]


def _linear(out: StateDict, sd: StateDict, dst: str, src: str,
            bias: bool = True) -> None:
    out[dst + ".weight"] = sd[src + ".weight"]
    if bias:
        out[dst + ".bias"] = sd[src + ".bias"]


def _ungroup_qkv(w, n_head_kv: int, group: int, head_dim: int):
    """Fused QKV rows grouped by KV head, (n_head_kv, group + 2, d, ...):
    the group's q heads, then one k and one v head (Falcon; GPT-NeoX's
    (h, 3, d) is group 1), reordered to the port's [all q, all k, all v]."""
    w = w.reshape(n_head_kv, group + 2, head_dim, *w.shape[1:])
    return torch.cat([w[:, :group].flatten(0, 2), w[:, group].flatten(0, 1),
                      w[:, group + 1].flatten(0, 1)])


# --------------------------- GPT-NeoX ------------------------------------

def gpt_neox_config_to_gpt_config(hf, dtype=torch.float32,
                                  max_decode_seqlen: int = 2048) -> GPTConfig:
    return GPTConfig(
        vocab_size=hf.vocab_size, n_positions=0,
        n_embd=hf.hidden_size, n_layer=hf.num_hidden_layers,
        n_head=hf.num_attention_heads,
        n_inner=hf.intermediate_size,
        rotary_emb_fraction=hf.rotary_pct,
        rotary_emb_base=getattr(hf, "rotary_emb_base",
                                getattr(hf, "rope_theta", 10000.0)),
        rotary_emb_interleaved=False,
        activation="gelu",
        parallel_block=hf.use_parallel_residual,
        parallel_block_tied_norm=False,
        norm_epsilon=hf.layer_norm_eps,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_gpt_neox(sd: StateDict, cfg: GPTConfig) -> StateDict:
    head_dim = cfg.n_embd // cfg.n_head
    out = {"transformer.embeddings.word_embeddings.weight":
           sd["gpt_neox.embed_in.weight"]}
    norms = _norms(cfg, "input_layernorm", "post_attention_layernorm")
    for i in range(cfg.n_layer):
        src, dst = f"gpt_neox.layers.{i}.", f"transformer.layers.{i}."
        _copy_norms(out, sd, dst, src, norms)
        qkv = src + "attention.query_key_value."
        for part in ("weight", "bias"):
            out[dst + f"mixer.Wqkv.{part}"] = _ungroup_qkv(
                sd[qkv + part], cfg.n_head, 1, head_dim)
        _linear(out, sd, dst + "mixer.out_proj", src + "attention.dense")
        _linear(out, sd, dst + "mlp.fc1", src + "mlp.dense_h_to_4h")
        _linear(out, sd, dst + "mlp.fc2", src + "mlp.dense_4h_to_h")
    out["transformer.ln_f_weight"] = sd["gpt_neox.final_layer_norm.weight"]
    out["transformer.ln_f_bias"] = sd["gpt_neox.final_layer_norm.bias"]
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = sd["embed_out.weight"]
    return out


# ----------------------------- GPT-J -------------------------------------

def gptj_config_to_gpt_config(hf, dtype=torch.float32,
                              max_decode_seqlen: int = 2048) -> GPTConfig:
    head_dim = hf.n_embd // hf.n_head
    act = getattr(hf, "activation_function", "gelu_new")
    return GPTConfig(
        vocab_size=hf.vocab_size, n_positions=0,
        n_embd=hf.n_embd, n_layer=hf.n_layer, n_head=hf.n_head,
        n_inner=hf.n_inner or 4 * hf.n_embd,
        rotary_emb_fraction=hf.rotary_dim / head_dim,
        rotary_emb_interleaved=True,  # GPT-J interleaves rotary pairs
        activation="gelu_approx" if act in ("gelu_new", "gelu_pytorch_tanh")
        else "gelu",
        parallel_block=True,
        parallel_block_tied_norm=True,
        qkv_proj_bias=False, out_proj_bias=False,
        norm_epsilon=hf.layer_norm_epsilon,
        tie_word_embeddings=False,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_gptj(sd: StateDict, cfg: GPTConfig) -> StateDict:
    bias = sd.get("lm_head.bias")
    if bias is not None and bool(bias.any()):
        raise ValueError("GPT-J: a nonzero lm_head.bias has no place in "
                         "GPTLMHeadModel (the JAX adapter drops it)")
    out = {"transformer.embeddings.word_embeddings.weight":
           sd["transformer.wte.weight"]}
    for i in range(cfg.n_layer):
        src, dst = f"transformer.h.{i}.", f"transformer.layers.{i}."
        _copy_norms(out, sd, dst, src, {"norm": "ln_1"})
        out[dst + "mixer.Wqkv.weight"] = torch.cat(
            [sd[src + f"attn.{p}_proj.weight"] for p in "qkv"])
        _linear(out, sd, dst + "mixer.out_proj", src + "attn.out_proj",
                bias=False)
        _linear(out, sd, dst + "mlp.fc1", src + "mlp.fc_in")
        _linear(out, sd, dst + "mlp.fc2", src + "mlp.fc_out")
    out["transformer.ln_f_weight"] = sd["transformer.ln_f.weight"]
    out["transformer.ln_f_bias"] = sd["transformer.ln_f.bias"]
    out["lm_head.weight"] = sd["lm_head.weight"]
    return out


# ----------------------------- Falcon ------------------------------------

def falcon_config_to_gpt_config(hf, dtype=torch.float32,
                                max_decode_seqlen: int = 2048) -> GPTConfig:
    new_arch = getattr(hf, "new_decoder_architecture", False)
    if getattr(hf, "alibi", False):
        raise NotImplementedError(
            "Falcon with alibi (Falcon-RW) is not ported: the JAX package's "
            "adapter ignores the flag and maps the model as a rotary one "
            "(flash_attn_tpu/models/hf_adapters.py:167-189), so there is no "
            "reference to hold it to (ROADMAP.md queue C)")
    n_head_kv = (hf.num_kv_heads if new_arch
                 else (1 if getattr(hf, "multi_query", True)
                       else hf.num_attention_heads))
    bias = getattr(hf, "bias", False)
    # the new architecture's ln_attn / ln_mlp, unless it keeps one norm
    two_norms = new_arch and (getattr(hf, "num_ln_in_parallel_attn", None)
                              or 2) == 2
    return GPTConfig(
        vocab_size=hf.vocab_size, n_positions=0,
        n_embd=hf.hidden_size, n_layer=hf.num_hidden_layers,
        n_head=hf.num_attention_heads, n_head_kv=n_head_kv,
        n_inner=getattr(hf, "ffn_hidden_size", None),
        rotary_emb_fraction=1.0,
        rotary_emb_base=getattr(hf, "rope_theta", 10000.0),
        rotary_emb_interleaved=False,
        activation="gelu",
        parallel_block=new_arch or getattr(hf, "parallel_attn", True),
        parallel_block_tied_norm=not two_norms,
        qkv_proj_bias=bias, out_proj_bias=bias, mlp_bias=bias,
        norm_epsilon=hf.layer_norm_epsilon,
        tie_word_embeddings=True,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_falcon(sd: StateDict, cfg: GPTConfig) -> StateDict:
    head_dim = cfg.n_embd // cfg.n_head
    h_k = cfg.n_head_kv or cfg.n_head
    bias = cfg.qkv_proj_bias
    out = {"transformer.embeddings.word_embeddings.weight":
           sd["transformer.word_embeddings.weight"]}
    for i in range(cfg.n_layer):
        src, dst = f"transformer.h.{i}.", f"transformer.layers.{i}."
        names = (_norms(cfg, "ln_attn", "ln_mlp")
                 if src + "ln_attn.weight" in sd else
                 _norms(cfg, "input_layernorm", "post_attention_layernorm"))
        _copy_norms(out, sd, dst, src, names)
        qkv = src + "self_attention.query_key_value."
        for part in ("weight", "bias") if bias else ("weight",):
            out[dst + f"mixer.Wqkv.{part}"] = _ungroup_qkv(
                sd[qkv + part], h_k, cfg.n_head // h_k, head_dim)
        _linear(out, sd, dst + "mixer.out_proj", src + "self_attention.dense",
                bias=bias)
        _linear(out, sd, dst + "mlp.fc1", src + "mlp.dense_h_to_4h", bias=bias)
        _linear(out, sd, dst + "mlp.fc2", src + "mlp.dense_4h_to_h", bias=bias)
    out["transformer.ln_f_weight"] = sd["transformer.ln_f.weight"]
    out["transformer.ln_f_bias"] = sd["transformer.ln_f.bias"]
    return out


# ------------------------------- OPT --------------------------------------

def opt_config_to_gpt_config(hf, dtype=torch.float32,
                             max_decode_seqlen: int = 2048) -> GPTConfig:
    if not getattr(hf, "do_layer_norm_before", True) or getattr(
            hf, "word_embed_proj_dim", hf.hidden_size) != hf.hidden_size:
        raise NotImplementedError(
            "OPT: only the pre-norm shape without embedding projections "
            "(OPT-125M, 1.3B and up) maps onto GPTConfig")
    return GPTConfig(
        vocab_size=hf.vocab_size,
        n_positions=hf.max_position_embeddings,
        n_embd=hf.hidden_size, n_layer=hf.num_hidden_layers,
        n_head=hf.num_attention_heads,
        n_inner=hf.ffn_dim,
        rotary_emb_fraction=0.0,
        activation="relu",
        norm_epsilon=1e-5,
        tie_word_embeddings=True,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_opt(sd: StateDict, cfg: GPTConfig) -> StateDict:
    dec = "model.decoder."
    out = {"transformer.embeddings.word_embeddings.weight":
           sd[dec + "embed_tokens.weight"],
           # OPT's learned positions are stored 2 rows down: pre-shift
           "transformer.embeddings.position_embeddings.weight":
           sd[dec + "embed_positions.weight"][2:]}
    for i in range(cfg.n_layer):
        src, dst = f"{dec}layers.{i}.", f"transformer.layers.{i}."
        _copy_norms(out, sd, dst, src, {"norm1": "self_attn_layer_norm",
                                        "norm2": "final_layer_norm"})
        for part in ("weight", "bias"):
            out[dst + f"mixer.Wqkv.{part}"] = torch.cat(
                [sd[src + f"self_attn.{p}_proj.{part}"] for p in "qkv"])
        _linear(out, sd, dst + "mixer.out_proj", src + "self_attn.out_proj")
        _linear(out, sd, dst + "mlp.fc1", src + "fc1")
        _linear(out, sd, dst + "mlp.fc2", src + "fc2")
    out["transformer.ln_f_weight"] = sd[dec + "final_layer_norm.weight"]
    out["transformer.ln_f_bias"] = sd[dec + "final_layer_norm.bias"]
    return out


# ----------------------------- BigCode ------------------------------------

def bigcode_config_to_gpt_config(hf, dtype=torch.float32,
                                 max_decode_seqlen: int = 2048) -> GPTConfig:
    """GPTBigCode (StarCoder): multi-query attention maps onto
    ``n_head_kv=1`` (the kernels take the one KV head as it is)."""
    if not hf.multi_query:
        raise NotImplementedError("bigcode: only multi_query=True supported")
    return GPTConfig(
        vocab_size=hf.vocab_size, n_positions=hf.n_positions,
        n_embd=hf.n_embd, n_layer=hf.n_layer, n_head=hf.n_head,
        n_head_kv=1,
        n_inner=hf.n_inner or 4 * hf.n_embd,
        activation=("gelu_approx" if "tanh" in hf.activation_function
                    else "gelu"),
        norm_epsilon=hf.layer_norm_epsilon,
        tie_word_embeddings=True,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_bigcode(sd: StateDict, cfg: GPTConfig) -> StateDict:
    """c_attn's rows are already [q, k, v] for one KV head: the port's
    Wqkv as it is."""
    out = {"transformer.embeddings.word_embeddings.weight":
           sd["transformer.wte.weight"],
           "transformer.embeddings.position_embeddings.weight":
           sd["transformer.wpe.weight"]}
    for i in range(cfg.n_layer):
        src, dst = f"transformer.h.{i}.", f"transformer.layers.{i}."
        _copy_norms(out, sd, dst, src, {"norm1": "ln_1", "norm2": "ln_2"})
        _linear(out, sd, dst + "mixer.Wqkv", src + "attn.c_attn")
        _linear(out, sd, dst + "mixer.out_proj", src + "attn.c_proj")
        _linear(out, sd, dst + "mlp.fc1", src + "mlp.c_fc")
        _linear(out, sd, dst + "mlp.fc2", src + "mlp.c_proj")
    out["transformer.ln_f_weight"] = sd["transformer.ln_f.weight"]
    out["transformer.ln_f_bias"] = sd["transformer.ln_f.bias"]
    return out


# ------------------------------ BTLM --------------------------------------

def btlm_config_to_gpt_config(hf, dtype=torch.float32,
                              max_decode_seqlen: int = 2048) -> GPTConfig:
    """Cerebras BTLM: a GPT-2 skeleton with ALiBi positions (learned ones
    when position_embedding_type is not "alibi"), a SwiGLU MLP and muP's
    scalars (mup_scale_qk_dot_by_d: softmax scale 1/d)."""
    use_alibi = hf.position_embedding_type == "alibi"
    return GPTConfig(
        vocab_size=hf.vocab_size,
        n_positions=0 if use_alibi else hf.n_positions,
        n_embd=hf.hidden_size, n_layer=hf.num_hidden_layers,
        n_head=hf.num_attention_heads,
        n_inner=hf.n_inner,
        glu_act=hf.activation_function == "swiglu",
        use_alibi=use_alibi,
        mup_width_scale=hf.mup_width_scale,
        mup_embeddings_multiplier=hf.mup_embeddings_scale,
        mup_output_multiplier=hf.mup_output_alpha,
        mup_scale_qk_dot_by_d=hf.mup_scale_qk_dot_by_d,
        mlp_bias=True,
        norm_epsilon=hf.layer_norm_epsilon,
        tie_word_embeddings=True,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_btlm(sd: StateDict, cfg: GPTConfig) -> StateDict:
    """BTLM keeps GPT-2's Conv1D weights, (in, out): each is transposed to
    a Linear's (out, in). c_attn's columns are [q, k, v], the port's Wqkv;
    the gated MLP's activated half is c_fc2, so fc1 = [c_fc2, c_fc] (the
    port's GatedMlp is gate first). The ALiBi slopes are recomputed, not
    read."""
    out = {"transformer.embeddings.word_embeddings.weight":
           sd["transformer.wte.weight"]}
    if cfg.n_positions > 0:
        out["transformer.embeddings.position_embeddings.weight"] = \
            sd["transformer.wpe.weight"]
    for i in range(cfg.n_layer):
        src, dst = f"transformer.h.{i}.", f"transformer.layers.{i}."
        _copy_norms(out, sd, dst, src, {"norm1": "ln_1", "norm2": "ln_2"})
        for ours, theirs in (("mixer.Wqkv", "attn.c_attn"),
                             ("mixer.out_proj", "attn.c_proj"),
                             ("mlp.fc2", "mlp.c_proj")):
            out[dst + ours + ".weight"] = sd[src + theirs + ".weight"].T
            out[dst + ours + ".bias"] = sd[src + theirs + ".bias"]
        fc = [src + "mlp.c_fc2.", src + "mlp.c_fc."]
        out[dst + "mlp.fc1.weight"] = torch.cat(
            [sd[p + "weight"].T for p in fc])
        out[dst + "mlp.fc1.bias"] = torch.cat([sd[p + "bias"] for p in fc])
    out["transformer.ln_f_weight"] = sd["transformer.ln_f.weight"]
    out["transformer.ln_f_bias"] = sd["transformer.ln_f.bias"]
    return out


# ----------------------------- Baichuan ------------------------------------

def baichuan_config_to_gpt_config(hf, dtype=torch.float32,
                                  max_decode_seqlen: int = 2048) -> GPTConfig:
    """Baichuan: a Llama body with a fused W_pack QKV. The HF config does not
    record the position scheme or the head, so they are inferred as the
    reference does: width < 5000 (7B) rotary, else (13B) ALiBi;
    vocabulary > 70,000 (Baichuan 2) a NormHead."""
    use_rotary = hf.hidden_size < 5000
    return GPTConfig(
        vocab_size=hf.vocab_size, n_positions=0,
        n_embd=hf.hidden_size, n_layer=hf.num_hidden_layers,
        n_head=hf.num_attention_heads,
        n_inner=hf.intermediate_size,
        glu_act=True, use_rms_norm=True,
        rotary_emb_fraction=1.0 if use_rotary else 0.0,
        rotary_emb_interleaved=False,
        use_alibi=not use_rotary,
        norm_epsilon=hf.rms_norm_eps,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
        norm_head=hf.vocab_size > 70000,
        qkv_proj_bias=False, out_proj_bias=False, mlp_bias=False,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_baichuan(sd: StateDict, cfg: GPTConfig) -> StateDict:
    """W_pack's rows are [q, k, v], the port's Wqkv; the gated MLP is
    gate first, as the Llama remap's."""
    out = {"transformer.embeddings.word_embeddings.weight":
           sd["model.embed_tokens.weight"]}
    for i in range(cfg.n_layer):
        src, dst = f"model.layers.{i}.", f"transformer.layers.{i}."
        _copy_norms(out, sd, dst, src, {"norm1": "input_layernorm",
                                        "norm2": "post_attention_layernorm"},
                    bias=False)
        out[dst + "mixer.Wqkv.weight"] = sd[src + "self_attn.W_pack.weight"]
        out[dst + "mixer.out_proj.weight"] = sd[src + "self_attn.o_proj.weight"]
        out[dst + "mlp.fc1.weight"] = torch.cat(
            [sd[src + "mlp.gate_proj.weight"], sd[src + "mlp.up_proj.weight"]])
        out[dst + "mlp.fc2.weight"] = sd[src + "mlp.down_proj.weight"]
    out["transformer.ln_f_weight"] = sd["model.norm.weight"]
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = sd["lm_head.weight"]
    return out
