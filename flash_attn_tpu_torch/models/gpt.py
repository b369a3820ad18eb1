"""GPT-family model (port of flash_attn_tpu/models/gpt.py ``GPTConfig``,
``GPTModel``, ``GPTLMHeadModel``, ``_NormHead``, ``lm_head_weights``).

The configuration carries the JAX package's fields; the port runs rotary
or learned positions, RMSNorm/LayerNorm, gated or plain MLP, GQA, the
sequential and the parallel block (tied or untied norms), a tied, untied
or NormHead head, the muP scalars, the paged cache, per-block
activation rematerialization in train mode (``remat``), a sliding
window (``window_size``, passed to every attention call, serving and
training alike, packed input too), softcap and ALiBi (``softcap``,
``use_alibi``: the score map of every attention call, serving and training
alike, packed input too; neither adds a parameter), and raises
NotImplementedError for the rest. Parameters mirror flax's values: the
Dense and embedding weights in the compute type (flax keeps them in fp32
and casts them to it at every call, which gives the same values), the norm
weights in fp32. Training keeps fp32 master copies beside them
(training/trainer.py). The HF checkpoint remaps of models/llama.py and
models/hf_adapters.py give state dicts in this model's parameter names.
"""

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from flash_attn_tpu_torch.modules.block import Block, ParallelBlock
from flash_attn_tpu_torch.modules.embedding import GPT2Embeddings
from flash_attn_tpu_torch.modules.mha import MHA, KVCache
from flash_attn_tpu_torch.modules.mlp import GatedMlp, Mlp
from flash_attn_tpu_torch.ops.activations import gelu_approx, sqrelu
from flash_attn_tpu_torch.ops.norm import layer_norm, rms_norm
from flash_attn_tpu_torch.utils.device import resolve_device

__all__ = ["GPTConfig", "GPTModel", "GPTLMHeadModel", "NormHead", "gpt_913m",
           "jax_param_arrays", "lm_head_weights", "load_jax_params",
           "reset_flax_defaults"]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    n_positions: int = 2048      # learned pos-emb length; 0 = none (rotary)
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_head_kv: Optional[int] = None
    n_inner: Optional[int] = None
    rotary_emb_fraction: float = 0.0
    rotary_emb_base: float = 10000.0
    rotary_emb_interleaved: bool = False
    use_rms_norm: bool = False
    glu_act: bool = False        # gated (SwiGLU) MLP
    activation: str = "gelu_approx"  # gelu_approx | gelu | relu | sqrelu
    parallel_block_tied_norm: bool = True
    qkv_proj_bias: bool = True
    out_proj_bias: bool = True
    mlp_bias: bool = True
    parallel_block: bool = False
    use_alibi: bool = False
    window_size: Tuple[int, int] = (-1, -1)
    softcap: float = 0.0
    embd_dropout: float = 0.0    # training only; inference is deterministic
    resid_dropout: float = 0.0
    norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    mup_width_scale: float = 1.0
    mup_embeddings_multiplier: float = 1.0
    mup_output_multiplier: float = 1.0
    mup_scale_qk_dot_by_d: bool = False
    norm_head: bool = False
    max_decode_seqlen: int = 2048
    paged_kv_num_pages: int = 0
    paged_kv_page_size: int = 128
    kv_cache_dtype: Optional[torch.dtype] = None
    kv_cache_scale: float = 1.0
    context_parallel: bool = False
    sequence_parallel: bool = False
    # Per-block activation rematerialization in train mode: each block's
    # activations are recomputed in the backward. 'dots' keeps the matmul
    # outputs without batch dims (JAX's checkpoint_dots_with_no_batch_dims);
    # any other policy recomputes the whole block, as in JAX.
    remat: bool = False
    remat_policy: str = "full"
    dtype: torch.dtype = torch.bfloat16


def gpt_913m(max_decode_seqlen: int = 0, dtype=torch.bfloat16) -> GPTConfig:
    """The flagship 913M GPT (the numbers of bench.py ``_gpt_913m``):
    vocab 50304, width 2048, 16 layers of 16 heads of 128, rotary, RMSNorm,
    SwiGLU, tied embeddings."""
    return GPTConfig(
        vocab_size=50304, n_positions=0, n_embd=2048, n_layer=16,
        n_head=16, n_head_kv=16, rotary_emb_fraction=1.0,
        use_rms_norm=True, glu_act=True, tie_word_embeddings=True,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype)


def _check_ported(cfg: GPTConfig) -> None:
    missing = {
        "context_parallel (queue A item 8)": cfg.context_parallel,
        "sequence_parallel (queue A item 8)": cfg.sequence_parallel,
    }
    bad = [name for name, on in missing.items() if on]
    if bad:
        raise NotImplementedError(
            f"GPTConfig options not ported yet: {', '.join(bad)}")
    if cfg.n_positions > 0 and cfg.max_decode_seqlen > cfg.n_positions:
        # JAX would read past the position table (ROADMAP.md, the
        # differences from the reference)
        raise ValueError(
            f"GPTConfig: max_decode_seqlen {cfg.max_decode_seqlen} exceeds "
            f"the {cfg.n_positions} learned positions")


# The matmuls without batch dims that the 'dots' policy keeps: the Dense
# (nn.Linear) products, which reach the dispatcher as aten.mm, or aten.addmm
# with a bias (aten.linear decomposes into them). Attention's products have
# batch dims (or are a kernel) and are recomputed, as JAX's policy
# recomputes the Pallas call.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _make_mlp(cfg: GPTConfig, device):
    if cfg.glu_act:
        # n_inner is the exact gated width when given; else the 8/3 rule
        # rounded up to a multiple of 128.
        inner = cfg.n_inner or (4 * cfg.n_embd * 2 // 3)
        mult = 1 if cfg.n_inner is not None else 128
        return GatedMlp(cfg.n_embd, inner, bias1=cfg.mlp_bias,
                        bias2=cfg.mlp_bias, multiple_of=mult, dtype=cfg.dtype,
                        device=device)
    act = {
        "gelu_approx": gelu_approx,
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "relu": torch.relu,
        "sqrelu": sqrelu,
    }[cfg.activation]
    return Mlp(cfg.n_embd, cfg.n_inner or 4 * cfg.n_embd, activation=act,
               bias1=cfg.mlp_bias, bias2=cfg.mlp_bias, dtype=cfg.dtype,
               device=device)


def _make_mixer(cfg: GPTConfig, device):
    head_dim = cfg.n_embd // cfg.n_head
    return MHA(
        cfg.n_embd, cfg.n_head, num_heads_kv=cfg.n_head_kv,
        qkv_proj_bias=cfg.qkv_proj_bias, out_proj_bias=cfg.out_proj_bias,
        causal=True,
        softmax_scale=1.0 / head_dim if cfg.mup_scale_qk_dot_by_d else None,
        rotary_emb_dim=int(head_dim * cfg.rotary_emb_fraction),
        rotary_emb_base=cfg.rotary_emb_base,
        rotary_emb_interleaved=cfg.rotary_emb_interleaved,
        max_decode_seqlen=cfg.max_decode_seqlen,
        paged_kv_num_pages=cfg.paged_kv_num_pages,
        paged_kv_page_size=cfg.paged_kv_page_size,
        window_size=cfg.window_size, softcap=cfg.softcap,
        use_alibi=cfg.use_alibi, kv_cache_dtype=cfg.kv_cache_dtype,
        kv_cache_scale=cfg.kv_cache_scale, dtype=cfg.dtype, device=device)


def _make_block(cfg: GPTConfig, device):
    mixer, mlp = _make_mixer(cfg, device), _make_mlp(cfg, device)
    if cfg.parallel_block:
        return ParallelBlock(cfg.n_embd, mixer, mlp,
                             use_rms_norm=cfg.use_rms_norm,
                             norm_epsilon=cfg.norm_epsilon,
                             tied_norm=cfg.parallel_block_tied_norm,
                             device=device)
    return Block(cfg.n_embd, mixer, mlp, use_rms_norm=cfg.use_rms_norm,
                 norm_epsilon=cfg.norm_epsilon, device=device)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        _check_ported(config)
        device = resolve_device(device)
        cfg = self.config = config
        self.embeddings = GPT2Embeddings(cfg.n_embd, cfg.vocab_size,
                                         cfg.n_positions, dtype=cfg.dtype,
                                         device=device)
        self.layers = nn.ModuleList(_make_block(cfg, device)
                                    for _ in range(cfg.n_layer))
        self.ln_f_weight = nn.Parameter(
            torch.ones(cfg.n_embd, dtype=torch.float32, device=device))
        self.ln_f_bias = (None if cfg.use_rms_norm else nn.Parameter(
            torch.zeros(cfg.n_embd, dtype=torch.float32, device=device)))

    def new_cache(self) -> List[KVCache]:
        """Empty per-layer decode state, filled by a prefill."""
        return [KVCache() for _ in self.layers]

    def allocate_cache(self, n_slots: int) -> List[KVCache]:
        """Zeroed per-layer caches for ``n_slots`` sequences, made up front
        (the serving engine's; the counterpart of the JAX engine's
        _init_cache, engine.py:467-484): linear (n_slots, h_k, s_alloc, d),
        or the page pool (paged_kv_num_pages, h_k, page_size, d) of a paged
        configuration; the offsets (n_slots,) of every slot."""
        return [block.mixer.allocate_cache(n_slots) for block in self.layers]

    def positions(self, input_ids, mode: str,
                  cache: Optional[List[KVCache]] = None, prefix_lengths=None):
        """The learned-position ids of ``input_ids`` (b, s), from device
        tensors only, so that a captured decode program recomputes them at
        every replay: ``arange(s)`` in train mode and a plain prefill;
        prefix_lengths + arange(s) in a prefix-cached admission; the
        cache offsets (layer 0's, before this call appends) + arange(s) in
        decode (JAX embeds every decoded token at position 0,
        models/gpt.py:120). Positions that come from the device are
        clamped to the table: only rows whose cache is full or unused reach
        past it, and an index past the table would fault the card."""
        s = input_ids.shape[1]
        n = self.config.n_positions
        pos = torch.arange(s, device=input_ids.device)
        if mode == "decode":
            start = cache[0].offset
        elif prefix_lengths is not None:
            start = prefix_lengths
        else:
            if s > n:
                raise ValueError(f"GPTModel: {s} tokens exceed the {n} "
                                 "learned positions")
            return pos[None]
        start = start.to(input_ids.device, torch.long)
        return (start[:, None] + pos).clamp_(max=n - 1)

    def forward(self, input_ids, mode: str = "train",
                cache: Optional[List[KVCache]] = None, **mixer_kwargs):
        """``mixer_kwargs`` go to every layer's MHA: slot_ids,
        prefill_lengths, prefix_lengths, block_table."""
        cfg = self.config
        position_ids = None
        if cfg.n_positions > 0:
            position_ids = self.positions(input_ids, mode, cache,
                                          mixer_kwargs.get("prefix_lengths"))
        hidden = self.embeddings(input_ids, position_ids)
        if cfg.mup_embeddings_multiplier != 1.0:
            hidden = hidden * cfg.mup_embeddings_multiplier
        residual = None
        run = self._block_runner(mode)
        for i, block in enumerate(self.layers):
            hidden, residual = run(block, hidden, residual, mode=mode,
                                   cache=None if cache is None else cache[i],
                                   **mixer_kwargs)
        if residual is not None:
            hidden = (hidden.float() + residual.float()).to(cfg.dtype)
        if cfg.use_rms_norm:
            return rms_norm(hidden, self.ln_f_weight, cfg.norm_epsilon)
        return layer_norm(hidden, self.ln_f_weight, self.ln_f_bias,
                          cfg.norm_epsilon)

    def _block_runner(self, mode: str):
        """How a block is called: as it is, or, with remat in train mode
        (prefill, decode and eval never remat, as in JAX), through
        non-reentrant checkpoint, which recomputes the block's forward in
        the backward (its attention kernel launches again) and keeps only
        what the policy saves."""
        cfg = self.config
        if not (cfg.remat and mode == "train"):
            return lambda block, *args, **kw: block(*args, **kw)
        extra = {}
        if cfg.remat_policy == "dots":  # JAX models/gpt.py:227-231
            extra["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)
        return lambda block, *args, **kw: checkpoint(
            block, *args, use_reentrant=False, **extra, **kw)


class GPTLMHeadModel(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        """``device`` defaults to the CUDA card and raises without one;
        ``device="cpu"`` runs the kernels' plain versions."""
        super().__init__()
        _check_ported(config)
        device = resolve_device(device)
        self.config = config
        self.transformer = GPTModel(config, device=device)
        self.lm_head = None
        if not config.tie_word_embeddings:
            head = NormHead if config.norm_head else nn.Linear
            self.lm_head = head(config.n_embd, config.vocab_size, bias=False,
                                dtype=config.dtype, device=device)

    def new_cache(self) -> List[KVCache]:
        return self.transformer.new_cache()

    def allocate_cache(self, n_slots: int) -> List[KVCache]:
        return self.transformer.allocate_cache(n_slots)

    def forward_hidden(self, input_ids):
        """The trunk only: final hidden states (b, s, n_embd) in the compute
        type, no lm_head (the input of the fused lm_head + CE loss)."""
        return self.transformer(input_ids, mode="train")

    def forward(self, input_ids, mode: str = "train",
                cache: Optional[List[KVCache]] = None, logits_positions=None,
                slot_ids=None, prefill_lengths=None, prefix_lengths=None,
                block_table=None):
        """input_ids (b, s). ``mode`` is "train" (differentiable), "prefill"
        (fills ``cache``, from :meth:`new_cache` or :meth:`allocate_cache`)
        or "decode" (updates it in place). ``logits_positions`` (b,)
        computes the logits only at those positions, returning (b, 1,
        vocab). Logits are fp32, computed in the compute type. The serving
        engine's ``slot_ids``, ``prefill_lengths``, ``prefix_lengths`` and
        ``block_table`` go to every layer's MHA (see
        :meth:`flash_attn_tpu_torch.modules.mha.MHA.forward`)."""
        kw = {name: val for name, val in (
            ("slot_ids", slot_ids), ("prefill_lengths", prefill_lengths),
            ("prefix_lengths", prefix_lengths), ("block_table", block_table))
            if val is not None}
        hidden = self.transformer(input_ids, mode=mode, cache=cache, **kw)
        if logits_positions is not None:
            idx = logits_positions.to(hidden.device, torch.long)
            hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                            idx][:, None]
        return self.logits(hidden)

    def logits(self, hidden):
        """fp32 logits of final hidden states (:meth:`forward_hidden`'s, or
        a selection of them), computed in the compute type."""
        cfg = self.config
        hidden = hidden.to(cfg.dtype)
        if self.lm_head is None:
            logits = F.linear(hidden,
                              self.transformer.embeddings.word_embeddings.weight)
        else:
            logits = self.lm_head(hidden)
        logits = logits.float()
        output_scale = cfg.mup_output_multiplier * cfg.mup_width_scale
        if output_scale != 1.0:
            logits = logits * output_scale
        return logits

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` with flax's default scales
        (:func:`reset_flax_defaults`)."""
        reset_flax_defaults(self, generator, lambda name: "norm" in name
                            or name.startswith("transformer.ln_f"))


class NormHead(nn.Linear):
    """An untied lm_head whose rows (one a vocabulary entry) are scaled to
    unit L2 norm, in fp32, at every call (Baichuan-2's NormHead; JAX
    ``_NormHead``, models/gpt.py:266, normalises its (d, vocab) kernel's
    columns)."""

    def normalized_weight(self):
        w = self.weight.float()
        return (w / w.norm(dim=1, keepdim=True).clamp_min(1e-12)).to(
            self.weight.dtype)

    def forward(self, x):
        return F.linear(x, self.normalized_weight())


@torch.no_grad()
def reset_flax_defaults(model: nn.Module, generator: torch.Generator,
                        is_norm) -> None:
    """Random weights from ``generator`` with flax's default scales: Dense
    kernels N(0, 1/fan_in) (lecun), embeddings N(0, 1/embedding width),
    biases 0; the parameters whose names ``is_norm`` accepts are norm
    weights (1) and biases (0)."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                               generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim),
                               generator=generator)
    for name, p in model.named_parameters():
        if is_norm(name):
            p.fill_(0.0 if name.endswith("bias") else 1.0)


def lm_head_weights(model: GPTLMHeadModel):
    """The lm_head weight as ``(kernel, transpose_kernel)`` for
    :func:`flash_attn_tpu_torch.ops.cross_entropy.fused_linear_cross_entropy`:
    logits = hidden @ kernel.T. Tied: the (vocab, d) embedding table; untied:
    the (vocab, d) Linear weight, normalised for a NormHead. Either way
    transpose_kernel is True (JAX returns the untied Dense kernel as (d,
    vocab) with False)."""
    if model.lm_head is None:
        return model.transformer.embeddings.word_embeddings.weight, True
    if isinstance(model.lm_head, NormHead):
        return model.lm_head.normalized_weight(), True
    return model.lm_head.weight, True


def jax_param_arrays(model: GPTLMHeadModel, params):
    """The arrays of a flax GPTLMHeadModel param tree (nested dicts of
    numpy arrays) by the names of ``model.named_parameters()``, in torch
    layouts (flax Dense kernels are (in, out), torch Linear weights
    (out, in)) and with their own values and types. Raises if the two do
    not name the same parameters."""
    tr = params["transformer"]
    emb = tr["embeddings"]
    out = {"transformer.embeddings.word_embeddings.weight":
           emb["word_embeddings"]["embedding"]}
    if "position_embeddings" in emb:
        out["transformer.embeddings.position_embeddings.weight"] = \
            emb["position_embeddings"]["embedding"]

    def dense(name: str, lin: nn.Linear, p) -> None:
        out[f"{name}.weight"] = p["kernel"].T
        if lin.bias is not None:
            out[f"{name}.bias"] = p["bias"]

    gm = model.transformer
    for i, block in enumerate(gm.layers):
        lp, pre = tr[f"layers_{i}"], f"transformer.layers.{i}"
        for name in ("norm1_weight", "norm2_weight", "norm1_bias", "norm2_bias",
                     "norm_weight", "norm_bias"):
            if getattr(block, name, None) is not None:
                out[f"{pre}.{name}"] = lp[name]
        for name, arr in block.mixer.jax_param_arrays(lp["mixer"]).items():
            out[f"{pre}.mixer.{name}"] = arr
        dense(f"{pre}.mlp.fc1", block.mlp.fc1, lp["mlp"]["fc1"])
        dense(f"{pre}.mlp.fc2", block.mlp.fc2, lp["mlp"]["fc2"])
    out["transformer.ln_f_weight"] = tr["ln_f_weight"]
    if gm.ln_f_bias is not None:
        out["transformer.ln_f_bias"] = tr["ln_f_bias"]
    if model.lm_head is not None:
        dense("lm_head", model.lm_head, params["lm_head"])
    names = {name for name, _ in model.named_parameters()}
    if names != set(out):
        raise ValueError(f"param tree and model differ: {names ^ set(out)}")
    return out


@torch.no_grad()
def load_jax_params(model: GPTLMHeadModel, params) -> GPTLMHeadModel:
    """Fill ``model`` from a flax GPTLMHeadModel param tree given as nested
    dicts of numpy arrays. Values are cast to each parameter's type."""
    named = dict(model.named_parameters())
    for name, arr in jax_param_arrays(model, params).items():
        named[name].copy_(torch.from_numpy(arr.copy()).to(named[name].dtype))
    return model
