"""The port's model breadth (flash_attn_tpu_torch.models: the Llama and HF
adapters, the parallel block, learned positions, NormHead) against the
JAX package and against the installed ``transformers`` models, built from
tiny configs written here with random weights, in fp32 on the CPU.

Each adapter's remap must give, array for array, what the JAX remap gives
once carried across by ``jax_param_arrays``, and its logits must match HF's
at the JAX package's own tolerances (tests/test_hf_adapters.py: atol 1e-3,
rtol 1e-2). The new blocks and heads match JAX's GPTLMHeadModel at atol
1e-4 (as tests/test_torch_gpt.py). Decoding with learned positions is held
to JAX's teacher-forced forward over the whole sequence, not to JAX's
decode: JAX's decode embeds every new token at position 0
(flash_attn_tpu/models/gpt.py:120), a fault the port does not copy."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import hf_adapters as JA
from flash_attn_tpu.models import llama as JL
from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.serving.generation import GenerationConfig as JaxGenConfig
from flash_attn_tpu.serving.generation import decode as jax_decode
from flash_attn_tpu_torch.models import hf_adapters as TA
from flash_attn_tpu_torch.models import llama as TL
from flash_attn_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    jax_param_arrays,
    lm_head_weights,
    load_jax_params,
)
from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
from flash_attn_tpu_torch.serving.generation import GenerationConfig, decode
from flash_attn_tpu_torch.serving.speculative import decode_speculative

transformers = pytest.importorskip("transformers")

from jax_paged_refs import one_page_tiles

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_paged_kernels_at_one_page_tiles():
    """JAX's paged kernels run at a KV tile of one page wherever its package
    calls them (tests/jax_paged_refs.py): the same functions, lowered
    faster."""
    with one_page_tiles():
        yield

VOCAB = 128


def _baichuan_sd(hf):
    """A Baichuan-7B checkpoint made from a HF Llama (no Baichuan class
    ships with transformers): q, k and v fused into W_pack."""
    sd = dict(hf.state_dict())
    for i in range(hf.config.num_hidden_layers):
        pre = f"model.layers.{i}.self_attn."
        sd[pre + "W_pack.weight"] = torch.cat(
            [sd.pop(pre + f"{p}_proj.weight") for p in "qkv"])
    return sd


def _llama_cfg(**kw):
    return transformers.LlamaConfig(**{
        **dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=128, rms_norm_eps=1e-6,
               tie_word_embeddings=False, max_position_embeddings=128,
               rope_theta=500000.0, attention_bias=False), **kw})


# name: (HF config, HF model class, JAX module, port module, adapter name,
#        state dict maker)
ADAPTERS = {
    "llama": (lambda: _llama_cfg(), "LlamaForCausalLM", JL, TL, "llama",
              None),
    "gpt_neox": (lambda: transformers.GPTNeoXConfig(
        vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256, rotary_pct=0.25,
        use_parallel_residual=True, layer_norm_eps=1e-5,
        tie_word_embeddings=False, max_position_embeddings=128),
        "GPTNeoXForCausalLM", JA, TA, "gpt_neox", None),
    "gptj": (lambda: transformers.GPTJConfig(
        vocab_size=VOCAB, n_embd=64, n_layer=2, n_head=4, rotary_dim=8,
        n_inner=None, n_positions=128), "GPTJForCausalLM", JA, TA, "gptj",
        None),
    "falcon": (lambda: transformers.FalconConfig(
        vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, multi_query=True, parallel_attn=True,
        bias=False, new_decoder_architecture=False,
        max_position_embeddings=128), "FalconForCausalLM", JA, TA, "falcon",
        None),
    "falcon_new_arch": (lambda: transformers.FalconConfig(
        vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=8, num_kv_heads=2, new_decoder_architecture=True,
        parallel_attn=True, bias=False, max_position_embeddings=128),
        "FalconForCausalLM", JA, TA, "falcon", None),
    "opt": (lambda: transformers.OPTConfig(
        vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, ffn_dim=256, max_position_embeddings=128,
        do_layer_norm_before=True, word_embed_proj_dim=64),
        "OPTForCausalLM", JA, TA, "opt", None),
    "bigcode": (lambda: transformers.GPTBigCodeConfig(
        vocab_size=VOCAB, n_embd=64, n_layer=2, n_head=4, n_inner=256,
        n_positions=128, multi_query=True,
        activation_function="gelu_pytorch_tanh"),
        "GPTBigCodeForCausalLM", JA, TA, "bigcode", None),
    # Baichuan-7B's rotary base is Llama-2's 10,000 (its config names none)
    "baichuan_7b": (lambda: _llama_cfg(num_key_value_heads=4,
                                       rope_theta=10000.0),
                    "LlamaForCausalLM", JA, TA, "baichuan", _baichuan_sd),
    # Baichuan 2's vocabulary (> 70,000) switches on NormHead
    "baichuan2_7b_norm_head": (
        lambda: _llama_cfg(num_key_value_heads=4, rope_theta=10000.0,
                           vocab_size=70016),
        "LlamaForCausalLM", JA, TA, "baichuan", _baichuan_sd),
}


@pytest.fixture(scope="module")
def built():
    """Per adapter: the HF model, its state dict, and both packages'
    configs and remaps (made once, on first use)."""
    cache = {}

    def get(name):
        if name not in cache:
            make_cfg, cls, jmod, tmod, key, make_sd = ADAPTERS[name]
            hf_cfg = make_cfg()
            torch.manual_seed(0)
            hf = getattr(transformers, cls)(hf_cfg).eval()
            if name.endswith("norm_head"):
                # HF's Llama head has no normalisation: give it unit rows,
                # which NormHead leaves as they are
                with torch.no_grad():
                    hf.lm_head.weight /= hf.lm_head.weight.norm(
                        dim=1, keepdim=True)
            sd = make_sd(hf) if make_sd else hf.state_dict()
            conv = f"{key}_config_to_gpt_config"
            remap = f"remap_state_dict_hf_{key}"
            jcfg = getattr(jmod, conv)(hf_cfg, max_decode_seqlen=64)
            tcfg = getattr(tmod, conv)(hf_cfg, max_decode_seqlen=64)
            cache[name] = SimpleNamespace(
                hf=hf, sd=sd, tcfg=tcfg, jcfg=jcfg,
                jparams=getattr(jmod, remap)(sd, jcfg),
                tsd=getattr(tmod, remap)(sd, tcfg))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(ADAPTERS))
def test_remap_equals_jax_remap(built, name):
    """The port's state dict equals jax_param_arrays of the JAX remap, array
    for array. JAX's Falcon remap drops the new architecture's ln_mlp (its
    model then lacks norm2 and cannot run); it is added to JAX's tree here
    as the norm2 that the port carries."""
    b = built(name)
    jparams = jax.tree_util.tree_map(np.asarray, b.jparams)
    if name == "falcon_new_arch":
        for i in range(b.tcfg.n_layer):
            pre = f"transformer.h.{i}.ln_mlp."
            jparams["transformer"][f"layers_{i}"].update(
                norm2_weight=b.sd[pre + "weight"].numpy(),
                norm2_bias=b.sd[pre + "bias"].numpy())
    model = GPTLMHeadModel(b.tcfg, device="cpu")
    want = jax_param_arrays(model, jparams)
    assert set(b.tsd) == set(want) == set(model.state_dict())
    for key, arr in want.items():
        np.testing.assert_array_equal(b.tsd[key].numpy(), arr, err_msg=key)
    if name.startswith("baichuan"):
        assert b.tcfg.norm_head == name.endswith("norm_head")


@pytest.mark.parametrize("name", list(ADAPTERS))
def test_logits_match_hf(built, name):
    b = built(name)
    model = GPTLMHeadModel(b.tcfg, device="cpu")
    model.load_state_dict(b.tsd)
    ids = torch.randint(0, VOCAB, (2, 24),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = b.hf(ids).logits.float()
        got = model(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-2)


TINY = dict(vocab_size=VOCAB, n_embd=64, n_layer=2, n_head=4,
            max_decode_seqlen=64)
# name: the JAX GPTConfig fields beside TINY
BLOCKS = {
    "parallel_tied": dict(n_positions=0, rotary_emb_fraction=0.5,
                          rotary_emb_interleaved=True, parallel_block=True,
                          activation="gelu", qkv_proj_bias=False,
                          tie_word_embeddings=False),
    "parallel_untied": dict(n_positions=0, rotary_emb_fraction=0.25,
                            parallel_block=True,
                            parallel_block_tied_norm=False),
    "parallel_untied_rms_gqa": dict(n_positions=0, n_head_kv=2,
                                    rotary_emb_fraction=1.0,
                                    use_rms_norm=True, glu_act=True,
                                    parallel_block=True,
                                    parallel_block_tied_norm=False),
    "learned_positions": dict(n_positions=64, activation="relu"),
    "norm_head": dict(n_positions=0, rotary_emb_fraction=1.0,
                      use_rms_norm=True, glu_act=True, n_inner=96,
                      tie_word_embeddings=False, norm_head=True,
                      qkv_proj_bias=False, out_proj_bias=False,
                      mlp_bias=False),
}


def _pair(fields, **port_fields):
    """A JAX GPTLMHeadModel with initialised params and the port's model
    holding the same weights (fp32)."""
    fields = {**TINY, **fields}
    jcfg = JaxGPTConfig(dtype=jnp.float32, **fields)
    jmodel = JaxGPTLMHeadModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = GPTLMHeadModel(GPTConfig(dtype=torch.float32, **fields,
                                      **port_fields), device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("name", list(BLOCKS))
def test_blocks_and_heads_match_jax(name):
    jmodel, params, tmodel = _pair(BLOCKS[name])
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, 24)).astype(np.int32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    if name == "norm_head":  # the fused-CE path takes the normalised head
        kernel, transposed = lm_head_weights(tmodel)
        assert transposed
        torch.testing.assert_close(kernel.norm(dim=1),
                                   torch.ones(VOCAB), atol=1e-6, rtol=0)


PROMPT, MAX_LEN = 10, 26


@pytest.fixture(scope="module")
def learned():
    """A tiny OPT-shaped model with learned positions (ReLU, LayerNorm,
    biases), JAX's and the port's over the same weights; a paged port
    model for the engine."""
    fields = BLOCKS["learned_positions"]
    jmodel, params, tmodel = _pair(fields)
    _, _, paged = _pair(fields, paged_kv_num_pages=24, paged_kv_page_size=8)
    return jmodel, params, tmodel, paged


def _teacher_forced(jmodel, params, seqs):
    """JAX's logits over each full sequence but its last token."""
    return np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(seqs[:, :-1], jnp.int32)))


def test_static_decode_with_learned_positions_matches_teacher_forcing(
        learned):
    """Greedy decode's tokens and per-step logits equal JAX's teacher-forced
    forward over the decoded sequence (atol 1e-4). JAX's own decode does
    not: it embeds each new token at position 0 (models/gpt.py:120), so
    its steps' logits leave the teacher-forced ones."""
    jmodel, params, tmodel, _ = learned
    ids = np.random.default_rng(3).integers(0, VOCAB, (2, PROMPT))
    seqs, length, scores = decode(torch.from_numpy(ids), tmodel,
                                  GenerationConfig(max_length=MAX_LEN),
                                  output_scores=True)
    assert length == MAX_LEN
    tf = _teacher_forced(jmodel, params, seqs.numpy())[:, PROMPT - 1:]
    np.testing.assert_allclose(scores.transpose(0, 1).numpy(), tf, atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(seqs[:, PROMPT:].numpy(), tf.argmax(-1))
    _, _, jscores = jax_decode(jnp.asarray(ids, jnp.int32), jmodel, params,
                               JaxGenConfig(max_length=MAX_LEN),
                               output_scores=True)
    jscores = np.asarray(jscores).transpose(1, 0, 2)
    assert np.abs(jscores[:, 1:] - tf[:, 1:]).max() > 1e-2  # the JAX fault


@pytest.mark.parametrize("prefix", [False, True], ids=["paged", "prefix"])
def test_engine_with_learned_positions_matches_teacher_forcing(learned,
                                                                prefix):
    """The paged engine (and with prefix caching, whose admissions prefill
    only each prompt's suffix after shared 8-token pages, at positions from
    the prefix length) decodes each request as JAX's teacher-forced
    forward over its sequence says: every token its argmax."""
    jmodel, params, _, paged = learned
    rng = np.random.default_rng(4)
    shared = rng.integers(0, VOCAB, 16).tolist() if prefix else []
    jobs = [(shared + rng.integers(0, VOCAB, n).tolist(), m)
            for n, m in [(5, 9), (11, 6), (3, 12), (9, 7)]]
    cfg = paged.config
    eng = InferenceEngine(paged, 2, GenerationConfig(top_k=1),
                          page_pool=PagePool(cfg.paged_kv_num_pages,
                                             cfg.paged_kv_page_size,
                                             cfg.max_decode_seqlen // 8, 2),
                          decode_block_size=4, prefix_cache=prefix,
                          device="cpu")
    req = [eng.submit(p, max_new_tokens=m) for p, m in jobs]
    out = eng.run()
    if prefix:
        assert eng.stats()["prefix_hit_pages"] > 0
    seqs = [prompt + out[rid] for rid, (prompt, _) in zip(req, jobs)]
    # one JAX forward over every sequence, right-padded with token 0: a
    # row's logits over its own tokens are its own (causal)
    padded = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, seq in enumerate(seqs):
        padded[i, :len(seq)] = seq
    tf_all = _teacher_forced(jmodel, params, padded)
    for i, (rid, (prompt, m)) in enumerate(zip(req, jobs)):
        toks = out[rid]
        assert len(toks) == m
        tf = tf_all[i, len(prompt) - 1:len(seqs[i]) - 1]
        np.testing.assert_array_equal(toks, tf.argmax(-1))


def test_speculative_decode_with_learned_positions_matches_greedy(learned):
    """Speculative rounds with learned positions (the draft's steps at sq =
    2 then 1, the target's verify at sq = k + 1, both caches rewound) give
    the target's own greedy decode, which the static test holds to JAX's
    teacher-forced forward."""
    _, _, tmodel, _ = learned
    _, _, draft = _pair({**BLOCKS["learned_positions"], "n_layer": 1})
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, VOCAB, (2, PROMPT)))
    cfg = GenerationConfig(max_length=MAX_LEN)
    want, _ = decode(ids, tmodel, cfg)
    got, calls = decode_speculative(ids, tmodel, draft, cfg, speculative_k=3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert calls < MAX_LEN - PROMPT  # some rounds kept more than one token


def test_decode_length_past_the_position_table_raises():
    """JAX builds such a model and reads past its table; the port refuses
    it at construction."""
    cfg = GPTConfig(dtype=torch.float32, **{**TINY, "max_decode_seqlen": 65},
                    n_positions=64)
    with pytest.raises(ValueError, match="learned positions"):
        GPTLMHeadModel(cfg, device="cpu")
    model = GPTLMHeadModel(dataclasses.replace(cfg, max_decode_seqlen=64),
                           device="cpu")
    with pytest.raises(ValueError, match="learned positions"):
        model(torch.zeros((1, 65), dtype=torch.long))


def test_alibi_families_raise_naming_item_7():
    btlm = SimpleNamespace(
        vocab_size=VOCAB, n_positions=0, hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, n_inner=96,
        position_embedding_type="alibi", activation_function="swiglu",
        layer_norm_epsilon=1e-5, mup_width_scale=0.5,
        mup_embeddings_scale=3.0, mup_output_alpha=2.0,
        mup_scale_qk_dot_by_d=True)
    baichuan_13b = SimpleNamespace(
        vocab_size=125696, hidden_size=5120, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128, rms_norm_eps=1e-6,
        tie_word_embeddings=False)
    falcon_alibi = transformers.FalconConfig(
        vocab_size=VOCAB, hidden_size=64, num_hidden_layers=1,
        num_attention_heads=4, alibi=True)
    # ALiBi serves and trains: BTLM and Baichuan-13B
    # map onto use_alibi (tests/test_torch_alibi_models.py holds them to
    # JAX); Falcon's alibi flag, which JAX's adapter ignores, raises
    # (ROADMAP.md queue C)
    assert TA.btlm_config_to_gpt_config(btlm).use_alibi
    cfg = TA.baichuan_config_to_gpt_config(baichuan_13b)
    assert cfg.use_alibi and cfg.rotary_emb_fraction == 0.0
    assert GPTLMHeadModel(GPTConfig(n_positions=0, n_layer=1, use_alibi=True),
                          device="cpu").transformer.layers[0].mixer.use_alibi
    with pytest.raises(NotImplementedError, match="queue C"):
        TA.falcon_config_to_gpt_config(falcon_alibi)
