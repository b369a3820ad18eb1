"""ALiBi and softcap models of the port (flash_attn_tpu_torch) against the
JAX package's GPTLMHeadModel, in fp32 on the CPU: a tiny BTLM (muP, ALiBi,
6 heads, so that the schedule's extra slopes for a head count that is not a
power of two show), a tiny Baichuan-13B (ALiBi without rotary, RMSNorm,
W_pack; 10 heads) and a tiny GPT with ``softcap``. The two adapters read
the same HF config into GPTConfigs equal field for field, the two remaps
the same seeded HF-named state dict; the logits agree at atol 1e-4 (as
tests/test_torch_models.py), and greedy static decode gives the tokens
JAX's teacher-forced forward over the decoded sequence picks. Then the
refusals of what stays unported (the prefix-cached engine and admission of
an ALiBi model) and the runs of what trains since the backwards took the
score map: the Trainer, packed input, a gradient through train mode."""

import dataclasses
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import hf_adapters as JA
from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu_torch.models import hf_adapters as TA
from flash_attn_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    load_jax_params,
)
from flash_attn_tpu_torch.modules.mha import MHA, KVCache, alibi_slopes
from flash_attn_tpu_torch.serving.generation import GenerationConfig, decode

from jax_paged_refs import one_page_tiles

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_paged_kernels_at_one_page_tiles():
    """JAX's paged kernels run at a KV tile of one page wherever its package
    calls them (tests/jax_paged_refs.py): the same functions, lowered
    faster."""
    with one_page_tiles():
        yield

VOCAB, PROMPT, MAX_LEN = 128, 10, 20

BTLM = SimpleNamespace(
    vocab_size=VOCAB, n_positions=0, hidden_size=96, num_hidden_layers=2,
    num_attention_heads=6, n_inner=160, position_embedding_type="alibi",
    activation_function="swiglu", layer_norm_epsilon=1e-5,
    mup_width_scale=0.5, mup_embeddings_scale=3.0, mup_output_alpha=2.0,
    mup_scale_qk_dot_by_d=True)
# Baichuan-13B-Base's config.json (width 5120 picks ALiBi in both adapters)
# at 2 layers; its model is cut to width 80 (10 heads of 8) for the CPU
BAICHUAN_13B = SimpleNamespace(
    vocab_size=VOCAB, hidden_size=5120, num_hidden_layers=2,
    num_attention_heads=40, intermediate_size=13696, rms_norm_eps=1e-6,
    tie_word_embeddings=False)
BAICHUAN_TINY = dict(n_embd=80, n_head=10, n_inner=96)


def _sd(spec, seed):
    """A seeded HF state dict: name -> (shape, std), or (shape, "ones")."""
    rng = np.random.default_rng(seed)
    return {name: (np.ones(shape, np.float32) if std == "ones" else
                   (rng.standard_normal(shape) * std).astype(np.float32))
            for name, (shape, std) in spec.items()}


def _btlm_spec(c):
    e, f = c.hidden_size, c.n_inner
    spec = {"transformer.wte.weight": ((c.vocab_size, e), 0.1),
            "transformer.ln_f.weight": ((e,), "ones"),
            "transformer.ln_f.bias": ((e,), 0.02)}
    for i in range(c.num_hidden_layers):
        p = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            spec[p + ln + ".weight"] = ((e,), "ones")
            spec[p + ln + ".bias"] = ((e,), 0.02)
        # Conv1D weights (in, out)
        for name, (n_in, n_out) in (("attn.c_attn", (e, 3 * e)),
                                    ("attn.c_proj", (e, e)),
                                    ("mlp.c_fc", (e, f)), ("mlp.c_fc2", (e, f)),
                                    ("mlp.c_proj", (f, e))):
            spec[p + name + ".weight"] = ((n_in, n_out), n_in ** -0.5)
            spec[p + name + ".bias"] = ((n_out,), 0.02)
    return spec


def _baichuan_spec(c, e, f):
    spec = {"model.embed_tokens.weight": ((c.vocab_size, e), 0.1),
            "model.norm.weight": ((e,), "ones"),
            "lm_head.weight": ((c.vocab_size, e), e ** -0.5)}
    for i in range(c.num_hidden_layers):
        p = f"model.layers.{i}."
        spec[p + "input_layernorm.weight"] = ((e,), "ones")
        spec[p + "post_attention_layernorm.weight"] = ((e,), "ones")
        for name, (n_out, n_in) in (("self_attn.W_pack", (3 * e, e)),
                                    ("self_attn.o_proj", (e, e)),
                                    ("mlp.gate_proj", (f, e)),
                                    ("mlp.up_proj", (f, e)),
                                    ("mlp.down_proj", (e, f))):
            spec[p + name + ".weight"] = ((n_out, n_in), n_in ** -0.5)
    return spec


def _from_adapters(family, hf, spec, **cut):
    """JAX's model and params and the port's model, from the same HF config
    (``cut``: widths replaced in both configs) and seeded state dict."""
    j_cfg = getattr(JA, f"{family}_config_to_gpt_config")(
        hf, dtype=jnp.float32, max_decode_seqlen=32)
    t_cfg = getattr(TA, f"{family}_config_to_gpt_config")(
        hf, dtype=torch.float32, max_decode_seqlen=32)
    for f in dataclasses.fields(t_cfg):
        if f.name != "dtype":
            assert getattr(t_cfg, f.name) == getattr(j_cfg, f.name), f.name
    j_cfg = dataclasses.replace(j_cfg, **cut)
    t_cfg = dataclasses.replace(t_cfg, **cut)
    sd = _sd(spec, 7)
    params = getattr(JA, f"remap_state_dict_hf_{family}")(sd, j_cfg)
    tmodel = GPTLMHeadModel(t_cfg, device="cpu")
    tmodel.load_state_dict(getattr(TA, f"remap_state_dict_hf_{family}")(
        {k: torch.from_numpy(v) for k, v in sd.items()}, t_cfg))
    return JaxGPTLMHeadModel(j_cfg), params, tmodel


def _softcap_gpt():
    fields = dict(vocab_size=VOCAB, n_positions=0, n_embd=64, n_layer=2,
                  n_head=4, rotary_emb_fraction=1.0, use_rms_norm=True,
                  glu_act=True, softcap=2.0, max_decode_seqlen=32)
    jmodel = JaxGPTLMHeadModel(JaxGPTConfig(dtype=jnp.float32, **fields))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = GPTLMHeadModel(GPTConfig(dtype=torch.float32, **fields),
                            device="cpu")
    load_jax_params(tmodel, params)
    return jmodel, params, tmodel


MODELS = {
    "btlm": lambda: _from_adapters("btlm", BTLM, _btlm_spec(BTLM)),
    "baichuan_13b": lambda: _from_adapters(
        "baichuan", BAICHUAN_13B,
        _baichuan_spec(BAICHUAN_13B, BAICHUAN_TINY["n_embd"],
                       BAICHUAN_TINY["n_inner"]), **BAICHUAN_TINY),
    "softcap_gpt": _softcap_gpt,
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_logits_and_decode_match_jax(name):
    """The configs equal field for field (the adapters' families), the
    logits against JAX's (atol 1e-4), greedy static decode's tokens and
    per-step logits against JAX's teacher-forced forward over the decoded
    sequences; the ALiBi models' slopes are JAX's schedule."""
    jmodel, params, tmodel = MODELS[name]()
    cfg = tmodel.config
    if cfg.use_alibi:
        mixer = tmodel.transformer.layers[0].mixer
        np.testing.assert_allclose(
            mixer.alibi_slopes.numpy(),
            np.asarray(_jax_slopes(cfg.n_head)), rtol=1e-6)
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, PROMPT))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    seqs, length, scores = decode(torch.from_numpy(ids), tmodel,
                                  GenerationConfig(max_length=MAX_LEN),
                                  output_scores=True)
    assert length == MAX_LEN
    # one JAX forward over the decoded sequences: its first PROMPT rows are
    # the prompt's logits (causal; ALiBi's last-key form changes no output),
    # the rest the teacher-forced steps'
    full = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(seqs[:, :-1].numpy(),
                                               jnp.int32)))
    np.testing.assert_allclose(got.numpy(), full[:, :PROMPT], atol=1e-4,
                               rtol=0)
    tf = full[:, PROMPT - 1:]
    np.testing.assert_allclose(scores.transpose(0, 1).numpy(), tf, atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(seqs[:, PROMPT:].numpy(), tf.argmax(-1))


def _jax_slopes(h):
    from flash_attn_tpu.modules.mha import MHA as JaxMHA

    return JaxMHA(embed_dim=8 * h, num_heads=h)._alibi_slopes()


def test_btlm_remap_matches_jax():
    """remap_state_dict_hf_btlm against JAX's through load_jax_params: every
    parameter bitwise the same, the gated MLP's [c_fc2, c_fc] order and
    the Conv1D transposes included; the slopes come from no tensor."""
    cfg = TA.btlm_config_to_gpt_config(BTLM, max_decode_seqlen=32)
    sd = _sd(_btlm_spec(BTLM), 3)
    ours = TA.remap_state_dict_hf_btlm(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    theirs = GPTLMHeadModel(cfg, device="cpu")
    load_jax_params(theirs, JA.remap_state_dict_hf_btlm(
        sd, JA.btlm_config_to_gpt_config(BTLM)))
    named = dict(theirs.named_parameters())
    assert set(ours) == set(named)
    for name, t in ours.items():
        assert torch.equal(t, named[name].detach()), name


def _alibi_model(**fields):
    return GPTLMHeadModel(GPTConfig(
        vocab_size=VOCAB, n_positions=0, n_embd=64, n_layer=1, n_head=4,
        use_rms_norm=True, glu_act=True, use_alibi=True,
        max_decode_seqlen=32, dtype=torch.float32, **fields), device="cpu")


@pytest.mark.parametrize("what", ["trainer", "prefix-cached engine",
                                  "prefix-cached admission", "packed input",
                                  "gradient"])
def test_score_models_refuse_what_is_not_ported(what):
    """The prefix-cached engine and admission of an ALiBi model raise,
    naming queue C (JAX's admission drops the slopes). What was refused
    until the backwards took the score map now runs: a Trainer of an ALiBi
    or softcap config takes a step with a finite loss and gradient norm,
    packed input to an MHA with softcap or ALiBi gives the padded dense
    call's output and a finite input gradient, and a gradient through train
    mode reaches every parameter (held to JAX in
    tests/test_torch_score_training.py)."""
    from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
    from flash_attn_tpu_torch.training.trainer import TrainConfig, Trainer

    if what == "trainer":
        for fields in (dict(use_alibi=True), dict(softcap=30.0)):
            cfg = GPTConfig(vocab_size=VOCAB, n_positions=0, n_embd=64,
                            n_layer=1, n_head=4, dtype=torch.float32,
                            **fields)
            tr = Trainer(TrainConfig(model=cfg, batch_size=1, seqlen=8),
                         device="cpu")
            ids = torch.randint(0, VOCAB, (1, 9),
                                generator=torch.Generator().manual_seed(0))
            loss, gnorm = tr.train_step(ids[:, :-1], ids[:, 1:])
            assert math.isfinite(float(loss)) and float(gnorm) > 0
    elif what == "prefix-cached engine":
        model = _alibi_model(paged_kv_num_pages=9, paged_kv_page_size=8)
        with pytest.raises(ValueError, match="queue C"):
            InferenceEngine(model, 2, GenerationConfig(top_k=1),
                            page_pool=PagePool(9, 8, 4, 2),
                            prefix_cache=True, device="cpu")
    elif what == "prefix-cached admission":
        mha = MHA(64, 4, causal=True, use_alibi=True, paged_kv_num_pages=9,
                  paged_kv_page_size=8, max_decode_seqlen=32,
                  dtype=torch.float32, device="cpu")
        table = torch.arange(8, dtype=torch.int32).reshape(2, 4) + 1
        with pytest.raises(NotImplementedError, match="queue C"):
            mha(torch.randn(2, 4, 64), mode="prefill", cache=KVCache(),
                block_table=table, prefix_lengths=torch.tensor([8, 8]))
    elif what == "packed input":
        for kw in (dict(use_alibi=True), dict(softcap=3.0)):
            mha = MHA(64, 4, causal=True, dtype=torch.float32, device="cpu",
                      **kw)
            x = torch.randn(10, 64, requires_grad=True)
            out = mha(x, cu_seqlens=torch.tensor([0, 4, 10],
                                                 dtype=torch.int32),
                      max_seqlen=6)
            for lo, hi in ((0, 4), (4, 10)):
                torch.testing.assert_close(out[lo:hi],
                                           mha(x[None, lo:hi])[0],
                                           atol=1e-5, rtol=1e-5)
            out.square().sum().backward()
            assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    else:
        model = _alibi_model()
        model(torch.zeros((1, 6), dtype=torch.long)).sum().backward()
        grads = [p.grad for p in model.parameters()]
        assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert alibi_slopes(4).tolist() == [0.25, 0.0625, 0.015625, 0.00390625]
