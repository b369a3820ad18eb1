"""Windowed models of the port against the JAX package's and against
Hugging Face's Mistral, on the CPU in fp32 (the port on its kernels' plain
versions, JAX on its Pallas kernels in interpret mode).

A tiny GPTLMHeadModel with ``window_size=(15, 0)`` (two layers, GQA 4/2)
over JAX's weights: prefill logits (atol 1e-4, as tests/test_torch_
models.py), greedy static decode past the window against JAX's
teacher-forced forward, and the engines (paged, prefix-cached,
speculative) against JAX's engine, token for token, once per scenario. A
tiny ``transformers`` MistralForCausalLM (``sliding_window=16``, random
weights, its config written here) against the port built as the JAX
package would build Mistral: the Llama adapter's config, then
``window_size=(15, 0)`` (atol 1e-3, rtol 1e-2, as the other HF
families). Then the three calls that once raised run: a Trainer on a
windowed config, a gradient through the windowed model, and packed input
with a window (held to JAX in tests/test_torch_band_varlen.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.serving.engine import InferenceEngine as JaxEngine
from flash_attn_tpu.serving.engine import PagePool as JaxPagePool
from flash_attn_tpu.serving.generation import GenerationConfig as JaxGenConfig
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    load_jax_params,
)
from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
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

WINDOW = (15, 0)
FIELDS = dict(vocab_size=96, n_positions=0, n_embd=64, n_layer=2, n_head=4,
              n_head_kv=2, rotary_emb_fraction=1.0, use_rms_norm=True,
              glu_act=True, max_decode_seqlen=64, window_size=WINDOW)
PAGE = 16
MPPS = -(-FIELDS["max_decode_seqlen"] // PAGE)
PROMPT, MAX_LEN = 24, 44  # prompts longer than the window, decode past it


@pytest.fixture(scope="module")
def params():
    model = JaxGPTLMHeadModel(JaxGPTConfig(dtype=jnp.float32, **FIELDS))
    return model.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 8), jnp.int32))["params"]


def _port(params, **fields):
    tmodel = GPTLMHeadModel(GPTConfig(dtype=torch.float32,
                                      **{**FIELDS, **fields}), device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return tmodel


def test_windowed_model_and_static_decode_match_jax(params):
    """Prefill logits against JAX's (atol 1e-4), then greedy static decode
    past the window: each step's logits and token against JAX's
    teacher-forced forward over the decoded sequence. Without the window
    the same weights give other logits."""
    jmodel = JaxGPTLMHeadModel(JaxGPTConfig(dtype=jnp.float32, **FIELDS))
    tmodel = _port(params)
    ids = np.random.default_rng(2).integers(0, 96, (2, PROMPT))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
        unwindowed = _port(params, window_size=(-1, -1))(
            torch.from_numpy(ids).long())
    seqs, length, scores = decode(torch.from_numpy(ids), tmodel,
                                  GenerationConfig(max_length=MAX_LEN),
                                  output_scores=True)
    assert length == MAX_LEN
    # one JAX forward over the decoded sequences: its first PROMPT rows are
    # the prompt's logits (causal, windowed), the rest the teacher-forced
    # steps'
    full = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(seqs[:, :-1].numpy(),
                                               jnp.int32)))
    want = full[:, :PROMPT]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert np.abs(unwindowed.numpy() - want)[:, WINDOW[0] + 1:].max() > 1e-2
    tf = full[:, PROMPT - 1:]
    np.testing.assert_allclose(scores.transpose(0, 1).numpy(), tf, atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(seqs[:, PROMPT:].numpy(), tf.argmax(-1))


def _jobs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 96, size=n).tolist(), m) for n, m in shapes]


def _run(eng, jobs):
    ids = [eng.submit(p, max_new_tokens=m) for p, m in jobs]
    res = eng.run()
    return [res[i] for i in ids]


def _jax_engine(params, num_pages, **kw):
    fields = dict(FIELDS, paged_kv_num_pages=num_pages,
                  paged_kv_page_size=PAGE)
    return JaxEngine(JaxGPTLMHeadModel(JaxGPTConfig(dtype=jnp.float32,
                                                    **fields)),
                     params, 2, JaxGenConfig(top_k=1),
                     page_pool=JaxPagePool(num_pages, PAGE, MPPS, 2), **kw)


def _port_engine(params, num_pages, **kw):
    tmodel = _port(params, paged_kv_num_pages=num_pages,
                   paged_kv_page_size=PAGE)
    return InferenceEngine(tmodel, 2, GenerationConfig(top_k=1),
                           page_pool=PagePool(num_pages, PAGE, MPPS, 2),
                           device="cpu", **kw)


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["paged", "prefix"])
def test_windowed_engine_matches_jax(params, prefix_cache):
    """The paged engine (admissions through the dense prefill, decode
    through the paged route) and the prefix-cached one (a prompt sharing
    two full pages with an earlier one admits through the paged varlen
    route, whose window edge falls inside the shared pages), prompts and
    decode longer than the window: JAX's tokens and page accounting."""
    rng = np.random.default_rng(13)
    common = rng.integers(0, 96, size=33).tolist()
    jobs = [(common + [1, 2], 8), (rng.integers(0, 96, 20).tolist(), 12),
            (common + [5, 6, 7], 9)]
    num_pages = 2 * MPPS + 4
    kw = dict(prefix_cache=True) if prefix_cache else {}
    jeng = _jax_engine(params, num_pages, **kw)
    teng = _port_engine(params, num_pages, **kw)
    want = _run(jeng, jobs[:2])
    assert _run(teng, jobs[:2]) == want
    want = _run(jeng, jobs[2:])
    assert _run(teng, jobs[2:]) == want
    assert teng.stats() == jeng.stats()
    if prefix_cache:
        assert teng.stats()["prefix_hit_pages"] >= 2


def test_windowed_speculative_engine_matches_plain(params):
    """Speculative rounds (k = 3) with the target as its own draft over a
    windowed model: each of the k + 1 verify rows masks its own window, so
    the tokens are the plain engine's (greedy acceptance is lossless) and
    JAX's."""
    jobs = _jobs(29, [(20, 14), (18, 10)])
    num_pages = 2 * MPPS + 8
    want = _run(_jax_engine(params, num_pages), jobs)
    plain = _port_engine(params, num_pages)
    assert _run(plain, jobs) == want
    draft = _port(params)
    spec = _port_engine(params, num_pages, draft_model=draft,
                        speculative_k=3)
    assert _run(spec, jobs) == want


def _mistral_cfg():
    """A tiny Mistral (mistralai/Mistral-7B-v0.1's config.json shape: Llama
    plus sliding_window) with a window of 16 keys."""
    return transformers.MistralConfig(
        vocab_size=96, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, sliding_window=16, tie_word_embeddings=False,
        attn_implementation="eager")


def test_mistral_matches_hf_through_the_llama_adapter():
    """HF keeps key j for query i iff j > i - sliding_window
    (transformers masking_utils sliding_window_overlay): window_size =
    (sliding_window - 1, 0) with causal masking. The port's Llama adapter
    does not read sliding_window (JAX's does not either); the window is set
    on its config as the JAX package would set it. Logits over sequences
    three times the window against HF's; without the window they differ."""
    hf_cfg = _mistral_cfg()
    torch.manual_seed(0)
    hf = transformers.MistralForCausalLM(hf_cfg).eval()
    cfg = llama.llama_config_to_gpt_config(hf_cfg, max_decode_seqlen=64)
    assert cfg.window_size == (-1, -1)
    cfg = dataclasses.replace(cfg, window_size=(hf_cfg.sliding_window - 1, 0))
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(llama.remap_state_dict_hf_llama(hf.state_dict(),
                                                          cfg))
    ids = torch.randint(0, 96, (2, 48),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = hf(ids).logits.float()
        got = model(ids)
        full = GPTLMHeadModel(dataclasses.replace(cfg, window_size=(-1, -1)),
                              device="cpu")
        full.load_state_dict(model.state_dict())
        unwindowed = full(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-2)
    assert (unwindowed - want)[:, 16:].abs().max() > 1e-2
    # greedy decode past the window against HF's forward over the result
    seqs, _, scores = decode(ids[:, :20], model,
                             GenerationConfig(max_length=40),
                             output_scores=True)
    with torch.no_grad():
        tf = hf(seqs[:, :-1]).logits.float()[:, 19:]
    np.testing.assert_allclose(scores.transpose(0, 1).numpy(), tf.numpy(),
                               atol=1e-3, rtol=1e-2)


def test_windowed_training_and_packed_input_raise():
    """The three calls that raised before the backward took the band (the
    name is kept from then) now run: a Trainer on a windowed config is
    built and takes a step with a finite loss; a gradient through a
    windowed model reaches every parameter, finite; packed input
    (cu_seqlens: B7 forward, B6 backward) with a window gives each
    sequence's dense train-mode output, and gradients."""
    from flash_attn_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = GPTConfig(dtype=torch.float32, **FIELDS)
    tr = Trainer(TrainConfig(model=cfg, batch_size=1, seqlen=20,
                             warmup_steps=1, zero1=False, log_every=1),
                 device="cpu")
    ids = torch.randint(0, 96, (1, 21), generator=torch.Generator()
                        .manual_seed(3))
    loss, gnorm = tr.train_step(ids[:, :-1], ids[:, 1:])
    assert np.isfinite(float(loss)) and np.isfinite(float(gnorm))
    model = GPTLMHeadModel(cfg, device="cpu")
    model(ids[:, :-1]).sum().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
    mha = model.transformer.layers[0].mixer
    x = torch.randn(20, 64, generator=torch.Generator().manual_seed(4),
                    requires_grad=True)
    cu = torch.tensor([0, 8, 20], dtype=torch.int32)
    packed = mha(x, cu_seqlens=cu, max_seqlen=12)
    packed.sum().backward()
    assert bool(torch.isfinite(x.grad).all())
    with torch.no_grad():
        dense = torch.cat([mha(x[None, a:b])[0] for a, b in ((0, 8),
                                                             (8, 20))])
    torch.testing.assert_close(packed.detach(), dense, atol=1e-5, rtol=1e-5)
