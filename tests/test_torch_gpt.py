"""The port's GPT model and greedy generation (flash_attn_tpu_torch)
against the JAX package on the same weights, in fp32 on the CPU, at the
tiny configuration of __graft_entry__.py (GQA, rotary, RMSNorm, SwiGLU,
tied embeddings)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.serving.generation import GenerationConfig as JaxGenConfig
from flash_attn_tpu.serving.generation import decode as jax_decode
from flash_attn_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    load_jax_params,
)
from flash_attn_tpu_torch.serving.generation import (
    GenerationConfig,
    decode,
    sample_token,
)

torch.set_num_threads(1)

PROMPT, MAX_LEN = 8, 16


@pytest.fixture(scope="module")
def models():
    jcfg = _tiny_config(dtype=jnp.float32)
    jmodel = JaxGPTLMHeadModel(jcfg)
    ids = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tmodel = GPTLMHeadModel(GPTConfig(**fields, dtype=torch.float32),
                            device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel, ids


def test_logits_match_jax(models):
    jmodel, params, tmodel, _ = models
    ids = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(np.int32)
    logits_j = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        logits_t = tmodel(torch.from_numpy(ids).long())
    assert logits_t.dtype == torch.float32 and logits_t.shape == (2, 24, 512)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, atol=1e-4, rtol=0)


def test_greedy_decode_token_identical(models):
    jmodel, params, tmodel, ids = models
    seqs_j, len_j = jax_decode(jnp.asarray(ids), jmodel, params,
                               JaxGenConfig(max_length=MAX_LEN))
    seqs_t, len_t = decode(torch.from_numpy(ids).long(), tmodel,
                           GenerationConfig(max_length=MAX_LEN))
    np.testing.assert_array_equal(seqs_t.numpy(), np.asarray(seqs_j))
    assert len_t == int(len_j) == MAX_LEN


def test_teacher_outputs_and_scores_match_jax(models):
    jmodel, params, tmodel, ids = models
    teacher = np.random.default_rng(2).integers(
        0, 512, (2, MAX_LEN)).astype(np.int32)
    seqs_j, _, scores_j = jax_decode(
        jnp.asarray(ids), jmodel, params, JaxGenConfig(max_length=MAX_LEN),
        output_scores=True, teacher_outputs=jnp.asarray(teacher))
    seqs_t, _, scores_t = decode(
        torch.from_numpy(ids).long(), tmodel,
        GenerationConfig(max_length=MAX_LEN), output_scores=True,
        teacher_outputs=torch.from_numpy(teacher).long())
    np.testing.assert_array_equal(seqs_t.numpy(), np.asarray(seqs_j))
    np.testing.assert_array_equal(seqs_t[:, PROMPT:].numpy(), teacher[:, PROMPT:])
    assert scores_t.shape == (MAX_LEN - PROMPT, 2, 512)
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j),
                               atol=1e-4, rtol=0)


def test_top_k_sampling_properties(models):
    """Sampling streams differ across frameworks; hold the port to the
    properties instead: each token is in the top k of its logits, and one
    seed gives one sequence."""
    _, _, tmodel, ids = models
    cfg = GenerationConfig(max_length=MAX_LEN, top_k=5, temperature=0.7)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        runs.append(decode(torch.from_numpy(ids).long(), tmodel, cfg,
                           generator=gen, output_scores=True))
    (seqs, _, scores), (seqs2, _, _) = runs
    assert torch.equal(seqs, seqs2)
    top = scores.topk(5, dim=-1).indices                 # (steps, b, 5)
    new = seqs[:, PROMPT:].T                             # (steps, b)
    assert (top == new[..., None]).any(-1).all()
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    picks = torch.stack([sample_token(logits, torch.Generator().manual_seed(s),
                                      cfg) for s in range(20)])
    assert (logits.topk(5).indices[None] == picks[..., None]).any(-1).all()


def test_eos_decode_matches_jax(models):
    """With eos_token_id, a row that emits it is padded with it and the
    loop stops when every row has: the same sequences and final length as
    JAX's while_loop. The eos is a token the first row emits early."""
    jmodel, params, tmodel, ids = models
    probe, _ = decode(torch.from_numpy(ids).long(), tmodel,
                      GenerationConfig(max_length=MAX_LEN))
    eos = int(probe[0, PROMPT + 2])
    seqs_j, len_j = jax_decode(jnp.asarray(ids), jmodel, params,
                               JaxGenConfig(max_length=MAX_LEN,
                                            eos_token_id=eos))
    seqs_t, len_t = decode(torch.from_numpy(ids).long(), tmodel,
                           GenerationConfig(max_length=MAX_LEN,
                                            eos_token_id=eos))
    np.testing.assert_array_equal(seqs_t.numpy(), np.asarray(seqs_j))
    assert len_t == int(len_j)
    assert (seqs_t[0, PROMPT + 2:] == eos).all()


def test_decode_state_is_static_across_calls(models):
    """The graphed decode keeps one set of static buffers on the model: a
    later call with the same batch and config reuses it (the same caches,
    by data_ptr) whatever its prompt length, and a call with another
    config replaces it, so at most one set remains. The eager path (the
    CPU's) keeps none: at two prompt lengths it prefills fresh caches and
    gives JAX's tokens and scores (atol 1e-4, fp32) in tensors of the
    caller's own. cg=True on the CPU raises."""
    from flash_attn_tpu_torch.serving.generation import _graphed_state

    jmodel, params, tmodel, ids = models
    cfg = GenerationConfig(max_length=MAX_LEN)
    tmodel._decode_state = None
    st = _graphed_state(tmodel, (2, cfg, True, False), False, "cpu")
    ptrs = [c.k.data_ptr() for c in st.cache] + [st.seqs.data_ptr()]
    assert _graphed_state(tmodel, (2, cfg, True, False), False, "cpu") is st
    assert [c.k.data_ptr() for c in st.cache] + [st.seqs.data_ptr()] == ptrs
    assert st.scores.shape[0] == MAX_LEN - 1  # any prompt length fits
    eos_cfg = dataclasses.replace(cfg, eos_token_id=3)
    other = _graphed_state(tmodel, (2, eos_cfg, False, False), False, "cpu")
    assert other is not st and tmodel._decode_state is other
    tmodel._decode_state = None

    results = []
    for plen in (PROMPT, PROMPT - 3):
        ids2 = np.random.default_rng(plen).integers(
            0, 512, (2, plen)).astype(np.int32)
        seqs_j, _, scores_j = jax_decode(jnp.asarray(ids2), jmodel, params,
                                         JaxGenConfig(max_length=MAX_LEN),
                                         output_scores=True)
        seqs_t, _, scores_t = decode(torch.from_numpy(ids2).long(), tmodel,
                                     cfg, output_scores=True)
        assert getattr(tmodel, "_decode_state") is None
        np.testing.assert_array_equal(seqs_t.numpy(), np.asarray(seqs_j))
        assert scores_t.shape == (MAX_LEN - plen, 2, 512)
        np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j),
                                   atol=1e-4, rtol=0)
        results.append(seqs_t)
    assert results[0].data_ptr() != results[1].data_ptr()
    with pytest.raises(ValueError, match="cg=True"):
        decode(torch.from_numpy(ids).long(), tmodel, cfg, cg=True)
