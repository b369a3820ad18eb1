"""Tiny GPT-J (head dim 256) and GPT-NeoX (head dim 96) models of the port
(flash_attn_tpu_torch) against the JAX package's GPTLMHeadModel over the
same weights, in fp32 on the CPU: logits at atol 1e-4 (as
tests/test_torch_models.py), and greedy decode (static, and through the
paged engine) as JAX's teacher-forced forward over the decoded sequence
says. On the card these head dims run the forward and decode kernels'
96 and 256 instantiations (tests/test_torch_wide_heads.py holds the
attention functions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
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

VOCAB, PROMPT, MAX_LEN = 128, 10, 22
# Tiny GPT-J (parallel block, one norm, interleaved rotary on a quarter of
# each head, tanh GELU, no attention biases) at head dim 256 and GPT-NeoX
# (parallel block, untied norms, rotary on a quarter, exact GELU) at 96,
# as the HF adapters configure them.
FAMILIES = {
    "gptj_256": dict(n_embd=512, n_head=2, rotary_emb_fraction=0.25,
                     rotary_emb_interleaved=True, activation="gelu_approx",
                     parallel_block=True, parallel_block_tied_norm=True,
                     qkv_proj_bias=False, out_proj_bias=False),
    "neox_96": dict(n_embd=192, n_head=2, rotary_emb_fraction=0.25,
                    activation="gelu", parallel_block=True,
                    parallel_block_tied_norm=False),
}


def _pair(fields, **port_fields):
    """JAX's GPTLMHeadModel with initialised params and the port's holding
    the same weights (fp32)."""
    fields = dict(vocab_size=VOCAB, n_positions=0, n_layer=2, n_inner=256,
                  tie_word_embeddings=False, max_decode_seqlen=32, **fields)
    jmodel = JaxGPTLMHeadModel(JaxGPTConfig(dtype=jnp.float32, **fields))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = GPTLMHeadModel(GPTConfig(dtype=torch.float32, **fields,
                                      **port_fields), device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_logits_and_decode_match_jax(name):
    """The tiny model's logits against JAX's (atol 1e-4); greedy static
    decode's tokens and per-step logits, and the paged engine's tokens,
    against JAX's teacher-forced forward over the decoded sequences."""
    jmodel, params, tmodel = _pair(FAMILIES[name])
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, PROMPT))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    seqs, length, scores = decode(torch.from_numpy(ids), tmodel,
                                  GenerationConfig(max_length=MAX_LEN),
                                  output_scores=True)
    assert length == MAX_LEN
    # one JAX forward over the decoded sequences: its first PROMPT rows are
    # the prompt's logits (causal), the rest the teacher-forced steps'
    full = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(seqs[:, :-1].numpy(),
                                               jnp.int32)))
    np.testing.assert_allclose(got.numpy(), full[:, :PROMPT], atol=1e-4,
                               rtol=0)
    tf = full[:, PROMPT - 1:]
    np.testing.assert_allclose(scores.transpose(0, 1).numpy(), tf, atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(seqs[:, PROMPT:].numpy(), tf.argmax(-1))

    _, _, paged = _pair(FAMILIES[name], paged_kv_num_pages=16,
                        paged_kv_page_size=8)
    eng = InferenceEngine(paged, 2, GenerationConfig(top_k=1),
                          page_pool=PagePool(16, 8, 4, 2),
                          decode_block_size=4, device="cpu")
    req = [eng.submit(p.tolist(), max_new_tokens=MAX_LEN - PROMPT)
           for p in ids]
    out = eng.run()
    for rid, row in zip(req, seqs.numpy()):
        np.testing.assert_array_equal(out[rid], row[PROMPT:])
