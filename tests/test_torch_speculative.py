"""The port's speculative decoding (flash_attn_tpu_torch.serving.
speculative) against the JAX package's, on the CPU in fp32 at the tiny
configurations of tests/test_speculative.py (a 2-layer target, a 1-layer
draft of half its width), JAX's weights carried across. Greedy rounds are
exact, so the tokens must be equal; the filters compare in fp32 to 1e-6;
the acceptance test's sampling guarantee is held by a chi-square test
over seeded draws, since the two frameworks' random streams differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.serving.generation import GenerationConfig as JaxGenConfig
from flash_attn_tpu.serving.speculative import (
    _filter_logits as jax_filter_logits,
)
from flash_attn_tpu.serving.speculative import (
    decode_speculative as jax_decode_speculative,
)
from flash_attn_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    load_jax_params,
)
from flash_attn_tpu_torch.serving.generation import GenerationConfig, decode
from flash_attn_tpu_torch.serving.speculative import (
    _filter_logits,
    decode_speculative,
    sample_speculative,
)

torch.set_num_threads(1)

VOCAB = 96


def _pair(layers, embd, heads, seed):
    """A JAX model with its params and the port's model over them."""
    fields = dict(vocab_size=VOCAB, n_positions=0, n_embd=embd,
                  n_layer=layers, n_head=heads, rotary_emb_fraction=1.0,
                  use_rms_norm=True, glu_act=True, max_decode_seqlen=64)
    jmodel = JaxGPTLMHeadModel(JaxGPTConfig(dtype=jnp.float32, **fields))
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = GPTLMHeadModel(GPTConfig(dtype=torch.float32, **fields),
                            device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def models():
    return _pair(2, 64, 4, 0), _pair(1, 32, 2, 1)


@pytest.mark.parametrize("top_k, top_p, temperature, min_p", [
    (1, 0.0, 1.0, 0.0), (5, 0.0, 0.7, 0.0), (0, 0.9, 1.3, 0.0),
    (0, 0.0, 1.0, 0.1), (8, 0.8, 0.9, 0.05)])
def test_filter_logits_matches_jax(top_k, top_p, temperature, min_p):
    """The same tokens survive each filter and keep the same logits."""
    logits = np.random.default_rng(0).standard_normal((3, 4, 40)).astype(
        np.float32)
    want = np.asarray(jax_filter_logits(jnp.asarray(logits), top_k, top_p,
                                        temperature, min_p))
    got = _filter_logits(torch.from_numpy(logits), top_k, top_p,
                         temperature, min_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    kept = ~np.isinf(want)
    assert kept.any(axis=-1).all()
    np.testing.assert_allclose(got[kept], want[kept], atol=1e-6, rtol=0)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_greedy_speculative_matches_jax_and_greedy_decode(models, k):
    """Greedy decode_speculative at batch 3 gives JAX's sequences and the
    port's own greedy decode's, never with more target calls than tokens
    (tests/test_speculative.py:26-69)."""
    (jt, pt, tt), (jd, pd, td) = models
    ids = np.random.default_rng(5).integers(0, VOCAB, (3, 6)).astype(
        np.int32)
    max_len = 20
    want, calls_j = jax_decode_speculative(
        jnp.asarray(ids), jt, pt, jd, pd, JaxGenConfig(max_length=max_len),
        speculative_k=k)
    got, calls_t = decode_speculative(
        torch.from_numpy(ids).long(), tt, td,
        GenerationConfig(max_length=max_len), speculative_k=k)
    plain, _ = decode(torch.from_numpy(ids).long(), tt,
                      GenerationConfig(max_length=max_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, plain)
    assert calls_t == calls_j <= max_len - 6


def test_perfect_draft_accepts_everything(models):
    """The target as its own draft: every round accepts all k proposals
    and adds the bonus token, so the target runs about new / (k + 1)
    times, and the tokens are its greedy decode's."""
    (_, _, tt), _ = models
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, 4))
    k, max_len = 4, 32
    seqs, calls = decode_speculative(torch.from_numpy(ids), tt, tt,
                                     GenerationConfig(max_length=max_len),
                                     speculative_k=k)
    plain, _ = decode(torch.from_numpy(ids), tt,
                      GenerationConfig(max_length=max_len))
    assert torch.equal(seqs, plain)
    assert calls == 1 + -(-(max_len - 4 - 1) // (k + 1))


@pytest.mark.parametrize("top_k", [0, 4])
def test_sample_speculative_keeps_the_target_distribution(top_k):
    """Leviathan et al.'s acceptance makes the first emitted token
    distributed as the (filtered) target: 40,000 seeded rows, the draft's
    proposals drawn from its own filtered distribution; a chi-square test
    of the first token's counts against p_target (p > 1e-3), with tokens
    the filter removes never emitted."""
    rng = np.random.default_rng(0)
    vocab, k, n = 8, 3, 40_000
    lt = torch.from_numpy(rng.standard_normal((1, k + 1, vocab)).astype(
        np.float32)).expand(n, -1, -1)
    ld = torch.from_numpy(rng.standard_normal((1, k, vocab)).astype(
        np.float32)).expand(n, -1, -1)
    gen = torch.Generator().manual_seed(1)
    pd = _filter_logits(ld, top_k, 0.0, 1.0).softmax(-1)
    draft = torch.multinomial(pd.reshape(-1, vocab), 1, generator=gen
                              ).reshape(n, k)
    tokens, num = sample_speculative(lt, ld, draft, gen, top_k=top_k)
    assert ((num >= 1) & (num <= k + 1)).all()
    p_t = _filter_logits(lt[0, 0], top_k, 0.0, 1.0).softmax(-1).double()
    counts = torch.bincount(tokens[:, 0], minlength=vocab).double()
    assert counts[p_t == 0].sum() == 0
    keep = p_t > 0
    expected = n * p_t[keep] / p_t[keep].sum()  # sums to n exactly
    _, p_value = stats.chisquare(counts[keep].numpy(), expected.numpy())
    assert p_value > 1e-3, (counts, n * p_t)


def test_sampled_speculative_runs_and_is_seeded(models):
    """Top-k sampling: tokens in the vocabulary, the full length, and one
    generator seed gives one sequence."""
    (_, _, tt), (_, _, td) = models
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, VOCAB,
                                                             (2, 5)))
    cfg = GenerationConfig(max_length=18, top_k=8, temperature=0.9)
    runs = [decode_speculative(ids, tt, td, cfg, speculative_k=3,
                               generator=torch.Generator().manual_seed(11))
            for _ in range(2)]
    (seqs, calls), (seqs2, _) = runs
    assert seqs.shape == (2, 18) and torch.equal(seqs, seqs2)
    assert 0 <= int(seqs.min()) and int(seqs.max()) < VOCAB and calls >= 2


def test_greedy_acceptance_breaks_ties_as_argmax():
    """Greedy rounds take each distribution as the one-hot of its argmax,
    the first index on ties, as sample_token does: a proposal tied with an
    earlier maximum is rejected and the earlier index emitted, whatever the
    generator. JAX's greedy round keeps both tied maxima in its filter
    (flash_attn_tpu/serving/speculative.py:39-41), so such a proposal can
    pass its ratio test (:82) and a rejection draws among the ties
    (:97-98): its tokens leave the target's greedy decode at random on
    bf16 ties. The port does not copy that."""
    vocab, k = 10, 3
    logits = torch.zeros(2, k + 1, vocab)
    logits[:, :, 3] = logits[:, :, 5] = 2.0  # tied maxima at 3 and 5
    logits[1, 1, 7] = 3.0                    # row 1's second argmax is 7
    draft = torch.tensor([[3, 3, 5], [3, 7, 3]])
    for seed in range(5):
        tokens, num = sample_speculative(
            logits, torch.randn(2, k, vocab), draft,
            torch.Generator().manual_seed(seed))
        assert num.tolist() == [3, 4]
        assert tokens[0, :3].tolist() == [3, 3, 3]
        assert tokens[1].tolist() == [3, 7, 3, 3]
