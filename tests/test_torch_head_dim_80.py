"""Head dim 80 (BTLM-3B-8K: 32 heads of 80, ALiBi, softmax scale 1/d), which
every kernel of the port takes on the card (the forwards B1, B4 d = dv, B8,
B6 and B7, the backwards B2, B3 and B6), against the JAX package on the
same seeded numpy inputs, on the CPU: the port runs the plain versions of
its kernels, JAX its Pallas kernels in interpret mode (the paged ones at a
KV tile of one page, tests/jax_paged_refs.py).

The attention functions are held to JAX in fp32 (atol/rtol 1e-5) and in
bf16 under the 2x rule (the port's bf16 output against JAX's fp32 output on
the same bf16-rounded inputs, within twice JAX's own bf16 error plus
1e-5); over an fp8 cache the port's output is held to an fp32 reference
over the dequantized values with JAX's output as the low-precision one, as
tests/test_torch_kvquant.py does. A tiny BTLM at its own head dim (2 heads
of 80) from both packages' adapters over one seeded HF state dict: logits
against JAX's, greedy static decode against JAX's teacher-forced forward,
and the paged and speculative engines' tokens against the static decode's.
In training (fp32 on both sides, gradients at atol 1e-4 as
tests/test_torch_score_backward.py): flash_attn_func's gradients in both
deterministic modes under ALiBi at 1/80, the cap and a window against
jax.grad, the dense flash_attn_varlen_func's (B6 under ALiBi, B7 under the
cap) against jax.vjp, the packed MHA under ALiBi at 1/80 against JAX's, and
the tiny BTLM's Trainer against JAX's Trainer for 4 steps.
The plain forms at 80 (flash_attn_func, flash_attn_with_kvcache linear and
paged with an append, flash_attn_varlen_func(block_table=)) are in
tests/test_torch_wide_heads.py."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.cache.kvcache import (
    flash_attn_with_kvcache as jax_flash_attn_with_kvcache,
)
from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu.interface import flash_attn_varlen_func as jax_varlen
from flash_attn_tpu.models import hf_adapters as JA
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.modules.mha import MHA as JaxMHA
from flash_attn_tpu.training.trainer import TrainConfig as JaxTrainConfig
from flash_attn_tpu.training.trainer import Trainer as JaxTrainer
from flash_attn_tpu_torch import (
    flash_attn_func,
    flash_attn_varlen_func,
    flash_attn_with_kvcache,
)
from flash_attn_tpu_torch.models import hf_adapters as TA
from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel, jax_param_arrays
from flash_attn_tpu_torch.modules.mha import MHA
from flash_attn_tpu_torch.training.trainer import TrainConfig, Trainer
from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
from flash_attn_tpu_torch.serving.generation import GenerationConfig, decode
from flash_attn_tpu_torch.utils import testing
from flash_attn_tpu_torch.utils.testing import check_against_ref

from jax_paged_refs import jax_kvcache_paged, one_page_tiles

torch.set_num_threads(1)

D = 80
SCALE = 1.0 / D  # BTLM's mup_scale_qk_dot_by_d
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_ATOL = 1e-4  # gradients, fp32 on both sides: summation order only
PAGE = 16
TABLE = np.array([[3, 0, 0, 0], [7, 1, 0, 0], [2, 9, 11, 0]], np.int32)


@pytest.fixture(scope="module", autouse=True)
def _jax_paged_kernels_at_one_page_tiles():
    """JAX's paged kernels run at a KV tile of one page wherever its package
    calls them (tests/jax_paged_refs.py): the same functions, lowered
    faster."""
    with one_page_tiles():
        yield


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(*arrays):
    ts = [torch.from_numpy(a).bfloat16() for a in arrays]
    return ts, [t.float().numpy() for t in ts]


def _slopes(rng, shape):
    return (0.05 + 0.5 * rng.random(shape)).astype(np.float32)


# (name, causal, h, h_k, slopes shape (None: none), window, scale,
# bf16 too): ALiBi at BTLM's scale, GQA, causal; a window over (b, h)
# slopes, not causal, sq < sk
FUNC_CASES = [
    ("alibi, causal, GQA 4/2, scale 1/80", True, 4, 2, "h", (-1, -1), SCALE,
     True),
    ("alibi (b, h) under a window, not causal, GQA 4/2", False, 4, 2, "bh",
     (12, 5), None, False),
]


@pytest.mark.parametrize("case", FUNC_CASES, ids=lambda c: c[0])
def test_flash_attn_func_at_80_matches_jax(case):
    name, causal, h, h_k, slopes, window, scale, bf16 = case
    rng = np.random.default_rng(len(name))
    b, sq, sk = 2, 29, 53
    q, k, v = _rand(rng, b, sq, h, D), _rand(rng, b, sk, h_k, D), \
        _rand(rng, b, sk, h_k, D)
    sl = None if slopes is None else _slopes(
        rng, (h,) if slopes == "h" else (b, h))
    kw = dict(causal=causal, window_size=window, softmax_scale=scale)
    out_j, lse_j, _ = jax_flash_attn_func(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_attn_probs=True,
        alibi_slopes=None if sl is None else jnp.asarray(sl), **kw)
    out_t, lse_t, _ = flash_attn_func(
        _t(q), _t(k), _t(v), return_attn_probs=True,
        alibi_slopes=None if sl is None else _t(sl), **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    lse_t, lse_j = lse_t.numpy(), np.asarray(lse_j)
    np.testing.assert_array_equal(np.isneginf(lse_t), np.isneginf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], **TOL)
    if not bf16:
        return
    (qb, kb, vb), f32 = _bf16(q, k, v)
    jsl = None if sl is None else jnp.asarray(sl)
    ref = jax_flash_attn_func(*map(jnp.asarray, f32), alibi_slopes=jsl, **kw)
    ref_lp = jax_flash_attn_func(
        *(jnp.asarray(x, jnp.bfloat16) for x in f32), alibi_slopes=jsl, **kw)
    check_against_ref(
        flash_attn_func(qb, kb, vb, alibi_slopes=None if sl is None
                        else _t(sl), **kw),
        ref, np.asarray(ref_lp, np.float32), msg=name)


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_flash_attn_with_kvcache_alibi_at_80_matches_jax(paged):
    """Decode with an append under ALiBi at BTLM's scale, GQA 4/2, 2
    splits: sq = 1 over a linear cache, the verify step's sq = 5 over a
    paged one; the output and the mutated caches, in fp32 and by the 2x
    rule in bf16."""
    rng = np.random.default_rng(80 + paged)
    b, h, h_k, sq = 3, 4, 2, 5 if paged else 1
    q = _rand(rng, b, sq, h, D)
    k_new, v_new = _rand(rng, b, sq, h_k, D), _rand(rng, b, sq, h_k, D)
    shape = (12, h_k, PAGE, D) if paged else (b, h_k, 64, D)
    kc, vc = _rand(rng, *shape), _rand(rng, *shape)
    seqlens = np.array([5, 30, 41], np.int32)  # before the append
    sl = _slopes(rng, (h,))
    kw = dict(causal=True, softmax_scale=SCALE)

    def jax_run(dtype, q, k_new, v_new, kc, vc):
        args = [jnp.asarray(x, dtype) for x in (q, kc, vc)]
        new = dict(k=jnp.asarray(k_new, dtype), v=jnp.asarray(v_new, dtype))
        if paged:
            return jax_kvcache_paged(*args, jnp.asarray(seqlens),
                                     jnp.asarray(TABLE), 2,
                                     alibi_slopes=jnp.asarray(sl), **new,
                                     **kw)[:3]
        return jax_flash_attn_with_kvcache(
            *args, **new, cache_seqlens=jnp.asarray(seqlens), num_splits=2,
            alibi_slopes=jnp.asarray(sl), **kw)

    def port_run(q, k_new, v_new, kc, vc):
        return flash_attn_with_kvcache(
            q, kc, vc, k=k_new, v=v_new, cache_seqlens=_t(seqlens),
            num_splits=2, alibi_slopes=_t(sl),
            block_table=_t(TABLE) if paged else None, **kw)

    out_j, kc_j, vc_j = jax_run(jnp.float32, q, k_new, v_new, kc, vc)
    kc_t, vc_t = _t(kc), _t(vc)
    out_t = port_run(_t(q), _t(k_new), _t(v_new), kc_t, vc_t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j), **TOL)
    np.testing.assert_allclose(vc_t.numpy(), np.asarray(vc_j), **TOL)
    bf, f32 = _bf16(q, k_new, v_new, kc, vc)
    ref, _, _ = jax_run(jnp.float32, *f32)
    ref_lp, _, _ = jax_run(jnp.bfloat16, *f32)
    check_against_ref(port_run(*bf), ref, np.asarray(ref_lp, np.float32),
                      msg=f"flash_attn_with_kvcache alibi d=80 paged={paged}")


def test_fp8_cache_with_descales_at_80_matches_jax():
    """Decode over the same fp8 page bytes with distinct (b, h_k) q/k/v
    descales at BTLM's scale under ALiBi, sq = 1, 2 splits: the port's out
    (bf16) against an fp32 reference over the dequantized values within
    twice JAX's own error (+1e-3: both round out to bf16), the lse within
    0.05 of JAX's (JAX rounds the pre-scaled q to bf16)."""
    rng = np.random.default_rng(8)
    b, h, h_k, sq = 3, 4, 2, 1
    q = rng.standard_normal((b, sq, h, D)).astype(np.float32).astype(
        jnp.bfloat16)
    codes = [np.asarray(rng.standard_normal((12, h_k, PAGE, D)).astype(
        np.float32).astype(jnp.float8_e4m3fn)).view(np.uint8)
        for _ in range(2)]
    kc_t, vc_t = (torch.from_numpy(c.copy()).view(torch.float8_e4m3fn)
                  for c in codes)
    kc_j, vc_j = (jnp.asarray(c.view(jnp.float8_e4m3fn)) for c in codes)
    lens = np.array([3, 20, 41], np.int32)
    qd, kd, vd = ((0.5 + rng.random((b, h_k))).astype(np.float32)
                  for _ in range(3))
    sl = _slopes(rng, (b, h))
    out_j, lse_j = jax_kvcache_paged(
        jnp.asarray(q), kc_j, vc_j, jnp.asarray(lens), jnp.asarray(TABLE), 2,
        q_descale=jnp.asarray(qd), k_descale=jnp.asarray(kd),
        v_descale=jnp.asarray(vd), alibi_slopes=jnp.asarray(sl), causal=True,
        softmax_scale=SCALE)
    q_t = _t(q.astype(np.float32)).bfloat16()
    out_t, lse_t = flash_attn_with_kvcache(
        q_t, kc_t, vc_t, cache_seqlens=_t(lens), block_table=_t(TABLE),
        q_descale=_t(qd), k_descale=_t(kd), v_descale=_t(vd),
        alibi_slopes=_t(sl), causal=True, softmax_scale=SCALE, num_splits=2,
        return_softmax_lse=True)
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (b, sq, h, D)
    lin = [testing.paged_to_linear(c, _t(TABLE), _t(lens))
           for c in (kc_t, vc_t)]
    k_val = lin[0] * _t(kd)[:, :, None, None]
    v_val = lin[1] * _t(vd)[:, :, None, None]
    q_val = _t(q.astype(np.float32)) * _t(qd).repeat_interleave(
        h // h_k, 1)[:, None, :, None]
    keep = torch.arange(k_val.shape[2])[None] < _t(lens)[:, None]
    ref, _ = testing.attention_ref(
        q_val, k_val.transpose(1, 2), v_val.transpose(1, 2),
        key_padding_mask=keep, causal=True, softmax_scale=SCALE,
        alibi_slopes=_t(sl))
    check_against_ref(out_t, ref, np.asarray(out_j, np.float32), atol=1e-3,
                      msg="fp8 cache with descales, d=80")
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=0.05,
                               rtol=0)


VOCAB, PROMPT, MAX_LEN = 128, 10, 20
# BTLM's config.json fields at its own head dim: 2 heads of 80, 2 layers
BTLM = SimpleNamespace(
    vocab_size=VOCAB, n_positions=0, hidden_size=160, num_hidden_layers=2,
    num_attention_heads=2, n_inner=192, position_embedding_type="alibi",
    activation_function="swiglu", layer_norm_epsilon=1e-5,
    mup_width_scale=0.5, mup_embeddings_scale=3.0, mup_output_alpha=2.0,
    mup_scale_qk_dot_by_d=True)


def _btlm_state_dict(c, seed):
    """A seeded HF BTLM state dict (GPT-2's Conv1D weights, (in, out))."""
    rng = np.random.default_rng(seed)
    e, f = c.hidden_size, c.n_inner
    spec = {"transformer.wte.weight": ((c.vocab_size, e), 0.1),
            "transformer.ln_f.weight": ((e,), None),
            "transformer.ln_f.bias": ((e,), 0.02)}
    for i in range(c.num_hidden_layers):
        p = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            spec[p + ln + ".weight"] = ((e,), None)
            spec[p + ln + ".bias"] = ((e,), 0.02)
        for name, (n_in, n_out) in (("attn.c_attn", (e, 3 * e)),
                                    ("attn.c_proj", (e, e)),
                                    ("mlp.c_fc", (e, f)), ("mlp.c_fc2", (e, f)),
                                    ("mlp.c_proj", (f, e))):
            spec[p + name + ".weight"] = ((n_in, n_out), n_in ** -0.5)
            spec[p + name + ".bias"] = ((n_out,), 0.02)
    return {name: (np.ones(shape, np.float32) if std is None else
                   (rng.standard_normal(shape) * std).astype(np.float32))
            for name, (shape, std) in spec.items()}


@pytest.fixture(scope="module")
def btlm():
    """JAX's BTLM and its params and the port's, linear and paged, from the
    two adapters over one seeded HF state dict."""
    j_cfg = JA.btlm_config_to_gpt_config(BTLM, dtype=jnp.float32,
                                         max_decode_seqlen=32)
    t_cfg = TA.btlm_config_to_gpt_config(BTLM, dtype=torch.float32,
                                         max_decode_seqlen=32)
    sd = _btlm_state_dict(BTLM, 11)
    params = JA.remap_state_dict_hf_btlm(sd, j_cfg)
    port = {}
    for name, cfg in (("linear", t_cfg), ("paged", dataclasses.replace(
            t_cfg, paged_kv_num_pages=16, paged_kv_page_size=8))):
        port[name] = GPTLMHeadModel(cfg, device="cpu")
        port[name].load_state_dict(TA.remap_state_dict_hf_btlm(
            {k: torch.from_numpy(v) for k, v in sd.items()}, cfg))
    return JaxGPTLMHeadModel(j_cfg), params, port


@pytest.fixture(scope="module")
def btlm_decoded(btlm):
    """The prompts and the port's greedy static decode of them (tokens and
    per-step logits) over the tiny BTLM's linear cache."""
    ids = np.random.default_rng(3).integers(0, VOCAB, (2, PROMPT))
    seqs, length, scores = decode(torch.from_numpy(ids), btlm[2]["linear"],
                                  GenerationConfig(max_length=MAX_LEN),
                                  output_scores=True)
    assert length == MAX_LEN
    return ids, seqs, scores


def test_tiny_btlm_at_80_matches_jax(btlm, btlm_decoded):
    """The tiny BTLM's logits against JAX's (atol 1e-4) at its scale 1/80;
    greedy static decode's tokens and per-step logits against JAX's
    teacher-forced forward over the decoded sequences."""
    jmodel, params, port = btlm
    ids, seqs, scores = btlm_decoded
    tmodel = port["linear"]
    mixer = tmodel.transformer.layers[0].mixer
    assert mixer.head_dim == D and mixer.softmax_scale == SCALE
    # one JAX forward over the decoded sequences: its first PROMPT rows are
    # the prompt's logits (causal; ALiBi's last-key form changes no output),
    # the rest the teacher-forced steps'
    full = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(seqs[:, :-1].numpy(),
                                               jnp.int32)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), full[:, :PROMPT], atol=1e-4,
                               rtol=0)
    tf = full[:, PROMPT - 1:]
    np.testing.assert_allclose(scores.transpose(0, 1).numpy(), tf, atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(seqs[:, PROMPT:].numpy(), tf.argmax(-1))


@pytest.mark.parametrize("engine", ["paged", "speculative"])
def test_tiny_btlm_at_80_engines_match_static_decode(btlm, btlm_decoded,
                                                     engine):
    """The paged engine's tokens, and the speculative engine's (the model
    as its own draft over a linear cache, k = 4: the verify step at sq = 5
    under ALiBi), equal to the static decode's, which
    test_tiny_btlm_at_80_matches_jax holds to JAX's teacher-forced
    forward."""
    port = btlm[2]
    ids, seqs, _ = btlm_decoded
    spec = dict(draft_model=port["linear"], speculative_k=4) \
        if engine == "speculative" else {}
    eng = InferenceEngine(port["paged"], 2, GenerationConfig(top_k=1),
                          page_pool=PagePool(16, 8, 4, 2),
                          decode_block_size=4, device="cpu", **spec)
    req = [eng.submit(p.tolist(), max_new_tokens=MAX_LEN - PROMPT)
           for p in ids]
    out = eng.run()
    for rid, row in zip(req, seqs.numpy()):
        np.testing.assert_array_equal(out[rid], row[PROMPT:])


# (name, sq, sk, h, h_k, causal, window, softcap, slopes, scale): ALiBi over
# (h,) slopes at BTLM's scale with GQA and sq < sk under the causal shift;
# the cap under a causal window; (b, h) slopes and the cap, not causal,
# sq > sk. No case runs sq = sk = 1 causal (JAX's dv fault at one row,
# ROADMAP.md queue C).
GRAD_CASES = [
    ("alibi (h,), causal, GQA 4/2, sq < sk, scale 1/80", 37, 70, 4, 2, True,
     (-1, -1), 0.0, "h", SCALE),
    ("cap 5 under a causal window, GQA 4/1", 64, 64, 4, 1, True, (9, 0), 5.0,
     None, None),
    ("alibi (b, h) and cap 3, not causal, sq > sk", 70, 37, 2, 2, False,
     (-1, -1), 3.0, "bh", None),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: c[0])
def test_flash_attn_func_grads_at_80_match_jax(case):
    """dq, dk, dv of flash_attn_func at 80, deterministic (B3) and not
    (B2), against jax.grad of JAX's flash_attn_func; a requires_grad
    slopes tensor gets exact zeros, as JAX returns."""
    name, sq, sk, h, h_k, causal, window, cap, slopes, scale = case
    rng = np.random.default_rng(sq + sk + h)
    q, k, v = _rand(rng, 2, sq, h, D), _rand(rng, 2, sk, h_k, D), \
        _rand(rng, 2, sk, h_k, D)
    g = _rand(rng, 2, sq, h, D)
    sl = None if slopes is None else _slopes(
        rng, (h,) if slopes == "h" else (2, h))
    kw = dict(causal=causal, window_size=window, softcap=cap,
              softmax_scale=scale)

    def loss(q_, k_, v_):
        return (jax_flash_attn_func(
            q_, k_, v_, alibi_slopes=None if sl is None else jnp.asarray(sl),
            **kw) * g).sum()
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for deterministic in (True, False):
        leaves = [_t(x).requires_grad_() for x in (q, k, v)]
        tsl = None if sl is None else _t(sl).requires_grad_()
        out = flash_attn_func(*leaves, alibi_slopes=tsl,
                              deterministic=deterministic, **kw)
        (out * _t(g)).sum().backward()
        for gname, leaf, ref in zip("qkv", leaves, want):
            np.testing.assert_allclose(
                leaf.grad.numpy(), np.asarray(ref), atol=GRAD_ATOL, rtol=0,
                err_msg=f"{name} d{gname} deterministic={deterministic}")
        if tsl is not None:
            assert torch.equal(tsl.grad, torch.zeros_like(tsl))


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


# (name, lens_q, lens_k, causal, softcap, slopes, h, h_k, scale): ALiBi
# through B6's forward (as JAX routes it) at BTLM's scale with a
# zero-length sequence and GQA; the cap through B7 with sq != sk under the
# causal shift (rows that see no key)
VARLEN_GRAD_CASES = [
    ("B6 under alibi (b, h), causal, GQA 4/2, scale 1/80", [40, 0, 70],
     [40, 0, 70], True, 0.0, "bh", 4, 2, SCALE),
    ("B7 under cap 4, sq != sk, causal", [50, 21, 64], [30, 40, 64],
     True, 4.0, None, 2, 2, None),
]


@pytest.mark.parametrize("case", VARLEN_GRAD_CASES, ids=lambda c: c[0])
def test_varlen_func_grads_at_80_match_jax(case):
    """The dense flash_attn_varlen_func at 80: out, lse and dq, dk, dv
    against jax.vjp of JAX's flash_attn_varlen_func (out and lse atol/rtol
    1e-5, the lse in JAX's last-key form)."""
    name, lens_q, lens_k, causal, cap, slopes, h, h_k, scale = case
    rng = np.random.default_rng(sum(lens_q) + h)
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    q, k, v = _rand(rng, tq, h, D), _rand(rng, tk, h_k, D), \
        _rand(rng, tk, h_k, D)
    g = _rand(rng, tq, h, D)
    sl = None if slopes is None else _slopes(rng, (len(lens_q), h))
    kw = dict(causal=causal, softcap=cap, softmax_scale=scale)
    args = (max(lens_q), max(lens_k))

    def jfn(q_, k_, v_):
        out, lse, _ = jax_varlen(
            q_, k_, v_, jnp.asarray(cu_q), jnp.asarray(cu_k), *args,
            alibi_slopes=None if sl is None else jnp.asarray(sl), **kw,
            return_attn_probs=True)
        return out, lse

    (out_j, lse_j), vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    grads_j = vjp((jnp.asarray(g), jnp.zeros_like(lse_j)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out_t, lse_t, _ = flash_attn_varlen_func(
        *leaves, _t(cu_q), _t(cu_k), *args,
        alibi_slopes=None if sl is None else _t(sl), **kw,
        return_attn_probs=True)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    fin = np.isfinite(np.asarray(lse_j))
    np.testing.assert_array_equal(np.isfinite(lse_t.numpy()), fin)
    np.testing.assert_allclose(lse_t.numpy()[fin], np.asarray(lse_j)[fin],
                               **TOL)
    out_t.backward(_t(g))
    for gname, leaf, gj in zip("qkv", leaves, grads_j):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gj),
                                   atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"{name} d{gname}")


def test_packed_alibi_mha_at_80_matches_jax():
    """The packed MHA (cu_seqlens, a zero-length sequence among them) with
    ALiBi at BTLM's scale, 2 heads of 80 and no biases (BTLM's attention
    without its biases, whose key bias softmax cancels) against JAX's MHA
    on the same cu_seqlens: the output (atol/rtol 1e-5) and the input's
    gradient (atol 1e-4)."""
    rng = np.random.default_rng(23)
    kw = dict(num_heads=2, causal=True, use_alibi=True, softmax_scale=SCALE,
              qkv_proj_bias=False, out_proj_bias=False)
    jm = JaxMHA(embed_dim=2 * D, dtype=jnp.float32, **kw)
    tm = MHA(2 * D, dtype=torch.float32, device="cpu", **kw)
    cu = _cu([30, 0, 47])
    x, g = _rand(rng, 77, 2 * D), _rand(rng, 77, 2 * D)
    # the parameters depend on the widths alone: a tiny dense input gives
    # the same ones without lowering the packed kernels for init
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8, 2 * D), jnp.float32))["params"]
    tm.load_state_dict({n: _t(a) for n, a in tm.jax_param_arrays(
        jax.tree_util.tree_map(np.asarray, params)).items()})

    def jf(x_):
        out = jm.apply({"params": params}, x_, cu_seqlens=jnp.asarray(cu),
                       max_seqlen=47)
        return (out * g).sum(), out
    (_, out_j), dx_j = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    out_t = tm(xt, cu_seqlens=_t(cu), max_seqlen=47)
    out_t.backward(_t(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j),
                               atol=GRAD_ATOL, rtol=0)


def test_tiny_btlm_trainer_at_80_matches_jax_trainer():
    """A Trainer on the tiny BTLM (2 heads of 80, ALiBi, muP's scales and
    the softmax scale 1/80, from the port's adapter) against JAX's Trainer
    on JAX's adapter's config, 4 steps over sequences of 64 tokens, fp32
    optimizer state: the losses and gradient norms at every step (rtol
    1e-4) and the parameters after (atol 1e-4), all but the key bias: a
    key bias adds a constant to each row's scores, which softmax cancels,
    so its gradient is zero up to rounding and Adam's step on that noise
    compares nothing (tests/test_torch_score_training.py drops the biases
    for that reason; BTLM has them)."""
    jcfg = JA.btlm_config_to_gpt_config(BTLM, dtype=jnp.float32)
    cfg = TA.btlm_config_to_gpt_config(BTLM, dtype=torch.float32)
    train = dict(batch_size=2, seqlen=64, lr=1e-2, warmup_steps=1,
                 total_steps=10, zero1=False, fused_ce=True,
                 fused_ce_chunk=48, log_every=1, opt_state_dtype="float32")
    jtr = JaxTrainer(JaxTrainConfig(model=jcfg, **train))
    tr = Trainer(TrainConfig(model=cfg, **train), device="cpu")
    mixer = tr.model.transformer.layers[0].mixer
    assert mixer.head_dim == D and mixer.softmax_scale == SCALE
    tr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    rng = np.random.default_rng(24)
    for _ in range(4):
        b = rng.integers(0, VOCAB, (2, 65)).astype(np.int32)
        out = jtr._step(jtr.params, jtr.opt_state, jnp.asarray(b[:, :-1]),
                        jnp.asarray(b[:, 1:]), jtr.ema_params, jtr.scaler)
        jtr.params, jtr.opt_state = out[0], out[1]
        loss, gnorm = tr.train_step(torch.from_numpy(b[:, :-1]).long(),
                                    torch.from_numpy(b[:, 1:]).long())
        np.testing.assert_allclose(float(loss), float(out[2]), rtol=1e-4)
        np.testing.assert_allclose(float(gnorm), float(out[3]), rtol=1e-4)
    want = jax_param_arrays(tr.model,
                            jax.tree_util.tree_map(np.asarray, jtr.params))
    e = BTLM.hidden_size
    for n, a in want.items():
        diff = np.abs(tr.masters[n].numpy() - a)
        if n.endswith("mixer.Wqkv.bias"):
            diff[e:2 * e] = 0.0  # the key bias
        assert diff.max() <= 1e-4, n
