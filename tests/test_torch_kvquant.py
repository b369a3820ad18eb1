"""Quantized KV caches in the port against the JAX package on the same numpy
inputs, on the CPU: the port runs its kernels' plain versions (B4, B8), JAX
its Pallas kernels in interpret mode.

The store (dispatch/kvquant.py quantize_kv) equals JAX's ``astype`` bitwise
where JAX's cast is right and a numpy reference everywhere (queue C holds
where JAX's is wrong). Decode and the paged prefill read the same cache
bytes in both packages with the same (b, h_k) descales: the port's output
(fp32 arithmetic, bf16 out) is held to an fp32 reference over the
dequantized values by the repo's 2x rule against JAX's output (bf16 q and
bf16 probabilities inside its kernels), the appended cache bytes equal
JAX's. The models compare logits within stated bounds and tokens
exactly."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.cache.kvcache import (
    flash_attn_with_kvcache as jax_flash_attn_with_kvcache,
)
from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.serving.engine import InferenceEngine as JaxEngine
from flash_attn_tpu.serving.engine import PagePool as JaxPagePool
from flash_attn_tpu.serving.generation import GenerationConfig as JaxGenConfig
from flash_attn_tpu_torch import (
    flash_attn_varlen_func,
    flash_attn_with_kvcache,
)
from flash_attn_tpu_torch.cache.kvcache import kv_cache_update
from flash_attn_tpu_torch.dispatch.kvquant import quantize_kv
from flash_attn_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    load_jax_params,
)
from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
from flash_attn_tpu_torch.serving.generation import (
    GenerationConfig,
    decode,
)
from flash_attn_tpu_torch.utils import testing
from flash_attn_tpu_torch.utils.testing import check_against_ref

from jax_paged_refs import (
    jax_kvcache_paged,
    jax_varlen_paged,
    one_page_tiles,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_paged_kernels_at_one_page_tiles():
    """JAX's paged kernels run at a KV tile of one page wherever its package
    calls them (tests/jax_paged_refs.py): the same functions, lowered
    faster."""
    with one_page_tiles():
        yield

FP8 = (torch.float8_e4m3fn, jnp.float8_e4m3fn)
INT8 = (torch.int8, jnp.int8)
PAGE = 16
TABLE = np.array([[3, 0, 0, 0, 0, 0], [7, 1, 4, 0, 0, 0],
                  [2, 9, 11, 5, 6, 10]], np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _codes(rng, dt, shape):
    """Random cache bytes of ``dt`` (fp8 from N(0, 1) values, int8 codes in
    [-100, 100]) as (torch tensor, jax array) of the same bytes."""
    if dt is FP8:
        u8 = np.asarray(rng.standard_normal(shape).astype(np.float32).astype(
            jnp.float8_e4m3fn)).view(np.uint8)
    else:
        u8 = rng.integers(-100, 101, shape).astype(np.int8).view(np.uint8)
    return (torch.from_numpy(u8.copy()).view(dt[0]),
            jnp.asarray(u8.view(dt[1])))


def _bytes(x):
    return (x.view(torch.uint8).numpy() if torch.is_tensor(x)
            else np.asarray(x).view(np.uint8))


def _descales(rng, b, h_k):
    return [(0.5 + rng.random((b, h_k))).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dt", [FP8, INT8], ids=["e4m3", "int8"])
def test_store_matches_jax_cast_where_it_is_right(dt):
    """quantize_kv over every bf16 bit pattern: equal to a numpy reference
    (e4m3: round to nearest even and saturate at +-448; int8: round to
    nearest even, clamp to [-127, 127]) at every finite input, and to
    JAX's astype bitwise where JAX's cast is right: e4m3 for |x| <= 464
    (past it JAX gives NaN), int8 where truncation equals rounding and |x|
    <= 127 (JAX truncates toward zero and saturates at -128; ROADMAP.md
    queue C)."""
    bits = np.arange(65536, dtype=np.uint16)
    xb = bits.view(jnp.bfloat16)
    xf = xb.astype(np.float32)
    with np.errstate(invalid="ignore"):
        fin = np.isfinite(xf)
    port = _bytes(quantize_kv(torch.from_numpy(bits.view(np.int16)).view(
        torch.bfloat16), dt[0]))
    jx = np.asarray(jnp.asarray(xb).astype(dt[1]))
    if dt is FP8:
        ref = np.zeros(65536, np.uint8)
        ref[fin] = np.clip(xf[fin], -448, 448).astype(
            jnp.float8_e4m3fn).view(np.uint8)
        right = fin & (np.abs(xf) <= 464)
        wrong = fin & (np.abs(xf) > 464)
        assert np.isnan(jx[wrong].astype(np.float32)).all()
        assert set(port[wrong].tolist()) == {0x7E, 0xFE}  # +-448
    else:
        ref = np.zeros(65536, np.uint8)
        ref[fin] = np.clip(np.round(xf[fin]), -127, 127).astype(
            np.int8).view(np.uint8)
        right = fin.copy()
        right[fin] = (np.trunc(xf[fin]) == np.round(xf[fin])) \
            & (np.abs(xf[fin]) <= 127)
        assert jx[(xf == 2.5)].tolist() == [2] and jx[xf == 2.75] == [2]
        assert jx[xf == -300].tolist() == [-128]
    np.testing.assert_array_equal(port[fin], ref[fin])
    np.testing.assert_array_equal(port[right], jx[right].view(np.uint8))


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_store_saturates_where_the_plain_cast_does_not(paged):
    """The repaired cast store: an e4m3 cache past 464 reads +-448, not NaN;
    an int8 cache reads 300 as 127 (torch's .to(int8) wraps it to 44, JAX's
    astype saturates it) and rounds to nearest even (JAX truncates)."""
    vals = torch.tensor([500.0, -1000.0, 300.0, -300.0, 2.5, 3.5, -2.7,
                         1.0], dtype=torch.bfloat16)
    want = {torch.float8_e4m3fn: [448, -448, 288, -288, 2.5, 3.5, -2.75, 1],
            torch.int8: [127, -127, 127, -127, 2, 4, -3, 1]}
    new = vals.reshape(1, 8, 1, 1).expand(1, 8, 1, 16)
    for dt, w in want.items():
        shape = (3, 1, PAGE, 16) if paged else (1, 1, 128, 16)
        kc = torch.zeros(shape, dtype=dt)
        vc = torch.zeros(shape, dtype=dt)
        table = dict(block_table=torch.tensor([[2, 1]], dtype=torch.int32)) \
            if paged else {}
        kv_cache_update(kc, vc, new, new, torch.tensor([5], dtype=torch.int32),
                        **table)
        rows = kc[2, 0, 5:13] if paged else kc[0, 0, 5:13]
        assert rows.float()[:, 0].tolist() == [float(x) for x in w]
        assert torch.isfinite(kc.float()).all()
    assert vals.float()[2:3].to(torch.int8).tolist() == [44]


# (name, paged, sq, dtype, window, slopes, append): linear and paged, sq 1
# and 5, GQA 4/2, a window, ALiBi, an append
DECODE_CASES = [
    ("linear, e4m3, sq=1, append", False, 1, FP8, (-1, -1), None, True),
    ("paged, int8, sq=5, append", True, 5, INT8, (-1, -1), None, True),
    ("linear, int8, window, sq=5", False, 5, INT8, (20, 0), None, False),
    ("paged, e4m3, ALiBi, sq=1", True, 1, FP8, (-1, -1), "2d", False),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: c[0])
def test_flash_attn_with_kvcache_descales_match_jax(case):
    """Decode over the same 1-byte cache bytes with distinct (b, h_k)
    q/k/v descales, at 2 splits: the port's out (bf16, as JAX's) against an fp32
    reference over the dequantized values within twice JAX's own error
    (+1e-3: both round out to bf16), the lse within 0.05 of JAX's (JAX
    rounds the pre-scaled q to bf16: scores of a few units move by ~1e-2),
    and the appended cache bytes equal to JAX's (the new rows are values
    both casts store alike: N(0, 1) in e4m3, integers in int8)."""
    name, paged, sq, dt, window, slopes, append = case
    rng = np.random.default_rng(len(name) + sq)
    b, h, h_k, d = 3, 4, 2, 64
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32).astype(
        jnp.bfloat16)
    shape = (12, h_k, PAGE, d) if paged else (b, h_k, 96, d)
    kc_t, kc_j = _codes(rng, dt, shape)
    vc_t, vc_j = _codes(rng, dt, shape)
    lens = np.array([3, 35, 82], np.int32)  # before any append
    qd, kd, vd = _descales(rng, b, h_k)
    if dt is INT8:  # codes of up to 100 stand for values of a few units
        kd, vd = kd / 32, vd / 32
    extra = {}
    if append:
        if dt is FP8:
            new = [rng.standard_normal((b, sq, h_k, d)) for _ in range(2)]
        else:
            new = [rng.integers(-100, 101, (b, sq, h_k, d)) for _ in range(2)]
        extra = dict(zip("kv", (x.astype(np.float32).astype(jnp.bfloat16)
                                for x in new)))
    if paged:
        extra["block_table"] = TABLE
    if slopes:
        extra["alibi_slopes"] = (0.05 + 0.5 * rng.random((b, h))).astype(
            np.float32)
    kw = dict(causal=True, window_size=window)
    descales = dict(q_descale=jnp.asarray(qd), k_descale=jnp.asarray(kd),
                    v_descale=jnp.asarray(vd))
    if paged:  # JAX's paged decode at a KV tile of one page
        jextra = {n: jnp.asarray(x) for n, x in extra.items()
                  if n != "block_table"}
        res = jax_kvcache_paged(jnp.asarray(q), kc_j, vc_j, jnp.asarray(lens),
                                jnp.asarray(TABLE), 2, **descales, **kw,
                                **jextra)
    else:
        res = jax_flash_attn_with_kvcache(
            jnp.asarray(q), kc_j, vc_j, cache_seqlens=jnp.asarray(lens),
            num_splits=2, return_softmax_lse=True, **descales, **kw,
            **{n: jnp.asarray(x) for n, x in extra.items()})
    # with an append JAX returns the new caches too
    out_j, kc_j2, vc_j2, lse_j = res if append else (res[0], kc_j, vc_j,
                                                     res[1])
    out_t, lse_t = flash_attn_with_kvcache(
        _t(q.astype(np.float32)).bfloat16(), kc_t, vc_t,
        cache_seqlens=_t(lens), q_descale=_t(qd), k_descale=_t(kd),
        v_descale=_t(vd), num_splits=2, return_softmax_lse=True, **kw,
        **{n: (_t(x.astype(np.float32)).bfloat16() if n in "kv" else _t(x))
           for n, x in extra.items()})
    assert out_t.dtype == torch.bfloat16 and out_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bytes(kc_t), _bytes(kc_j2))
    np.testing.assert_array_equal(_bytes(vc_t), _bytes(vc_j2))
    # the fp32 reference over the values the caches hold after the call
    sk = lens + (sq if append else 0)
    table = _t(TABLE) if paged else None
    lin = [testing.paged_to_linear(c, table, _t(sk)) if paged
           else c.float() for c in (kc_t, vc_t)]
    k_val = lin[0] * _t(kd)[:, :, None, None]
    v_val = lin[1] * _t(vd)[:, :, None, None]
    q_val = _t(q.astype(np.float32)) * _t(qd).repeat_interleave(
        h // h_k, 1)[:, None, :, None]
    keep = torch.arange(k_val.shape[2])[None] < _t(sk)[:, None]
    ref, _ = testing.attention_ref(
        q_val, k_val.transpose(1, 2), v_val.transpose(1, 2),
        key_padding_mask=keep, causal=True,
        window_size=tuple(None if x < 0 else x for x in window),
        alibi_slopes=None if slopes is None else _t(extra["alibi_slopes"]))
    check_against_ref(out_t, ref, np.asarray(out_j, np.float32), atol=1e-3,
                      msg=name)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=0.05,
                               rtol=0)


@pytest.mark.parametrize("softcap", [0.0, 3.0], ids=["plain", "softcap"])
def test_flash_attn_varlen_paged_descales_match_jax(softcap):
    """flash_attn_varlen_func(block_table=) (B8's route) over the same
    e4m3 page bytes with distinct (b, h_k) descales: ragged chunks, one
    padded by seqused_q, over cached keys, causal, plain and capped (the
    descale applies before the cap): out in q's type against an fp32
    reference over the dequantized values by the 2x rule with JAX's out as
    the low-precision one (+1e-3), the lse within 0.05 of JAX's."""
    rng = np.random.default_rng(17)
    lens_q, lens_k, used = [9, 1, 30], [12, 40, 90], [9, 1, 24]
    cu = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    h, h_k, d = 4, 2, 64
    q = rng.standard_normal((int(cu[-1]), h, d)).astype(np.float32).astype(
        jnp.bfloat16)
    kp_t, kp_j = _codes(rng, FP8, (12, h_k, PAGE, d))
    vp_t, vp_j = _codes(rng, FP8, (12, h_k, PAGE, d))
    qd, kd, vd = _descales(rng, 3, h_k)
    lens_k, used = np.array(lens_k, np.int32), np.array(used, np.int32)
    kw = dict(causal=True, softcap=softcap, return_attn_probs=True)
    out_j, lse_j = jax_varlen_paged(
        jnp.asarray(q), kp_j, vp_j, jnp.asarray(cu), max(lens_q),
        jnp.asarray(lens_k), jnp.asarray(TABLE), seqused_q=jnp.asarray(used),
        q_descale=jnp.asarray(qd), k_descale=jnp.asarray(kd),
        v_descale=jnp.asarray(vd), causal=True, softcap=softcap)
    q_t = _t(q.astype(np.float32)).bfloat16()
    out_t, lse_t = flash_attn_varlen_func(
        q_t, kp_t, vp_t, _t(cu), None, max(lens_q), 96, block_table=_t(TABLE),
        seqused_k=_t(lens_k), seqused_q=_t(used), q_descale=_t(qd),
        k_descale=_t(kd), v_descale=_t(vd), **kw)
    assert out_t.dtype == torch.bfloat16
    # each page is one sequence's: its values under that row's descales
    k_val, v_val = kp_t.float(), vp_t.float()
    for s in range(3):
        pages = _t(TABLE[s, :-(-int(lens_k[s]) // PAGE)]).long()
        k_val[pages] *= _t(kd[s])[:, None, None]
        v_val[pages] *= _t(vd[s])[:, None, None]
    seq = np.repeat(np.arange(3), lens_q)
    q_val = _t(q.astype(np.float32)) * _t(qd[seq]).repeat_interleave(
        h // h_k, 1)[:, :, None]
    ref = testing.attention_varlen_paged_ref(
        q_val, k_val, v_val, _t(cu), _t(lens_k), _t(TABLE),
        seqused_q=_t(used), causal=True, softcap=softcap)
    live = np.concatenate([np.arange(n) < u for n, u in zip(lens_q, used)])
    check_against_ref(out_t[live], ref[live],
                      np.asarray(out_j, np.float32)[live], atol=1e-3,
                      msg=f"B8 descales softcap={softcap}")
    fin = np.isfinite(np.asarray(lse_j))
    np.testing.assert_array_equal(np.isfinite(lse_t.numpy()), fin)
    np.testing.assert_allclose(lse_t.numpy()[fin], np.asarray(lse_j)[fin],
                               atol=0.05, rtol=0)


def test_descale_refusals():
    """What the port refuses, as JAX does or naming queue A item 7:
    softcap with q_descale or k_descale raises ValueError (JAX asserts it,
    flash_decode.py:554-555), softcap with v_descale alone runs; descales
    on the MLA route, an fp8 q, descales on the dense varlen route and on
    B8p raise NotImplementedError; a GPT with softcap and a quantized cache
    raises ValueError at construction."""
    q = torch.randn(2, 1, 4, 64).bfloat16()
    kc = torch.randn(2, 2, 128, 64).to(torch.float8_e4m3fn)
    ones = torch.ones(2, 2)
    for name in ("q_descale", "k_descale"):
        with pytest.raises(ValueError, match="softcap"):
            flash_attn_with_kvcache(q, kc, kc.clone(), cache_seqlens=5,
                                    softcap=5.0, **{name: ones})
    out = flash_attn_with_kvcache(q, kc, kc.clone(), cache_seqlens=5,
                                  softcap=5.0, v_descale=ones)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    vc = torch.randn(2, 2, 128, 128).to(torch.float8_e4m3fn)
    with pytest.raises(NotImplementedError, match="item 7"):
        flash_attn_with_kvcache(q, kc, vc, cache_seqlens=5, k_descale=ones)
    with pytest.raises(NotImplementedError, match="item 7"):
        flash_attn_with_kvcache(q.to(torch.float8_e4m3fn), kc, kc.clone(),
                                cache_seqlens=5, k_descale=ones)
    x = torch.randn(10, 4, 64)
    cu = torch.tensor([0, 10], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 7"):
        flash_attn_varlen_func(x, x, x, cu, cu, 10, 10, k_descale=ones[:1])
    pages = torch.randn(4, 1, 16, 64)
    with pytest.raises(NotImplementedError, match="item 7"):
        flash_attn_varlen_func(
            x, pages, pages, cu, None, 10, 16, qv=torch.randn(10, 4, 64),
            block_table=torch.tensor([[1]], dtype=torch.int32),
            seqused_k=torch.tensor([10], dtype=torch.int32),
            k_descale=ones[:1, :1])
    with pytest.raises(ValueError, match="554-555"):
        GPTLMHeadModel(GPTConfig(**FIELDS, softcap=30.0,
                                 kv_cache_dtype=torch.float8_e4m3fn),
                       device="cpu")


FIELDS = dict(vocab_size=96, n_positions=0, n_embd=64, n_layer=2, n_head=4,
              n_head_kv=2, rotary_emb_fraction=1.0, use_rms_norm=True,
              glu_act=True, max_decode_seqlen=64)


@functools.lru_cache(maxsize=1)
def _jax_params():
    """One set of JAX GPT parameters for every model of the module (the
    cache's type, scale and layout add none), initialised over the GPT
    test's prompt shape so that its train-mode forward is the prefill's
    compile."""
    jm = JaxGPTLMHeadModel(JaxGPTConfig(dtype=jnp.float32, **FIELDS))
    return jm.init(jax.random.PRNGKey(0),
                   jnp.zeros((2, 24), jnp.int32))["params"]


def _models(scale, dtype=FP8, **extra):
    """JAX's GPT and the port's over the same parameters (load_jax_params:
    no parameter comes with the cache), fp32 weights, the cache in
    ``dtype`` at kv_cache_scale ``scale``."""
    fields = dict(FIELDS, **extra)
    jm = JaxGPTLMHeadModel(JaxGPTConfig(
        dtype=jnp.float32, kv_cache_dtype=dtype[1], kv_cache_scale=scale,
        **fields))
    params = _jax_params()
    tm = GPTLMHeadModel(GPTConfig(dtype=torch.float32, kv_cache_dtype=dtype[0],
                                  kv_cache_scale=scale, **fields),
                        device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_gpt_fp8_cache_matches_jax(scale):
    """GPTLMHeadModel with an fp8 cache at kv_cache_scale 1 and 2: a
    prefill then 4 greedy decode steps, the logits within 2e-2 of JAX's
    model over the same parameters (both read the same cache bytes: the
    prefill's K/V from fp32 projections, rounded to bf16 in the kernels'
    reads of q and the probabilities on JAX's side), the tokens and the
    cache bytes equal; every parameter came from JAX's tree."""
    jm, params, tm = _models(scale)
    ids = np.random.default_rng(3).integers(0, 96, (2, 24))
    lg_j, st = jm.apply({"params": params}, jnp.asarray(ids), mode="prefill",
                        mutable=["cache"])
    cache = tm.new_cache()
    with torch.no_grad():
        lg_t = tm(_t(ids).long(), mode="prefill", cache=cache)
    for step in range(5):
        np.testing.assert_allclose(lg_t[:, -1].numpy(),
                                   np.asarray(lg_j[:, -1]), atol=2e-2,
                                   rtol=0, err_msg=f"step {step}")
        tok = np.asarray(lg_j[:, -1]).argmax(-1)
        assert (lg_t[:, -1].argmax(-1).numpy() == tok).all()
        if step == 4:
            break
        lg_j, st = jm.apply({"params": params, "cache": st["cache"]},
                            jnp.asarray(tok[:, None], jnp.int32),
                            mode="decode", mutable=["cache"])
        with torch.no_grad():
            lg_t = tm(_t(tok[:, None]).long(), mode="decode", cache=cache)
    layer = st["cache"]["transformer"]["layers_0"]["mixer"]
    assert cache[0].k.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bytes(cache[0].k), _bytes(layer["k"]))
    np.testing.assert_array_equal(_bytes(cache[0].v), _bytes(layer["v"]))
    named = dict(tm.named_parameters())
    assert len(named) == len(jax.tree_util.tree_leaves(params))


def _run(eng, jobs):
    ids = [eng.submit(p, max_new_tokens=m) for p, m in jobs]
    res = eng.run()
    return [res[i] for i in ids]


# The prefix-cached engine's scenario: a prompt of two full pages and 5
# tokens, then one that shares its two pages with 36 more tokens; both
# admissions pad to one (rows, length) shape, (1, 64), so that JAX compiles
# one admission program.
PREFIX_ENGINE = dict(paged_kv_num_pages=12, paged_kv_page_size=PAGE,
                     max_decode_seqlen=96)


@pytest.fixture(scope="module")
def prefix_engine_tokens():
    """JAX's prefix-cached paged engine over an fp8 cache (kv_cache_scale
    2), one build for the module: the tokens of each phase and stats()."""
    jm, params, _ = _models(2.0, **PREFIX_ENGINE)
    rng = np.random.default_rng(13)
    common = rng.integers(0, 96, 2 * PAGE).tolist()
    phases = [[(common + rng.integers(0, 96, 5).tolist(), 5)],
              [(common + rng.integers(0, 96, 36).tolist(), 5)]]
    eng = JaxEngine(jm, params, 2, JaxGenConfig(top_k=1),
                    page_pool=JaxPagePool(12, PAGE, 6, 2), prefix_cache=True)
    outs = [_run(eng, jobs) for jobs in phases]
    assert eng.prefill_shapes == {(1, 64)}
    return params, phases, outs, eng.stats()


def test_prefix_engine_fp8_matches_jax(prefix_engine_tokens):
    """The port's prefix-cached paged engine over an fp8 cache gives JAX's
    tokens and stats(), the second admission hitting the first's two
    pages: admissions through B8 with descales over the converted pages,
    decode through B4 over the 1-byte pages."""
    params, phases, want, stats = prefix_engine_tokens
    fields = dict(FIELDS, **PREFIX_ENGINE)
    tm = GPTLMHeadModel(GPTConfig(
        dtype=torch.float32, kv_cache_dtype=torch.float8_e4m3fn,
        kv_cache_scale=2.0, **fields), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    eng = InferenceEngine(tm, 2, GenerationConfig(top_k=1),
                          page_pool=PagePool(12, PAGE, 6, 2),
                          prefix_cache=True, device="cpu")
    assert [_run(eng, jobs) for jobs in phases] == want
    assert eng.stats() == stats
    assert eng.stats()["prefix_hit_pages"] == 2


@pytest.mark.parametrize("dt", [FP8, INT8], ids=["e4m3", "int8"])
def test_quantized_cache_serves_through_every_path(dt):
    """The flagship GPT's architecture (rotary, RMSNorm, SwiGLU, tied
    embeddings, GQA) at tiny widths over a 1-byte cache on the CPU: static greedy decode, the paged engine, the prefix-cached
    engine and the speculative engine (the target as its own draft) give
    the same tokens; the logits stay within JAX's own drift bound (0.15,
    tests/test_fp8.py:133-134) of the bf16 cache's, teacher-forced."""
    base = dict(FIELDS, max_decode_seqlen=48)
    # int8 codes are whole multiples of the scale: 1/32 keeps K/V's few
    # significant bits, as an fp8 cache's 2.0 keeps e4m3's range
    cfg = GPTConfig(dtype=torch.bfloat16, kv_cache_dtype=dt[0],
                    kv_cache_scale=2.0 if dt is FP8 else 1 / 32, **base)
    torch.manual_seed(0)
    model = GPTLMHeadModel(cfg, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(1))
    model.requires_grad_(False)
    ids = torch.randint(0, 96, (2, 20), generator=torch.Generator()
                        .manual_seed(2))
    gc = GenerationConfig(max_length=28)
    seqs, _, scores = decode(ids, model, gc, output_scores=True)
    plain = GPTLMHeadModel(dataclasses.replace(cfg, kv_cache_dtype=None),
                           device="cpu")
    plain.load_state_dict(model.state_dict())
    _, _, ref = decode(ids, plain, gc, output_scores=True,
                       teacher_outputs=seqs)
    drift = [float((scores[t] - ref[t]).abs().max() / ref[t].abs().max())
             for t in range(1, 8)]
    assert max(drift) < 0.15
    want = seqs[:, 20:].tolist()
    jobs = [(ids[i].tolist(), 8) for i in range(2)]
    for kind in ("paged", "prefix", "speculative"):
        paged = GPTLMHeadModel(dataclasses.replace(
            cfg, paged_kv_num_pages=9, paged_kv_page_size=PAGE),
            device="cpu")
        paged.load_state_dict(model.state_dict())
        kw = dict(prefix_cache=True) if kind == "prefix" else {}
        if kind == "speculative":
            kw = dict(draft_model=model, speculative_k=3)
            eng = InferenceEngine(model, 2, GenerationConfig(top_k=1),
                                  device="cpu", **kw)
        else:
            eng = InferenceEngine(paged, 2, GenerationConfig(top_k=1),
                                  page_pool=PagePool(9, PAGE, 3, 2),
                                  device="cpu", **kw)
        assert _run(eng, jobs) == want, kind
