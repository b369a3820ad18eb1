"""The port's attention functions (flash_attn_tpu_torch) against the JAX
package on the same numpy inputs, on the CPU: the port runs the plain
versions of its kernels, JAX its Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.cache.kvcache import (
    flash_attn_with_kvcache as jax_flash_attn_with_kvcache,
)
from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu.kernels.flash_decode import (
    combine_splits as jax_combine_splits,
)
from flash_attn_tpu_torch import (
    flash_attn_func,
    flash_attn_varlen_func,
    flash_attn_with_kvcache,
)
from flash_attn_tpu_torch.kernels.flash_decode import combine_splits
from flash_attn_tpu_torch.utils.testing import attention_ref, check_against_ref

torch.set_num_threads(1)

# fp32 on both sides: the two differ only in summation order.
TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _assert_lse(lse_t, lse_j):
    lse_t, lse_j = lse_t.numpy(), np.asarray(lse_j)
    np.testing.assert_array_equal(np.isneginf(lse_t), np.isneginf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], **TOL)


@pytest.mark.parametrize("sq,sk,h,h_k,d,causal", [
    (64, 64, 4, 4, 64, False),
    (64, 64, 4, 4, 64, True),
    (37, 101, 4, 2, 64, True),     # sq < sk, bottom-right causal, GQA
    (37, 101, 4, 2, 128, False),
    (48, 48, 4, 1, 128, True),     # MQA
    (40, 24, 2, 2, 64, True),      # sq > sk: the first rows see no key
])
def test_flash_attn_func_matches_jax(sq, sk, h, h_k, d, causal):
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, 2, sq, h, d), _rand(rng, 2, sk, h_k, d), \
        _rand(rng, 2, sk, h_k, d)
    out_j, lse_j, s_j = jax_flash_attn_func(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        return_attn_probs=True)
    out_t, lse_t, s_t = flash_attn_func(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, return_attn_probs=True)
    assert out_t.shape == (2, sq, h, d)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    # S_dmask: the probabilities normalised by each side's own lse
    assert s_t.shape == (2, h, sq, sk) and s_t.dtype == torch.float32
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_s_dmask_with_a_scale_matches_jax(causal):
    """return_attn_probs' S_dmask with GQA, sq < sk and a softmax_scale
    against JAX's; the dense varlen route returns None for it, as JAX's
    does."""
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 24, 4, 64), _rand(rng, 2, 40, 2, 64), \
        _rand(rng, 2, 40, 2, 64)
    _, _, s_j = jax_flash_attn_func(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), softmax_scale=0.3,
        causal=causal, return_attn_probs=True)
    _, _, s_t = flash_attn_func(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        softmax_scale=0.3, causal=causal, return_attn_probs=True)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)
    cu = torch.tensor([0, 24, 48], dtype=torch.int32)
    cu_k = torch.tensor([0, 40, 80], dtype=torch.int32)
    *_, none = flash_attn_varlen_func(
        torch.from_numpy(q).flatten(0, 1), torch.from_numpy(k).flatten(0, 1),
        torch.from_numpy(v).flatten(0, 1), cu, cu_k, 24, 40,
        causal=causal, return_attn_probs=True)
    assert none is None


@pytest.mark.parametrize("causal", [False, True])
def test_attention_ref_matches_jax(causal):
    from flash_attn_tpu.utils.testing import attention_ref as jax_attention_ref

    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 3, 20, 4, 32), _rand(rng, 3, 28, 2, 32), \
        _rand(rng, 3, 28, 2, 32)
    keep = np.arange(28)[None] < np.array([[28], [9], [0]])
    out_j, attn_j = jax_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_padding_mask=jnp.asarray(keep), causal=causal)
    out_t, attn_t = attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_padding_mask=torch.from_numpy(keep), causal=causal)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j), **TOL)


def test_flash_attn_func_bf16_two_times_rule():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(_rand(rng, 2, 96, 4, 64)) for _ in range(3))
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    out = flash_attn_func(qb, kb, vb, causal=True)
    assert out.dtype == torch.bfloat16
    ref, _ = attention_ref(qb, kb, vb, causal=True)
    ref_lp, _ = attention_ref(qb, kb, vb, causal=True, upcast=False)
    check_against_ref(out, ref, ref_lp, msg="bf16 causal")


@pytest.mark.parametrize("s_new,num_splits", [(1, 1), (1, 2), (1, 3), (2, 2)])
def test_flash_attn_with_kvcache_matches_jax(s_new, num_splits):
    rng = np.random.default_rng(2)
    b, h, h_k, d, s_max = 4, 4, 2, 64, 256
    q = _rand(rng, b, s_new, h, d)
    k_new, v_new = _rand(rng, b, s_new, h_k, d), _rand(rng, b, s_new, h_k, d)
    k_cache, v_cache = _rand(rng, b, h_k, s_max, d), _rand(rng, b, h_k, s_max, d)
    seqlens = np.array([0, 17, 130, s_max - s_new], np.int32)
    t = np.arange(s_max, dtype=np.float32)[:, None]
    inv = 1.0 / 10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d)
    cos, sin = np.cos(t * inv), np.sin(t * inv)

    out_j, kc_j, vc_j = jax_flash_attn_with_kvcache(
        jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
        k=jnp.asarray(k_new), v=jnp.asarray(v_new),
        rotary_cos=jnp.asarray(cos), rotary_sin=jnp.asarray(sin),
        cache_seqlens=jnp.asarray(seqlens), causal=True,
        num_splits=num_splits)
    kc_t, vc_t = torch.from_numpy(k_cache), torch.from_numpy(v_cache)
    ptr = kc_t.data_ptr()
    out_t = flash_attn_with_kvcache(
        torch.from_numpy(q), kc_t, vc_t, k=torch.from_numpy(k_new),
        v=torch.from_numpy(v_new), rotary_cos=torch.from_numpy(cos),
        rotary_sin=torch.from_numpy(sin),
        cache_seqlens=torch.from_numpy(seqlens), causal=True,
        num_splits=num_splits)
    assert kc_t.data_ptr() == ptr  # updated in place
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j), **TOL)
    np.testing.assert_allclose(vc_t.numpy(), np.asarray(vc_j), **TOL)


def test_public_surface_holds_jax_s():
    """The port exports what flash_attn_tpu exports, less
    flash_attn_sparse_mla_func (ROADMAP.md queue A, item 7);
    flash_attn_combine is JAX's combine_splits, empty splits included; and
    flash_attn_with_kvcache takes JAX's pack_gqa as the no-op it is
    there."""
    import flash_attn_tpu
    import flash_attn_tpu_torch

    want = set(flash_attn_tpu.__all__) - {"flash_attn_sparse_mla_func"}
    assert want <= set(flash_attn_tpu_torch.__all__)
    assert all(callable(getattr(flash_attn_tpu_torch, n)) for n in want)

    rng = np.random.default_rng(5)
    out_p = _rand(rng, 4, 2, 3, 8)
    lse_p = _rand(rng, 4, 2, 3) * 3
    lse_p[2] = -np.inf             # an empty split
    lse_p[:, 0, 1] = -np.inf       # rows with every split empty
    out_j, lse_j = flash_attn_tpu.flash_attn_combine(jnp.asarray(out_p),
                                                     jnp.asarray(lse_p))
    out_t, lse_t = flash_attn_tpu_torch.flash_attn_combine(
        torch.from_numpy(out_p), torch.from_numpy(lse_p))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)

    q = torch.from_numpy(_rand(rng, 2, 1, 4, 64))
    kc, vc = (torch.from_numpy(_rand(rng, 2, 2, 128, 64)) for _ in range(2))
    base = flash_attn_with_kvcache(q, kc, vc, cache_seqlens=9)
    for pack_gqa in (True, False):
        assert torch.equal(flash_attn_with_kvcache(
            q, kc, vc, cache_seqlens=9, pack_gqa=pack_gqa), base)


def test_combine_splits_matches_jax():
    rng = np.random.default_rng(3)
    out_p = _rand(rng, 3, 2, 4, 5, 16)
    lse_p = _rand(rng, 3, 2, 4, 5) * 4
    lse_p[1, 0] = -np.inf          # one empty split
    lse_p[:, 1, 2] = -np.inf       # every split empty for some rows
    out_j, lse_j = jax_combine_splits(jnp.asarray(out_p), jnp.asarray(lse_p))
    out_t, lse_t = combine_splits(torch.from_numpy(out_p),
                                  torch.from_numpy(lse_p))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    assert (out_t[1, 2] == 0).all()
