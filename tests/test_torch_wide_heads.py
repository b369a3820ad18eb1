"""Head dims 80 (BTLM-3B-8K), 96 (GPT-NeoX-20B) and 256 (GPT-J), which the
port's kernels take, against the JAX package on the same numpy inputs, on
the CPU: the port runs the plain versions of its kernels, JAX its Pallas
kernels in interpret mode. The backwards and the packed forwards at 80, 96
and 256 are in tests/test_torch_wide_backward.py, and ALiBi, the band, the
cap, an fp8 cache and training at 80 are in tests/test_torch_head_dim_80.py.

Each attention function is held to JAX twice: in fp32 (the two differ only
in summation order, atol/rtol 1e-5) and in bf16 under the 2x rule, the
port's bf16 output against JAX's fp32 output on the same bf16-rounded
inputs, within twice JAX's own bf16 output's error (plus 1e-5). The
models at these head dims are in tests/test_torch_wide_models.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.cache.kvcache import (
    flash_attn_with_kvcache as jax_flash_attn_with_kvcache,
)
from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu_torch import (
    flash_attn_func,
    flash_attn_varlen_func,
    flash_attn_with_kvcache,
)
from flash_attn_tpu_torch import interface
from flash_attn_tpu_torch.dispatch import config
from flash_attn_tpu_torch.dispatch.config import (
    BLOCKSPARSE_HEAD_DIMS,
    HEAD_DIMS,
    check_head_dims,
)
from flash_attn_tpu_torch.kernels import flash_bwd
from flash_attn_tpu_torch.utils.testing import check_against_ref

from jax_paged_refs import jax_kvcache_paged, jax_varlen_paged

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 16
# Three sequences over 12 pages of 16 with 4 table columns; unused columns
# point at the null page 0.
TABLE = np.array([[3, 0, 0, 0], [7, 1, 0, 0], [2, 9, 11, 0]], np.int32)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(*arrays):
    """The arrays rounded to bf16: (torch bf16 tensors, their fp32 values as
    numpy)."""
    ts = [torch.from_numpy(a).bfloat16() for a in arrays]
    return ts, [t.float().numpy() for t in ts]


def _assert_lse(lse_t, lse_j):
    lse_t, lse_j = lse_t.numpy(), np.asarray(lse_j)
    np.testing.assert_array_equal(np.isneginf(lse_t), np.isneginf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [80, 96, 256])
def test_flash_attn_func_matches_jax(d, causal):
    rng = np.random.default_rng(d)
    q, k, v = _rand(rng, 2, 37, 4, d), _rand(rng, 2, 70, 2, d), \
        _rand(rng, 2, 70, 2, d)
    out_j, lse_j, _ = jax_flash_attn_func(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        return_attn_probs=True)
    out_t, lse_t, _ = flash_attn_func(_t(q), _t(k), _t(v), causal=causal,
                                      return_attn_probs=True)
    assert out_t.shape == (2, 37, 4, d)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)

    (qb, kb, vb), f32 = _bf16(q, k, v)
    ref = jax_flash_attn_func(*map(jnp.asarray, f32), causal=causal)
    ref_lp = jax_flash_attn_func(
        *(jnp.asarray(x, jnp.bfloat16) for x in f32), causal=causal)
    check_against_ref(flash_attn_func(qb, kb, vb, causal=causal), ref,
                      np.asarray(ref_lp, np.float32),
                      msg=f"flash_attn_func d={d}")


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("d", [80, 96, 256])
def test_flash_attn_with_kvcache_matches_jax(d, paged):
    """Decode with an append (sq = 2, GQA 4/2, 2 splits) over a linear and
    a paged cache: the output and the mutated caches."""
    rng = np.random.default_rng(d + paged)
    b, h, h_k = 3, 4, 2
    q = _rand(rng, b, 2, h, d)
    k_new, v_new = _rand(rng, b, 2, h_k, d), _rand(rng, b, 2, h_k, d)
    shape = (12, h_k, PAGE, d) if paged else (b, h_k, 64, d)
    kc, vc = _rand(rng, *shape), _rand(rng, *shape)
    seqlens = np.array([5, 30, 46], np.int32)  # before the append
    table = dict(block_table=TABLE) if paged else {}

    def jax_run(dtype, q, k_new, v_new, kc, vc):
        if paged:  # JAX's paged decode at a KV tile of one page
            return jax_kvcache_paged(
                *(jnp.asarray(x, dtype) for x in (q, kc, vc)),
                jnp.asarray(seqlens), jnp.asarray(TABLE), 2,
                k=jnp.asarray(k_new, dtype), v=jnp.asarray(v_new, dtype),
                causal=True)[:3]
        return jax_flash_attn_with_kvcache(
            *(jnp.asarray(x, dtype) for x in (q, kc, vc)),
            k=jnp.asarray(k_new, dtype), v=jnp.asarray(v_new, dtype),
            cache_seqlens=jnp.asarray(seqlens), causal=True, num_splits=2)

    def port_run(q, k_new, v_new, kc, vc):
        return flash_attn_with_kvcache(
            q, kc, vc, k=k_new, v=v_new, cache_seqlens=_t(seqlens),
            causal=True, num_splits=2,
            **{n: _t(x) for n, x in table.items()})

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
                      msg=f"flash_attn_with_kvcache d={d} paged={paged}")


@pytest.mark.parametrize("d", [80, 96, 256])
def test_varlen_paged_matches_jax(d):
    """flash_attn_varlen_func(block_table=) (B8's route): ragged chunks,
    one of them padded by seqused_q, over cached keys, causal."""
    rng = np.random.default_rng(d)
    lens_q, lens_k, used = [9, 1, 20], [12, 17, 47], [9, 1, 14]
    cu = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    q = _rand(rng, int(cu[-1]), 4, d)
    kp, vp = _rand(rng, 12, 2, PAGE, d), _rand(rng, 12, 2, PAGE, d)
    lens_k, used = np.array(lens_k, np.int32), np.array(used, np.int32)

    def jax_run(dtype, q, kp, vp):
        return jax_varlen_paged(
            *(jnp.asarray(x, dtype) for x in (q, kp, vp)), jnp.asarray(cu),
            max(lens_q), jnp.asarray(lens_k), jnp.asarray(TABLE),
            seqused_q=jnp.asarray(used), causal=True)

    def port_run(q, kp, vp):
        return flash_attn_varlen_func(
            q, kp, vp, _t(cu), None, max(lens_q), 64, causal=True,
            block_table=_t(TABLE), seqused_k=_t(lens_k), seqused_q=_t(used),
            return_attn_probs=True)

    out_j, lse_j = jax_run(jnp.float32, q, kp, vp)
    out_t, lse_t = port_run(_t(q), _t(kp), _t(vp))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    bf, f32 = _bf16(q, kp, vp)
    ref, _ = jax_run(jnp.float32, *f32)
    ref_lp, _ = jax_run(jnp.bfloat16, *f32)
    check_against_ref(port_run(*bf)[0], ref, np.asarray(ref_lp, np.float32),
                      msg=f"flash_attn_varlen_func(block_table=) d={d}")


def test_head_dim_refusals_name_item_7():
    """The wrappers' checks (a kernel cannot launch here): every kernel of
    serving and of training, the forwards B1, B8 and B4, the backwards B2,
    B3 and B6, their preprocess and the packed forwards B6/B7, takes one
    set of head dims, 64, 80, 96, 128 and 256 (HEAD_DIMS), so a gradient or
    packed input at 80 is no longer refused (check_training_head_dim and
    the two sets it kept apart are gone), nor is a gradient at 96 or 256
    (check_backward_head_dim is gone too); B10 takes 64 and 128 only; 192
    and d != dv are refused everywhere, by the forward's check before
    anything runs. Each refusal names queue A item 7; the CPU runs any head
    dim. The one pair with a v head dim of its own, (192, 128), is in the
    set of B1, B2, B3 and their preprocess alone (DENSE_HEAD_DIMS), not in
    HEAD_DIMS nor B10's."""
    assert HEAD_DIMS == (64, 80, 96, 128, 256)
    assert config.HEAD_DIM_PAIRS == ((192, 128),)
    assert config.DENSE_HEAD_DIMS == HEAD_DIMS + ((192, 128),)
    check_head_dims("flash_fwd", 192, 192, 128, config.DENSE_HEAD_DIMS)
    for dims in (HEAD_DIMS, BLOCKSPARSE_HEAD_DIMS):
        with pytest.raises(ValueError, match="queue A, item 7"):
            check_head_dims("kernel", 192, 192, 128, dims)
    for d, dk, dv in ((192, 192, 192), (256, 256, 128), (128, 128, 192)):
        with pytest.raises(ValueError, match="queue A, item 7"):
            check_head_dims("flash_fwd", d, dk, dv, config.DENSE_HEAD_DIMS)
    assert BLOCKSPARSE_HEAD_DIMS == (64, 128)
    for gone in ("FWD_HEAD_DIMS", "BWD_HEAD_DIMS", "check_training_head_dim"):
        assert not hasattr(config, gone) and not hasattr(interface, gone)
    assert not hasattr(flash_bwd, "check_backward_head_dim")
    for d in (80, 96, 256):
        for kernel in ("flash_fwd", "flash_varlen_paged",
                       "flash_decode (the d = dv route)", "flash_varlen_fwd",
                       "flash_varlen_fwd_persistent", "flash_varlen_bwd",
                       "flash_bwd", "bwd_preprocess"):
            check_head_dims(kernel, d, d, d, HEAD_DIMS)
        with pytest.raises(ValueError, match="queue A, item 7"):
            check_head_dims("flash_blocksparse", d, d, d,
                            BLOCKSPARSE_HEAD_DIMS)
        q = torch.zeros(1, 8, 2, d, requires_grad=True)
        out = flash_attn_func(q, q, q, causal=True)  # the CPU takes grads
        out.sum().backward()
        assert q.grad.shape == q.shape
    for dims in (HEAD_DIMS, BLOCKSPARSE_HEAD_DIMS):
        with pytest.raises(ValueError, match="queue A, item 7"):
            check_head_dims("kernel", 192, 192, 192, dims)
        with pytest.raises(ValueError, match="queue A, item 7"):
            check_head_dims("kernel", 256, 256, 128, dims)
        with pytest.raises(ValueError, match="queue A, item 7"):
            check_head_dims("kernel", 80, 80, 64, dims)
