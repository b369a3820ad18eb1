"""q/k head dim 192 beside v head dim 128 (DeepSeek's MLA when it is not
absorbed: dispatch/config.py HEAD_DIM_PAIRS), and the MLA second query
``qv`` on ``flash_attn_func``, in the port against the JAX package on the
same seeded numpy inputs, on the CPU: the port runs the plain versions of
B1, B2, B3 and the preprocess (the card runs csrc/flash_fwd_192.cu and
csrc/flash_bwd_192.cu), JAX its Pallas kernels in interpret mode.

- ``flash_attn_func`` at 192 / 128: out and lse against JAX's (fp32 on
  both sides, atol/rtol 2e-5), dq, dk and dv (and the learnable sink's
  gradient) against ``jax.vjp`` (atol/rtol 1e-4: summation order), in both
  ``deterministic`` modes, causal and not, sq != sk both ways (rows that
  see no key at out 0 and lse their sink), GQA and a learnable sink.
- ``flash_attn_func(qv=)`` at (64, 128) against JAX's, whose interface
  concatenates q || qv and k || v as the port's does: out, lse, dq, dk, dv
  and dqv, and ``return_attn_probs``' S_dmask rebuilt from the
  concatenated q and k.
- the refusals: check_head_dims takes (192, 192, 128) in the set of B1,
  B2, B3 and the preprocess (DENSE_HEAD_DIMS) and in no other kernel's;
  the band and the score map at 192 / 128 raise NotImplementedError as the
  card's route resolves them (refuse_dv_forms, before any launch); a
  refused tensor argument is named by its shape and dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu_torch import flash_attn_func
from flash_attn_tpu_torch.dispatch import config
from flash_attn_tpu_torch.dispatch.band import has_band, reach_window
from flash_attn_tpu_torch.dispatch.config import (
    BLOCKSPARSE_HEAD_DIMS,
    DENSE_HEAD_DIMS,
    HEAD_DIM_PAIRS,
    HEAD_DIMS,
    check_head_dims,
    dense_bwd_tiles,
    refuse_dv_forms,
)
from flash_attn_tpu_torch.dispatch.score import has_score

torch.set_num_threads(1)

D, DV = 192, 128
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _assert_lse(lse_t, lse_j):
    lse_t, lse_j = np.asarray(lse_t), np.asarray(lse_j)
    np.testing.assert_array_equal(np.isfinite(lse_t), np.isfinite(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], **TOL)


# (name, sq, sk, h, h_k, causal, sink): GQA under causal masking with sq >
# sk (rows that see no key: out 0, lse their head's sink) and a learnable
# sink; not causal with sq < sk. Two JAX programs (each compiles its
# interpret-mode forward and backward, ~4 s here) cover every form.
FUNC_CASES = [
    ("causal, GQA 4/2, sq > sk, a learnable sink", 130, 64, 4, 2, True, True),
    ("not causal, sq < sk", 64, 130, 2, 2, False, False),
]


@pytest.mark.parametrize("case", FUNC_CASES, ids=lambda c: c[0])
def test_flash_attn_func_192_128_matches_jax(case):
    """out, lse, dq, dk, dv (and dsink) against JAX's, in both
    deterministic modes; out is (b, sq, h, 128)."""
    name, sq, sk, h, h_k, causal, with_sink = case
    rng = np.random.default_rng(sq + 7 * sk + h)
    q, k, v = (_rand(rng, 1, s, n, w) for s, n, w in
               ((sq, h, D), (sk, h_k, D), (sk, h_k, DV)))
    g = _rand(rng, 1, sq, h, DV)
    sink = (np.log(sk) + np.array([4.0, -1.0, 0.0, 1.0][:h])).astype(
        np.float32) if with_sink else None
    args = [q, k, v] + ([sink] if with_sink else [])

    def jf(*xs):
        out, lse, _ = jax_flash_attn_func(
            *xs[:3], learnable_sink=xs[3] if with_sink else None,
            causal=causal, return_attn_probs=True)
        return out, lse

    (out_j, lse_j), vjp = jax.vjp(jf, *map(jnp.asarray, args))
    grads_j = vjp((jnp.asarray(g), jnp.zeros_like(lse_j)))
    for deterministic in (True, False):
        leaves = [_t(x).requires_grad_() for x in args]
        out_t, lse_t, _ = flash_attn_func(
            *leaves[:3], learnable_sink=leaves[3] if with_sink else None,
            causal=causal, deterministic=deterministic,
            return_attn_probs=True)
        assert out_t.shape == (1, sq, h, DV)
        out_t.backward(_t(g))
        np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                                   **TOL)
        _assert_lse(lse_t.numpy(), lse_j)
        for gname, leaf, want in zip(("dq", "dk", "dv", "dsink"), leaves,
                                     grads_j):
            np.testing.assert_allclose(
                leaf.grad.numpy(), np.asarray(want), **GRAD_TOL,
                err_msg=f"{name} {gname} deterministic={deterministic}")
    if sq > sk:  # rows 0 .. sq - sk - 1 see no key
        empty = slice(0, sq - sk)
        assert not out_t.detach().numpy()[:, empty].any()
        np.testing.assert_array_equal(
            lse_t.numpy()[:, :, empty],
            np.broadcast_to(sink[None, :, None], (1, h, sq - sk)))


def test_flash_attn_func_qv_matches_jax():
    """qv at (64, 128) through JAX's concatenation identity: out, lse and
    every gradient (dqv a slice of the concatenation's, dv the P V side
    plus the score side) against jax.vjp of JAX's flash_attn_func(qv=),
    and return_attn_probs' S_dmask (out and lse of that call too); not
    causal, 64 rows over 130 keys, the shapes of the second FUNC_CASES
    case, so that JAX's kernels at 192 / 128 lower once for both."""
    rng = np.random.default_rng(64)
    b, sq, sk, h, d = 1, 64, 130, 2, 64
    q, qv, g = (_rand(rng, b, sq, h, w) for w in (d, DV, DV))
    k, v = (_rand(rng, b, sk, h, w) for w in (d, DV))

    def jf(q_, k_, v_, qv_):
        out, lse, s_dmask = jax_flash_attn_func(
            q_, k_, v_, qv=qv_, return_attn_probs=True)
        return out, lse, s_dmask

    (out_j, lse_j, s_j), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v, qv)))
    grads_j = vjp((jnp.asarray(g), jnp.zeros_like(lse_j),
                   jnp.zeros_like(s_j)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, qv)]
    out_t, lse_t, s_t = flash_attn_func(*leaves[:3], qv=leaves[3],
                                        return_attn_probs=True)
    out_t.backward(_t(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    _assert_lse(lse_t.numpy(), lse_j)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)
    for gname, leaf, want in zip(("dq", "dk", "dv", "dqv"), leaves, grads_j):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL, err_msg=gname)


def test_head_dim_pair_sets_and_refusals():
    """(192, 192, 128) is in the set of B1, B2, B3 and the preprocess alone;
    every other kernel (B4, B6, B7, B8, B10) raises for it naming queue A
    item 7, as (192, 192, 192) and every other unequal pair raise for all;
    the dense backward's tiles at 192 / 128."""
    assert HEAD_DIM_PAIRS == ((192, 128),)
    assert DENSE_HEAD_DIMS == HEAD_DIMS + HEAD_DIM_PAIRS
    for kernel in ("flash_fwd", "flash_bwd", "bwd_preprocess"):
        check_head_dims(kernel, D, D, DV, DENSE_HEAD_DIMS)
        for d in HEAD_DIMS:
            check_head_dims(kernel, d, d, d, DENSE_HEAD_DIMS)
    for kernel, dims in (("flash_decode (the d = dv route)", HEAD_DIMS),
                         ("flash_varlen_fwd", HEAD_DIMS),
                         ("flash_varlen_fwd_persistent", HEAD_DIMS),
                         ("flash_varlen_bwd", HEAD_DIMS),
                         ("flash_varlen_paged", HEAD_DIMS),
                         ("flash_blocksparse", BLOCKSPARSE_HEAD_DIMS)):
        with pytest.raises(ValueError, match="queue A, item 7"):
            check_head_dims(kernel, D, D, DV, dims)
    for d, dk, dv in ((192, 192, 192), (128, 128, 192), (192, 128, 128),
                      (256, 256, 128), (64, 64, 128)):
        with pytest.raises(ValueError, match="queue A, item 7"):
            check_head_dims("flash_fwd", d, dk, dv, DENSE_HEAD_DIMS)
    dkdv, dq = dense_bwd_tiles(D, DV)
    assert (dkdv.block_q, dkdv.block_k, dq.block_q, dq.block_k) == (
        64, 64, 128, 64)
    assert dense_bwd_tiles(128) == dense_bwd_tiles(128, 128) == \
        config.DENSE_BWD_TILES


@pytest.mark.parametrize("form", [
    dict(window_size=(100, 0)), dict(attention_chunk=64),
    dict(softcap=30.0), dict(alibi_slopes=torch.ones(2))],
    ids=["window", "chunk", "softcap", "alibi"])
def test_band_and_score_at_192_128_refused_on_the_card_route(form):
    """The card's route resolves the band as B1's and B3's wrappers do
    (reach_window, has_band) and refuses the band and the score map at
    192 / 128 before any launch, naming queue A item 7; the same forms at
    d = dv, and a window that reaches every key at 192 / 128, pass; the
    CPU computes them all."""
    sq = sk = 512
    window = reach_window(form.get("window_size", (None, None)), True, sq, sk)
    band = has_band(True, window, form.get("attention_chunk", 0))
    score = has_score(form.get("softcap", 0.0), form.get("alibi_slopes"))
    for kernel in ("flash_fwd", "flash_bwd"):
        with pytest.raises(NotImplementedError, match="queue A, item 7"):
            refuse_dv_forms(kernel, D, DV, band, score)
        refuse_dv_forms(kernel, 128, 128, band, score)
    wide = reach_window((sk, 0), True, sq, sk)
    refuse_dv_forms("flash_fwd", D, DV, has_band(True, wide, 0), False)
    q, k = torch.randn(1, 40, 2, D), torch.randn(1, 40, 2, D)
    out = flash_attn_func(q, k, torch.randn(1, 40, 2, DV), causal=True,
                          **form)
    assert out.shape == (1, 40, 2, DV) and torch.isfinite(out).all()


def test_refused_tensor_is_named_by_shape_and_dtype():
    """reject_unsupported names a tensor by its shape and dtype, not its
    values; qv with descales (JAX's forward-only fp8 route) still raises."""
    q = torch.randn(1, 8, 2, 64)
    with pytest.raises(NotImplementedError, match="queue A, item 7") as e:
        flash_attn_func(q, q, q, qv=torch.randn(1, 8, 2, 64),
                        q_descale=torch.full((1, 2), 0.8828125))
    msg = str(e.value)
    assert "shape (1, 2)" in msg and "torch.float32" in msg
    assert "tensor(" not in msg and "0.8828" not in msg
    with pytest.raises(NotImplementedError, match="dropout_p=0.1"):
        flash_attn_func(q, q, q, dropout_p=0.1)
