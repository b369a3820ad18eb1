"""The port's block-sparse attention (flash_attn_tpu_torch.kernels.
flash_blocksparse, B10) against the JAX module on the same numpy inputs,
on the CPU in fp32: the port runs its plain versions, JAX its Pallas
kernels in interpret mode, as tests/test_blocksparse.py runs them. The
tolerances are that test's own: 2e-5 for out and lse (the two differ in
summation order only), 2e-4 for gradients."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels import flash_blocksparse as jbs
from flash_attn_tpu_torch.kernels import flash_blocksparse as bs
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd_plain

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mask(rng, nq, nk, density=0.5, first=True):
    m = rng.random((nq, nk)) < density
    if first:
        m[:, 0] = True  # no empty rows
    return m


def _indices(mask):
    """The (kv_num, kv_indices) of JAX's conversion, as numpy."""
    num, idx = jbs.blockmask_to_kv_indices(jnp.asarray(mask))
    return np.array(num), np.array(idx)


def _assert_lse(lse_t, lse_j):
    lse_t, lse_j = lse_t.numpy(), np.asarray(lse_j)
    np.testing.assert_array_equal(np.isneginf(lse_t), np.isneginf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], **TOL)


def _fwd_both(q, k, v, num, idx, **kw):
    out_j, lse_j = jbs.flash_attention_blocksparse_fwd(
        *map(jnp.asarray, (q, k, v, num, idx)), interpret=True, **kw)
    out_t, lse_t = bs.flash_attention_blocksparse_fwd(
        *map(torch.from_numpy, (q, k, v, num, idx)), **kw)
    return (out_t, lse_t), (out_j, lse_j)


def _grads_both(q, k, v, g, num, idx, scale=None, causal=False, bq=128,
                bk=128):
    """Gradients of sum(out * g): jax.grad of JAX's custom_vjp and the
    port's autograd Function."""
    def loss(q_, k_, v_):
        out = jbs.flash_attention_blocksparse(
            q_, k_, v_, jnp.asarray(num), jnp.asarray(idx), scale, causal,
            bq, bk, True)
        return (out * jnp.asarray(g)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = bs.flash_attention_blocksparse(
        *leaves, torch.from_numpy(num), torch.from_numpy(idx), scale, causal,
        bq, bk)
    (out * torch.from_numpy(g)).sum().backward()
    return [x.grad for x in leaves], want


def test_blockmask_to_kv_indices_is_bit_exact():
    """Listed tiles first, ascending, as JAX's stable argsort; a batch of
    masks converts row by row."""
    rng = np.random.default_rng(0)
    masks = [_mask(rng, 5, 7, d, first=False) for d in (0.0, 0.3, 0.7, 1.0)]
    for m in masks:
        num, idx = bs.blockmask_to_kv_indices(torch.from_numpy(m))
        jnum, jidx = _indices(m)
        assert num.dtype == idx.dtype == torch.int32
        np.testing.assert_array_equal(num.numpy(), jnum)
        np.testing.assert_array_equal(idx.numpy(), jidx)
    num, idx = bs.blockmask_to_kv_indices(torch.from_numpy(np.stack(masks)))
    for i, m in enumerate(masks):
        np.testing.assert_array_equal(idx[i].numpy(), _indices(m)[1])


@pytest.mark.parametrize("sq,sk,block_q,block_k,want", [
    (512, 512, 128, 128, (128, 128)),
    (384, 384, 512, 512, (512, 128)),   # the halving case: 384 % 256 != 0
    (300, 640, 512, 512, (512, 128)),   # bq: next_pow2(300) = 512
    (100, 768, 64, 512, (64, 256)),
    (40, 512, 512, 512, (64, 512)),
    (256, 100, 128, 128, None),         # 100 % 128: JAX asserts
])
def test_effective_tiles_follow_jax(sq, sk, block_q, block_k, want):
    """The one helper behind the plain version and the kernels' wrappers:
    the tiles the lists are read in, by JAX's rule (:179-183)."""
    if want is None:
        with pytest.raises(ValueError, match="not a multiple"):
            bs.effective_tiles(sq, sk, block_q, block_k)
    else:
        assert bs.effective_tiles(sq, sk, block_q, block_k) == want


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(causal, full):
    """tests/test_blocksparse.py's case (h=2, s=512, d=64, tiles of 128) on
    a random mask and on the full mask, where it is dense attention."""
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, 2, 512, 64) for _ in range(3))
    mask = np.ones((4, 4), bool) if full else _mask(rng, 4, 4, 0.6)
    num, idx = _indices(mask)
    (out_t, lse_t), (out_j, lse_j) = _fwd_both(
        q, k, v, num, idx, causal=causal, block_q=128, block_k=128)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    if full:
        dense, dense_lse = flash_attention_fwd_plain(
            *(torch.from_numpy(x)[None] for x in (q, k, v)), causal=causal)
        torch.testing.assert_close(out_t, dense[0], **TOL)
        torch.testing.assert_close(lse_t, dense_lse[0], **TOL)


@pytest.mark.parametrize("name,sq,sk,block_q,block_k,causal", [
    ("sq != sk, causal shift", 256, 512, 128, 128, True),
    ("sq not a power of two", 320, 384, 128, 128, True),
    ("block_k halving (512 -> 128)", 256, 384, 512, 512, False),
])
def test_shapes_match_jax(name, sq, sk, block_q, block_k, causal):
    rng = np.random.default_rng(2)
    q = _rand(rng, 2, sq, 64)
    k, v = _rand(rng, 2, sk, 64), _rand(rng, 2, sk, 64)
    bq, bk = bs.effective_tiles(sq, sk, block_q, block_k)
    num, idx = _indices(_mask(rng, -(-sq // bq), sk // bk))
    (out_t, lse_t), (out_j, lse_j) = _fwd_both(
        q, k, v, num, idx, causal=causal, block_q=block_q, block_k=block_k,
        softmax_scale=0.1)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)


def test_empty_row_gives_zeros_and_no_gradient():
    """A q tile with an empty list, and one whose only listed tile lies
    above the causal diagonal: out 0, lse -inf, gradients exactly 0 and no
    NaN anywhere, as JAX gives."""
    rng = np.random.default_rng(3)
    q, k, v, g = (_rand(rng, 2, 256, 64) for _ in range(4))
    mask = np.zeros((2, 2), bool)
    mask[1, 0] = True
    num, idx = _indices(mask)
    (out_t, lse_t), (out_j, lse_j) = _fwd_both(q, k, v, num, idx,
                                               block_q=128, block_k=128)
    assert not out_t[:, :128].any() and bool(lse_t[:, :128].isneginf().all())
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    got, want = _grads_both(q, k, v, g, num, idx)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)
    assert not got[0][:, :128].any()

    above = np.zeros((2, 2), bool)
    above[0, 1] = above[1, 0] = True  # q tile 0 lists only keys it cannot see
    num, idx = _indices(above)
    got, want = _grads_both(q, k, v, g, num, idx, causal=True)
    for t, j in zip(got, want):
        assert bool(torch.isfinite(t).all())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)
    assert not got[0][:, :128].any()
    out_t, lse_t = bs.flash_attention_blocksparse_fwd(
        *map(torch.from_numpy, (q, k, v, num, idx)), causal=True,
        block_q=128, block_k=128)
    assert not out_t[:, :128].any() and bool(lse_t[:, :128].isneginf().all())


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_grad(causal):
    """Autograd through the port's Function against jax.grad of JAX's
    custom_vjp (tests/test_blocksparse.py's backward case), with a listed
    tile that appears twice in its row, which both count twice."""
    rng = np.random.default_rng(4)
    q, k, v, g = (_rand(rng, 2, 512, 64) for _ in range(4))
    num, idx = _indices(_mask(rng, 4, 4))
    num[2] = min(num[2] + 1, 4)
    idx[2, num[2] - 1] = idx[2, 0]  # q tile 2 lists its first tile twice
    got, want = _grads_both(q, k, v, g, num, idx, causal=causal)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)


def test_backward_function_matches_jax_and_refuses_what_jax_asserts():
    """flash_attention_blocksparse_bwd's fp32 (dq, dk, dv) at another scale
    and the default tiles, against JAX's; and the ValueError where JAX
    asserts a 128-multiple seqlen_k."""
    rng = np.random.default_rng(5)
    q, k, v, do = (_rand(rng, 2, 256, 64) for _ in range(4))
    num, idx = _indices(_mask(rng, 1, 2))  # block_k 512 -> 256 keys a tile
    kw = dict(softmax_scale=0.2, causal=True)
    out_j, lse_j = jbs.flash_attention_blocksparse_fwd(
        *map(jnp.asarray, (q, k, v, num, idx)), interpret=True, **kw)
    want = jbs.flash_attention_blocksparse_bwd(
        jnp.asarray(do), *map(jnp.asarray, (q, k, v)), out_j, lse_j,
        jnp.asarray(num), jnp.asarray(idx), interpret=True, **kw)
    got = bs.flash_attention_blocksparse_bwd(
        *map(torch.from_numpy, (do, q, k, v)),
        torch.from_numpy(np.array(out_j)), torch.from_numpy(np.array(lse_j)),
        *map(torch.from_numpy, (num, idx)), **kw)
    for t, j in zip(got, want):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)
    k96 = torch.zeros(2, 192, 64)
    with pytest.raises(ValueError, match="seqlen_k % 128"):
        bs.flash_attention_blocksparse_bwd(
            torch.zeros(2, 64, 64), torch.zeros(2, 64, 64), k96, k96,
            torch.zeros(2, 64, 64), torch.zeros(2, 64),
            torch.ones(1, dtype=torch.int32),
            torch.zeros(1, 3, dtype=torch.int32), block_q=64, block_k=64)


@pytest.mark.parametrize("per_entry", [False, True])
def test_batched_form_matches_jax_vmap(per_entry):
    """A leading batch dim against jax.vmap of the JAX function: one mask
    for every entry (in_axes None) or one per entry."""
    rng = np.random.default_rng(6)
    b = 2
    q, k, v = (_rand(rng, b, 2, 256, 64) for _ in range(3))
    masks = [_mask(rng, 2, 2) for _ in range(b)] if per_entry \
        else [_mask(rng, 2, 2)]
    pairs = [_indices(m) for m in masks]
    num = np.stack([p[0] for p in pairs]) if per_entry else pairs[0][0]
    idx = np.stack([p[1] for p in pairs]) if per_entry else pairs[0][1]
    axis = 0 if per_entry else None

    def one(q_, k_, v_, n_, i_):
        return jbs.flash_attention_blocksparse_fwd(
            q_, k_, v_, n_, i_, causal=True, block_q=128, block_k=128,
            interpret=True)

    out_j, lse_j = jax.vmap(one, in_axes=(0, 0, 0, axis, axis))(
        *map(jnp.asarray, (q, k, v, num, idx)))
    out_t, lse_t = bs.flash_attention_blocksparse_fwd(
        *map(torch.from_numpy, (q, k, v, num, idx)), causal=True,
        block_q=128, block_k=128)
    assert out_t.shape == (b, 2, 256, 64) and lse_t.shape == (b, 2, 256)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)


def test_inverse_lists_list_each_q_tile_as_often_as_it_lists_the_key():
    """The dK/dV kernel's walk (built with torch ops): for each key tile,
    the q tiles that list it, ascending and with multiplicity; entries past
    kv_num and indices out of range left out."""
    rng = np.random.default_rng(7)
    b, nq, nk, nl = 3, 5, 6, 4
    num = rng.integers(0, nl + 1, (b, nq)).astype(np.int32)
    idx = rng.integers(-1, nk + 1, (b, nq, nl)).astype(np.int32)
    q_num, q_idx = bs.kv_to_q_lists(torch.from_numpy(num),
                                    torch.from_numpy(idx), nk)
    for bb in range(b):
        for j in range(nk):
            want = [i for i in range(nq) for t in range(num[bb, i])
                    if idx[bb, i, t] == j]
            assert q_num[bb, j] == len(want)
            assert q_idx[bb, j, :len(want)].tolist() == want


def test_low_precision_reference_is_close():
    """upcast=False (the 2x rule's low-precision reference) computes in
    the inputs' type, near the fp32 result; the default scale is
    1/sqrt(d)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(_rand(rng, 2, 128, 64)) for _ in range(3))
    num, idx = bs.blockmask_to_kv_indices(torch.ones(2, 2, dtype=torch.bool))
    ref, _ = bs.flash_attention_blocksparse_fwd_plain(
        q, k, v, num, idx, causal=True, block_q=64, block_k=64)
    lp, _ = bs.flash_attention_blocksparse_fwd_plain(
        *(x.bfloat16() for x in (q, k, v)), num, idx, causal=True,
        block_q=64, block_k=64, upcast=False)
    same, _ = bs.flash_attention_blocksparse_fwd_plain(
        q, k, v, num, idx, softmax_scale=1 / math.sqrt(64), causal=True,
        block_q=64, block_k=64)
    assert lp.dtype == torch.bfloat16
    assert 0 < (lp.float() - ref).abs().max() < 0.05
    assert torch.equal(same, ref)
