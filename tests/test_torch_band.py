"""The band masks (sliding window, chunked attention, sink tokens) of the
port's attention functions against the JAX package on the same numpy
inputs, on the CPU: the port runs the plain versions of its kernels (B1,
B4, B8), JAX its Pallas kernels in interpret mode.

Each function is held to JAX in fp32 (the two differ only in summation
order: atol/rtol 1e-5, and the same rows at lse -inf) and, for the dense
forward, in bf16 under the 2x rule: the port's bf16 output against JAX's
fp32 output on the same bf16-rounded inputs, within twice JAX's own bf16
output's error (plus 1e-5). Then the host's tile bounds against JAX's
``kv_band_static``, the reference masks against JAX's, a gradient through
a banded call against ``jax.grad``, and the refusals that remain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.cache.kvcache import (
    flash_attn_with_kvcache as jax_flash_attn_with_kvcache,
)
from flash_attn_tpu.dispatch.band import kv_band_static as jax_kv_band_static
from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu.kernels.flash_fwd import (
    flash_attention_fwd as jax_flash_attention_fwd,
)
from flash_attn_tpu.utils import testing as jax_testing
from flash_attn_tpu_torch import (
    flash_attn_func,
    flash_attn_varlen_func,
    flash_attn_with_kvcache,
)
from flash_attn_tpu_torch.dispatch.band import kv_band_static
from flash_attn_tpu_torch.kernels.flash_decode import (
    band_first_tile,
    combine_splits,
    flash_attention_decode_partials,
)
from flash_attn_tpu_torch.utils import testing
from flash_attn_tpu_torch.utils.testing import check_against_ref

from jax_paged_refs import jax_kvcache_paged, jax_varlen_paged

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 16
# Three sequences over 12 pages of 16 with 6 table columns (96 positions);
# unused columns point at the null page 0.
TABLE = np.array([[3, 0, 0, 0, 0, 0], [7, 1, 4, 0, 0, 0],
                  [2, 9, 11, 5, 6, 10]], np.int32)

# (name, sq, sk, causal, window, attention_chunk, sink_token_length): every
# form the dense forward takes, with rows that see no key (sq > sk)
FWD_BAND_CASES = [
    ("causal window", 70, 70, True, (5, 0), 0, 0),
    ("causal window, sq < sk", 37, 70, True, (31, 0), 0, 0),
    ("causal window, sq > sk", 70, 37, True, (7, 0), 0, 0),
    ("window both ways, sq > sk", 70, 37, False, (8, 8), 0, 0),
    ("left window only", 50, 50, False, (10, -1), 0, 0),
    ("right window only", 40, 50, False, (-1, 6), 0, 0),
    ("chunk, causal", 70, 70, True, (-1, -1), 16, 0),
    ("chunk, sq > sk", 50, 30, False, (-1, -1), 16, 0),
    ("sinks under a causal window", 70, 70, True, (12, 0), 0, 4),
]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(*arrays):
    ts = [torch.from_numpy(a).bfloat16() for a in arrays]
    return ts, [t.float().numpy() for t in ts]


def _assert_lse(lse_t, lse_j):
    lse_t, lse_j = lse_t.numpy(), np.asarray(lse_j)
    np.testing.assert_array_equal(np.isneginf(lse_t), np.isneginf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], **TOL)


@pytest.mark.parametrize("case", FWD_BAND_CASES, ids=lambda c: c[0])
def test_flash_attn_func_band_matches_jax(case):
    _, sq, sk, causal, window, chunk, sink = case
    rng = np.random.default_rng(sq * sk + chunk)
    q, k, v = _rand(rng, 2, sq, 4, 64), _rand(rng, 2, sk, 2, 64), \
        _rand(rng, 2, sk, 2, 64)
    band = dict(causal=causal, window_size=window, attention_chunk=chunk,
                sink_token_length=sink)
    # JAX's kernel for out and lse (its S_dmask rebuild needs a right
    # extent, and flash_attn_func returns lse only beside it)
    out_j, lse_j = jax_flash_attention_fwd(
        *(jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)), **band,
        interpret=True)
    out_t, lse_t, p_t = flash_attn_func(_t(q), _t(k), _t(v), **band,
                                        return_attn_probs=True)
    np.testing.assert_allclose(out_t.numpy(),
                               np.asarray(jnp.swapaxes(out_j, 1, 2)), **TOL)
    _assert_lse(lse_t, lse_j)
    if causal or window[1] >= 0:
        _, _, p_j = jax_flash_attn_func(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **band,
            return_attn_probs=True)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **TOL)

    (qb, kb, vb), f32 = _bf16(q, k, v)
    ref = jax_flash_attn_func(*map(jnp.asarray, f32), **band)
    ref_lp = jax_flash_attn_func(
        *(jnp.asarray(x, jnp.bfloat16) for x in f32), **band)
    check_against_ref(flash_attn_func(qb, kb, vb, **band), ref,
                      np.asarray(ref_lp, np.float32), msg=case[0])


@pytest.mark.parametrize(
    "case", [c for c in FWD_BAND_CASES if c[3] or c[4][1] >= 0 or c[4][0] < 0],
    ids=lambda c: c[0])
def test_attention_ref_band_matches_jax(case):
    """The port's oracle (attention_ref with construct_local_mask and
    construct_chunk_mask) against JAX's, where JAX's takes the window (its
    local mask needs a right extent: causal, or both given)."""
    _, sq, sk, causal, window, chunk, sink = case
    window = tuple(None if x < 0 else x for x in window)
    rng = np.random.default_rng(sq + sk)
    q, k, v = _rand(rng, 2, sq, 4, 32), _rand(rng, 2, sk, 2, 32), \
        _rand(rng, 2, sk, 2, 32)
    band = dict(causal=causal, window_size=window, attention_chunk=chunk,
                sink_token_length=sink)
    out_j, attn_j = jax_testing.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **band)
    out_t, attn_t = testing.attention_ref(_t(q), _t(k), _t(v), **band)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j), **TOL)
    if window != (None, None) and window[1] is not None or causal:
        ws = (window[0], 0) if causal else window
        np.testing.assert_array_equal(
            testing.construct_local_mask(sq, sk, ws, sink).numpy(),
            np.asarray(jax_testing.construct_local_mask(sq, sk, ws, sink)))
    if chunk:
        np.testing.assert_array_equal(
            testing.construct_chunk_mask(sq, sk, chunk).numpy(),
            np.asarray(jax_testing.construct_chunk_mask(sq, sk, chunk)))


# (name, sq, causal, window, attention_chunk, num_splits)
DECODE_BAND_CASES = [
    ("window, sq=1", 1, True, (20, 0), 0, 3),
    ("window, sq=5", 5, True, (20, 0), 0, 3),
    ("chunk, sq=1", 1, True, (-1, -1), 16, 3),
    ("chunk, sq=5", 5, True, (-1, -1), 16, 2),
    ("window both ways, sq=5", 5, False, (9, 2), 0, 4),
]


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("case", DECODE_BAND_CASES, ids=lambda c: c[0])
def test_flash_attn_with_kvcache_band_matches_jax(case, paged):
    """Decode with an append (GQA 4/2) under the band over a linear and a
    paged cache: the output, the lse and the mutated caches. The lengths
    put the band's first key inside a tile, at a tile's start and past
    the first split's tiles."""
    _, sq, causal, window, chunk, splits = case
    rng = np.random.default_rng(sq + chunk + 7 * paged)
    b, h, h_k, d = 3, 4, 2, 64
    q = _rand(rng, b, sq, h, d)
    k_new, v_new = _rand(rng, b, sq, h_k, d), _rand(rng, b, sq, h_k, d)
    shape = (12, h_k, PAGE, d) if paged else (b, h_k, 96, d)
    kc, vc = _rand(rng, *shape), _rand(rng, *shape)
    seqlens = np.array([3, 35, 82], np.int32)  # before the append
    table = dict(block_table=TABLE) if paged else {}
    band = dict(causal=causal, window_size=window, attention_chunk=chunk,
                num_splits=splits, return_softmax_lse=True)
    if paged:  # JAX's paged decode at a KV tile of one page
        jband = dict(band)
        del jband["num_splits"], jband["return_softmax_lse"]
        out_j, kc_j, vc_j, lse_j = jax_kvcache_paged(
            *(jnp.asarray(x) for x in (q, kc, vc)), jnp.asarray(seqlens),
            jnp.asarray(TABLE), splits, k=jnp.asarray(k_new),
            v=jnp.asarray(v_new), **jband)
    else:
        out_j, kc_j, vc_j, lse_j = jax_flash_attn_with_kvcache(
            *(jnp.asarray(x) for x in (q, kc, vc)), k=jnp.asarray(k_new),
            v=jnp.asarray(v_new), cache_seqlens=jnp.asarray(seqlens), **band)
    kc_t, vc_t = _t(kc), _t(vc)
    out_t, lse_t = flash_attn_with_kvcache(
        _t(q), kc_t, vc_t, k=_t(k_new), v=_t(v_new),
        cache_seqlens=_t(seqlens), **band,
        **{n: _t(x) for n, x in table.items()})
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j), **TOL)
    np.testing.assert_allclose(vc_t.numpy(), np.asarray(vc_j), **TOL)


def test_decode_splits_over_the_band():
    """The plain split partials share out the band's tiles only: the first
    tile is that of the lowest key the first query token sees; at every
    split count the merged result equals one split's (fp32, 1e-5); a split
    wholly below a later token's window, or past the band's tiles, carries
    lse -inf and out 0 for those rows, and combine_splits weighs it 0."""
    rng = np.random.default_rng(3)
    b, sq, h, h_k, d = 2, 5, 4, 2, 64
    group = h // h_k
    q = torch.from_numpy(_rand(rng, b, sq, h, d))
    kc = torch.from_numpy(_rand(rng, b, h_k, 320, d))
    vc = torch.from_numpy(_rand(rng, b, h_k, 320, d))
    lens = torch.tensor([300, 208], dtype=torch.int32)
    first = band_first_tile(lens.long(), sq, 13, 0, 64)
    assert first.tolist() == [(300 - 5 - 13) // 64, (208 - 5 - 13) // 64]
    one, lse_one = flash_attention_decode_partials(
        q, kc, vc, lens, 1, 0.125, True, window_size=(13, 0))
    for splits in (2, 3, 8):
        out_p, lse_p = flash_attention_decode_partials(
            q, kc, vc, lens, splits, 0.125, True, window_size=(13, 0))
        out, lse = combine_splits(out_p, lse_p)
        np.testing.assert_allclose(out.numpy(), one[0].numpy(), **TOL)
        np.testing.assert_allclose(lse.numpy(), lse_one[0].numpy(), **TOL)
        empty = torch.isneginf(lse_p)
        assert bool((out_p[empty] == 0).all())
        if splits == 2:
            # row 1: token t at position 203 + t sees 190 + t .. 203 + t;
            # split 0 is tile 2 (keys 128..191), wholly below token 4's
            # window (rows 4 * group ..) but not token 0's
            assert bool(empty[0, 1, :, 4 * group:].all())
            assert not bool(empty[0, 1, :, :group].any())
        if splits == 8:
            assert bool(empty[:, 1].any())  # splits past the band's tiles


def test_flash_attn_varlen_paged_window_matches_jax():
    """flash_attn_varlen_func(block_table=) (B8's route) with a window:
    ragged chunks, one padded by seqused_q, over cached keys, causal and
    with a window both ways; out and lse against JAX."""
    rng = np.random.default_rng(11)
    lens_q, lens_k, used = [9, 1, 30], [12, 40, 90], [9, 1, 24]
    cu = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    q = _rand(rng, int(cu[-1]), 4, 64)
    kp, vp = _rand(rng, 12, 2, PAGE, 64), _rand(rng, 12, 2, PAGE, 64)
    lens_k, used = np.array(lens_k, np.int32), np.array(used, np.int32)
    for causal, window in ((True, (10, 0)), (False, (6, 3))):
        out_j, lse_j = jax_varlen_paged(
            *(jnp.asarray(x) for x in (q, kp, vp)), jnp.asarray(cu),
            max(lens_q), jnp.asarray(lens_k), jnp.asarray(TABLE),
            seqused_q=jnp.asarray(used), causal=causal, window_size=window)
        out_t, lse_t = flash_attn_varlen_func(
            _t(q), _t(kp), _t(vp), _t(cu), None, max(lens_q), 96,
            causal=causal, window_size=window, block_table=_t(TABLE),
            seqused_k=_t(lens_k), seqused_q=_t(used), return_attn_probs=True)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
        _assert_lse(lse_t, lse_j)
        want = testing.attention_varlen_paged_ref(
            _t(q), _t(kp), _t(vp), _t(cu), _t(lens_k), _t(TABLE),
            seqused_q=_t(used), causal=causal, window_size=window)
        np.testing.assert_allclose(out_t.numpy(), want.numpy(), **TOL)


# (nq, nk, block_q, block_k, shift, causal, window_left, window_right,
# sink_token_length, attention_chunk)
KV_BAND_CASES = [
    (4, 8, 128, 64, 0, True, None, None, 0, 0),
    (4, 8, 128, 64, 0, True, 100, None, 0, 0),
    (4, 8, 128, 64, 0, False, 100, 30, 0, 0),
    (3, 5, 128, 64, -100, True, 10, None, 0, 0),
    (4, 8, 128, 64, 200, False, None, 0, 0, 0),
    (4, 8, 128, 64, 0, True, None, None, 0, 96),
    (4, 8, 128, 64, -37, False, None, None, 0, 96),
    (4, 8, 128, 64, 0, True, 100, None, 4, 0),
    (2, 16, 64, 128, 700, True, 3000, None, 0, 0),
]


@pytest.mark.parametrize("case", KV_BAND_CASES)
def test_kv_band_static_matches_jax(case):
    assert kv_band_static(*case) == jax_kv_band_static(*case)


@pytest.mark.parametrize("kwargs", [
    dict(window_size=(8, 0)), dict(attention_chunk=16),
    dict(window_size=(8, 0), sink_token_length=2)])
def test_band_with_a_gradient_raises(kwargs):
    """A gradient of a banded call (the name is kept from when it raised):
    it trains through the backward's band masks, and q's gradient of the
    self-attention call (q = k = v) matches jax.grad of JAX's
    flash_attn_func with the same band, in both deterministic modes; under
    no_grad the same call runs, and a window that reaches every key is no
    band."""
    x = _rand(np.random.default_rng(11), 1, 40, 2, 64)
    g = _rand(np.random.default_rng(12), 1, 40, 2, 64)

    def jf(q):
        return (jax_flash_attn_func(q, q, q, causal=True, **kwargs)
                * g).sum()
    want = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    for deterministic in (True, False):
        q = _t(x).requires_grad_()
        flash_attn_func(q, q, q, causal=True, deterministic=deterministic,
                        **kwargs).backward(_t(g))
        np.testing.assert_allclose(q.grad.numpy(), want, atol=1e-4, rtol=0)
    with torch.no_grad():
        assert flash_attn_func(q, q, q, causal=True,
                               **kwargs).shape == q.shape
    flash_attn_func(q, q, q, causal=True, window_size=(-1, -1)).sum() \
        .backward()


def test_varlen_band_refusals():
    """The refusals that remain on the varlen routes: the paged route
    refuses attention_chunk (which JAX's paged route drops without a word)
    and a window with qv (B8p), naming queue A item 7; neither route takes
    sink tokens, as JAX's has no such argument. The dense route and its
    packed forms take the window and the chunk (forward and backward:
    tests/test_torch_band_varlen.py)."""
    from flash_attn_tpu_torch.interface import (
        flash_attn_varlen_kvpacked_func,
        flash_attn_varlen_qkvpacked_func,
    )

    x = torch.randn(12, 2, 64)
    cu = torch.tensor([0, 5, 12], dtype=torch.int32)
    for kw in (dict(window_size=(4, 0)), dict(attention_chunk=4)):
        assert flash_attn_varlen_func(x, x, x, cu, cu, 7, 7, causal=True,
                                      **kw).shape == x.shape
    with pytest.raises(TypeError, match="sink_token_length"):
        flash_attn_varlen_func(x, x, x, cu, cu, 7, 7, causal=True,
                               window_size=(4, 0), sink_token_length=2)
    assert flash_attn_varlen_qkvpacked_func(
        torch.stack([x, x, x], 1), cu, 7, window_size=(4, 0)).shape == x.shape
    assert flash_attn_varlen_kvpacked_func(
        x, torch.stack([x, x], 1), cu, cu, 7, 7,
        window_size=(4, 0)).shape == x.shape
    pages = torch.randn(4, 2, PAGE, 64)
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    lens = torch.tensor([5, 7], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_attn_varlen_func(x, pages, pages, cu, None, 7, 32, causal=True,
                               block_table=table, seqused_k=lens,
                               attention_chunk=4)
    out = flash_attn_varlen_func(x, pages, pages, cu, None, 7, 32,
                                 causal=True, block_table=table,
                                 seqused_k=lens, window_size=(4, 0))
    assert out.shape == x.shape
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_attn_varlen_func(x, pages, pages, cu, None, 7, 32, causal=True,
                               block_table=table, seqused_k=lens, qv=x,
                               window_size=(4, 0))
