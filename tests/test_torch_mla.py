"""The port's absorbed-MLA serving path (flash_attn_tpu_torch) against the
JAX package on the same numpy inputs, in fp32 on the CPU: the paged chunked
prefill with the second query ``qv`` (B8p,
``flash_attention_paged_prefill``), ``flash_attn_varlen_func(block_table=,
qv=)`` against both of JAX's routes, ``flash_attn_with_kvcache(qv=)`` over a
linear and a paged cache with appended K and V of different widths, and
DeepSeek's 576/512 latent cache (V a view of K's first 512 columns). The
port runs its kernels' plain versions, JAX its Pallas kernels in interpret
mode. The kernels themselves are checked against their plain versions on
the card, in tests/test_torch_package.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.cache.kvcache import (
    flash_attn_with_kvcache as jax_flash_attn_with_kvcache,
)
from flash_attn_tpu.cache.kvcache import kv_cache_update as jax_kv_cache_update
from flash_attn_tpu.interface import flash_attn_varlen_func as jax_varlen_func
from flash_attn_tpu.kernels.flash_paged_prefill import (
    flash_attention_paged_prefill as jax_paged_prefill,
)
from flash_attn_tpu_torch import (
    flash_attn_func,
    flash_attn_varlen_func,
    flash_attn_with_kvcache,
)
from flash_attn_tpu_torch.cache.kvcache import kv_cache_update
from flash_attn_tpu_torch.kernels.flash_paged_prefill import (
    flash_attention_paged_prefill,
)
from flash_attn_tpu_torch.utils.testing import attention_varlen_paged_ref

from jax_paged_refs import jax_varlen_paged, one_page_tiles

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_paged_kernels_at_one_page_tiles():
    """JAX's paged kernels run at a KV tile of one page wherever its package
    calls them (tests/jax_paged_refs.py): the same functions, lowered
    faster."""
    with one_page_tiles():
        yield

# fp32 on both sides: the two differ only in summation order (and JAX
# rounds q * scale * log2(e) once before its product).
TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _assert_lse(lse_t, lse_j):
    lse_t, lse_j = lse_t.numpy(), np.asarray(lse_j)
    np.testing.assert_array_equal(np.isneginf(lse_t), np.isneginf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], **TOL)


PREFILL_CASES = {
    # causal, one KV head (MLA's MQA), ragged chunks with an empty one,
    # pages of 16, the default scale 1/sqrt(d + dv)
    "causal_mqa_page16": dict(h=4, h_k=1, page=16, seqused=[5, 0, 17],
                              lens_k=[20, 9, 40], sq_max=17, causal=True,
                              scale=None,
                              table=[[3, 0, 0], [7, 1, 0], [2, 9, 11]]),
    # not causal, GQA 8/2, pages of 64, an explicit scale
    "noncausal_gqa_page64": dict(h=8, h_k=2, page=64, seqused=[8, 3],
                                 lens_k=[70, 100], sq_max=8, causal=False,
                                 scale=0.1, table=[[2, 1], [4, 3]]),
}


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_paged_prefill_matches_jax(case):
    """out and lse of B8p; rows at or past seqused_q give zeros and -inf."""
    c = PREFILL_CASES[case]
    rng = np.random.default_rng(0)
    d, dv = 64, 128
    b = len(c["seqused"])
    table = np.array(c["table"], np.int32)
    n_pages = int(table.max()) + 1
    q = _rand(rng, b, c["sq_max"], c["h"], d)
    qv = _rand(rng, b, c["sq_max"], c["h"], dv)
    kp = _rand(rng, n_pages, c["h_k"], c["page"], d)
    vp = _rand(rng, n_pages, c["h_k"], c["page"], dv)
    used = np.array(c["seqused"], np.int32)
    lens_k = np.array(c["lens_k"], np.int32)
    out_j, lse_j = jax_paged_prefill(
        _j(q), _j(kp), _j(vp), _j(used), _j(lens_k), _j(table), qv=_j(qv),
        softmax_scale=c["scale"], causal=c["causal"], interpret=True)
    out_t, lse_t = flash_attention_paged_prefill(
        _t(q), _t(kp), _t(vp), _t(used), _t(lens_k), _t(table), qv=_t(qv),
        softmax_scale=c["scale"], causal=c["causal"])
    assert out_t.shape == (b, c["sq_max"], c["h"], dv)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    for i, n in enumerate(c["seqused"]):
        assert not out_t[i, n:].any() and bool(torch.isneginf(lse_t[i, :, n:]).all())


@pytest.mark.parametrize("d", [64, 128])
def test_varlen_paged_qv_matches_both_jax_routes(d):
    """flash_attn_varlen_func(block_table=, qv=): JAX runs B8p at d = 64
    (not a multiple of 128) and B8 over the concatenation q || qv at
    d = dv = 128; the port runs B8p for both. The d = 128 case passes
    seqused_q, which JAX's B8 route honours (its B8p route drops it, a
    fault of the reference)."""
    rng = np.random.default_rng(1)
    dv, h, h_k, page = 128, 4, 1, 16
    lens_q = [6, 11, 1]
    used = None if d == 64 else np.array([6, 4, 1], np.int32)
    lens_k = np.array([30, 11, 47], np.int32)
    table = np.array([[3, 5, 0], [7, 1, 0], [2, 9, 8]], np.int32)
    cu = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    q = _rand(rng, int(cu[-1]), h, d)
    qv = _rand(rng, int(cu[-1]), h, dv)
    kp, vp = _rand(rng, 10, h_k, page, d), _rand(rng, 10, h_k, page, dv)
    if d % 128 == 0:  # JAX's B8 route, over q || qv
        out_j, lse_j = jax_varlen_paged(
            _j(q), _j(kp), _j(vp), _j(cu), max(lens_q), _j(lens_k),
            _j(table), seqused_q=_j(used), qv=_j(qv), causal=True)
    else:
        out_j, lse_j = jax_varlen_func(
            _j(q), _j(kp), _j(vp), _j(cu), None, max(lens_q), 48,
            causal=True, block_table=_j(table), seqused_k=_j(lens_k),
            seqused_q=_j(used), qv=_j(qv), return_attn_probs=True)
    out_t, lse_t = flash_attn_varlen_func(
        _t(q), _t(kp), _t(vp), _t(cu), None, max(lens_q), 48, causal=True,
        block_table=_t(table), seqused_k=_t(lens_k),
        seqused_q=None if used is None else _t(used), qv=_t(qv),
        return_attn_probs=True)
    assert out_t.shape == (int(cu[-1]), h, dv)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    if used is None:
        # JAX's B8p route ignores seqused_q; the port honours it, as JAX's
        # B8 route does: held against the reference instead
        used = np.array([2, 11, 0], np.int32)
        out_t = flash_attn_varlen_func(
            _t(q), _t(kp), _t(vp), _t(cu), None, max(lens_q), 48,
            causal=True, block_table=_t(table), seqused_k=_t(lens_k),
            seqused_q=_t(used), qv=_t(qv))
        ref = attention_varlen_paged_ref(
            _t(q), _t(kp), _t(vp), _t(cu), _t(lens_k), _t(table),
            seqused_q=_t(used), causal=True, qv=_t(qv))
        np.testing.assert_allclose(out_t.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_kvcache_qv_with_append_matches_jax(paged):
    """flash_attn_with_kvcache(k=, v=, qv=) with k 64 and v 128 wide, at the
    default scale 1/sqrt(d + dv), one and three splits: out, lse and the
    caches the appends mutate in place against those JAX returns."""
    rng = np.random.default_rng(2)
    b, h, h_k, d, dv = 3, 4, 1, 64, 128
    q, qv = _rand(rng, b, 1, h, d), _rand(rng, b, 1, h, dv)
    k_new, v_new = _rand(rng, b, 1, h_k, d), _rand(rng, b, 1, h_k, dv)
    seqlens = np.array([5, 30, 47], np.int32)  # before the append
    if paged:
        table = _j(np.array([[3, 0, 0, 0], [7, 1, 0, 0], [2, 9, 11, 0]],
                            np.int32))
        kc, vc = _rand(rng, 12, h_k, 16, d), _rand(rng, 12, h_k, 16, dv)
    else:
        table = None
        kc, vc = _rand(rng, b, h_k, 64, d), _rand(rng, b, h_k, 64, dv)
    for splits in (1, 3):
        out_j, kc_j, vc_j, lse_j = jax_flash_attn_with_kvcache(
            _j(q), _j(kc), _j(vc), k=_j(k_new), v=_j(v_new), qv=_j(qv),
            cache_seqlens=_j(seqlens), block_table=table, causal=True,
            num_splits=splits, return_softmax_lse=True)
        kc_t, vc_t = _t(kc), _t(vc)
        ptrs = kc_t.data_ptr(), vc_t.data_ptr()
        out_t, lse_t = flash_attn_with_kvcache(
            _t(q), kc_t, vc_t, k=_t(k_new), v=_t(v_new), qv=_t(qv),
            cache_seqlens=_t(seqlens),
            block_table=None if table is None else _t(table), causal=True,
            num_splits=splits, return_softmax_lse=True)
        assert out_t.shape == (b, 1, h, dv)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
        _assert_lse(lse_t, lse_j)
        assert (kc_t.data_ptr(), vc_t.data_ptr()) == ptrs
        np.testing.assert_array_equal(kc_t.numpy(), np.asarray(kc_j))
        np.testing.assert_array_equal(vc_t.numpy(), np.asarray(vc_j))


def test_kv_cache_update_of_different_widths_matches_jax():
    """A multi-token paged append of a 64-wide K and a 512-wide V (the
    latent) writes in place what JAX's scatter writes."""
    rng = np.random.default_rng(3)
    kp, vp = _rand(rng, 6, 1, 16, 64), _rand(rng, 6, 1, 16, 512)
    k_new, v_new = _rand(rng, 2, 9, 1, 64), _rand(rng, 2, 9, 1, 512)
    offs = np.array([3, 14], np.int32)
    table = np.array([[1, 2], [4, 5]], np.int32)
    kc_j, vc_j = jax_kv_cache_update(_j(kp), _j(vp), _j(k_new), _j(v_new),
                                     _j(offs), block_table=_j(table))
    kp_t, vp_t = _t(kp), _t(vp)
    out = kv_cache_update(kp_t, vp_t, _t(k_new), _t(v_new), _t(offs),
                          block_table=_t(table))
    assert out[0] is kp_t and out[1] is vp_t
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kc_j))
    np.testing.assert_array_equal(vp_t.numpy(), np.asarray(vc_j))


def test_latent_cache_576_512_matches_jax():
    """DeepSeek's latent cache as JAX's MLA decode test stores it: K 576
    wide, V the view of its first 512 columns, no qv, one KV head."""
    rng = np.random.default_rng(4)
    b, h, d, dv, s_max = 1, 4, 576, 512, 128
    q = _rand(rng, b, 1, h, d)
    kc = _rand(rng, b, 1, s_max, d)
    seqlens = np.array([100], np.int32)
    scale = 1.0 / math.sqrt(d)
    kc_j = jnp.asarray(kc)
    out_j, lse_j = jax_flash_attn_with_kvcache(
        _j(q), kc_j, kc_j[..., :dv], cache_seqlens=_j(seqlens), causal=True,
        softmax_scale=scale, return_softmax_lse=True)
    kc_t = _t(kc)
    out_t, lse_t = flash_attn_with_kvcache(
        _t(q), kc_t, kc_t[..., :dv], cache_seqlens=_t(seqlens), causal=True,
        softmax_scale=scale, return_softmax_lse=True)
    assert out_t.shape == (b, 1, h, dv)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)


def test_mla_refusals_name_queue_a_7():
    """qv on the dense varlen route (B6/B7 at hdim_qk != hdim_v), qv with
    descales on flash_attn_func (JAX's forward-only fp8 route; qv alone
    runs there: tests/test_torch_head_dims_192_128.py) and B8p's window,
    softcap and descales are still queue A item 7 (B8p takes the learnable
    sink: tests/test_torch_learnable_sink.py)."""
    q = torch.zeros(4, 2, 64)
    cu = torch.tensor([0, 4], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_attn_varlen_func(q, q, q, cu, cu, 4, 4, qv=q)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_attn_func(q[None], q[None], q[None], qv=q[None],
                        v_descale=torch.ones(1, 2))
    qd, kp = torch.zeros(1, 4, 2, 64), torch.zeros(3, 1, 16, 64)
    args = (qd, kp, kp, torch.tensor([4]), torch.tensor([4]),
            torch.tensor([[1]], dtype=torch.int32))
    for kw in (dict(window_size=(8, 0)), dict(softcap=5.0),
               dict(k_descale=torch.ones(1, 1)),
               dict(v_descale=torch.ones(1, 1))):
        with pytest.raises(NotImplementedError, match="queue A, item 7"):
            flash_attention_paged_prefill(*args, **kw)


DECODE_PARTIAL_FORMS = {
    # DeepSeek's latent cache: K 576 wide, V its first 512 columns, no qv,
    # over a linear cache whose s_max is not a multiple of 64
    "latent_576_512_linear": dict(d=576, dv=512, qv=False, page=0),
    # the absorbed form: a 64-wide rope key and qv against the 512-wide
    # latent, over pages of 16
    "qv_64_512_paged": dict(d=64, dv=512, qv=True, page=16),
}


@pytest.fixture(scope="module")
def mla_decode_refs():
    """Per form of DECODE_PARTIAL_FORMS, made once for the module: seeded
    inputs and JAX's flash_attention_decode over them (one split, a KV tile
    of one page over a paged cache; JAX's merged result depends on
    neither), so that every split count of the port is held to one JAX
    compile."""
    from flash_attn_tpu.kernels.flash_decode import (
        flash_attention_decode as jax_decode,
    )

    refs = {}

    def get(form):
        if form in refs:
            return refs[form]
        f = DECODE_PARTIAL_FORMS[form]
        d, dv = f["d"], f["dv"]
        rng = np.random.default_rng(len(form))
        b, sq, h, h_k = 2, 2, 4, 1
        seqlens = np.array([1, 581], np.int32)
        q = _rand(rng, b, sq, h, d)
        qv = _rand(rng, b, sq, h, dv) if f["qv"] else None
        if f["page"]:
            width = -(-600 // f["page"])
            table = rng.permutation(b * width).reshape(b, width).astype(
                np.int32)
            kc = _rand(rng, b * width, h_k, f["page"], d)
            vc = _rand(rng, b * width, h_k, f["page"], dv)
        else:
            table = None
            kc = _rand(rng, b, h_k, 600, d)
            vc = None
        scale = 1.0 / math.sqrt(d + dv if f["qv"] else d)
        kc_j = jnp.asarray(kc)
        vc_j = kc_j[..., :dv] if vc is None else jnp.asarray(vc)
        out_j, lse_j = jax_decode(
            _j(q), kc_j, vc_j, _j(seqlens), block_table=_j(table),
            qv=_j(qv), softmax_scale=scale, causal=True, num_splits=1,
            block_k=f["page"] or None, interpret=True)
        refs[form] = (q, qv, kc, vc, table, seqlens, scale, out_j, lse_j)
        return refs[form]
    return get


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("form", list(DECODE_PARTIAL_FORMS))
def test_mla_decode_partials_combine_to_jax(form, splits, mla_decode_refs):
    """The contract the MLA decode kernel keeps: the plain split partials
    (out_p (splits, b, h_k, sq * group, dv), lse_p), cut in runs of 64-key
    tiles, merged by combine_splits, equal JAX's flash_attention_decode at
    sq = 2, causal, with a row of length 1 (so that, at 3 and 8 splits,
    splits are empty: zeros and lse -inf). The inputs and JAX's result are
    the module's (mla_decode_refs), one per form."""
    from flash_attn_tpu_torch.dispatch.config import DECODE_BLOCK_K
    from flash_attn_tpu_torch.kernels import flash_decode

    f = DECODE_PARTIAL_FORMS[form]
    dv = f["dv"]
    b, sq, h, h_k = 2, 2, 4, 1
    q, qv, kc, vc, table, seqlens, scale, out_j, lse_j = mla_decode_refs(form)
    kc_t = _t(kc)
    vc_t = kc_t[..., :dv] if vc is None else _t(vc)
    args = (_t(q), kc_t, vc_t, _t(seqlens))
    if table is None:
        out_p, lse_p = flash_decode.flash_attention_decode_partials_plain(
            *args, splits, DECODE_BLOCK_K, scale, True,
            qv=None if qv is None else _t(qv))
    else:
        out_p, lse_p = flash_decode.flash_attention_decode_paged_partials_plain(
            *args, _t(table), splits, DECODE_BLOCK_K, scale, True,
            qv=None if qv is None else _t(qv))
    assert out_p.shape == (splits, b, h_k, sq * h, dv)
    empty = torch.isneginf(lse_p)
    assert bool((out_p[empty] == 0).all())
    # the row of one key: its splits past the first hold none
    assert bool(empty[1:, 0].all())
    out, lse = flash_decode.combine_splits(out_p, lse_p)
    out = out.reshape(b, h_k, sq, h, dv).permute(0, 2, 1, 3, 4).reshape(
        b, sq, h, dv)
    lse = lse.reshape(b, h_k, sq, h).transpose(2, 3).reshape(b, h, sq)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse, lse_j)
