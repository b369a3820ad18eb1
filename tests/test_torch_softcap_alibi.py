"""softcap and ALiBi in the port's serving functions against the JAX
package on the same numpy inputs, on the CPU: the port runs the plain
versions of its kernels (B1, B4, B8), JAX its Pallas kernels in interpret
mode.

Each function is held to JAX in fp32 (the two differ only in summation
order: atol/rtol 1e-5 on out and on the lse, which both keep in the form
relative to the last key under causal ALiBi), the dense forward also in
bf16 under the 2x rule (the port's bf16 output against JAX's fp32 output on
the same bf16-rounded inputs, within twice JAX's own bf16 output's error,
plus 1e-5). Then the oracles against JAX's, the split partials under causal
ALiBi, and what the options reach: a gradient, the dense varlen route and
its packed forms run (their training: tests/test_torch_score_backward.py),
the slopes on the paged route and the MLA route raise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.cache.kvcache import (
    flash_attn_with_kvcache as jax_flash_attn_with_kvcache,
)
from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu.utils import testing as jax_testing
from flash_attn_tpu_torch import (
    flash_attn_func,
    flash_attn_varlen_func,
    flash_attn_with_kvcache,
)
from flash_attn_tpu_torch.kernels.flash_decode import (
    combine_splits,
    flash_attention_decode_partials,
)
from flash_attn_tpu_torch.utils import testing
from flash_attn_tpu_torch.utils.testing import check_against_ref

from jax_paged_refs import jax_kvcache_paged, jax_varlen_paged

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 16
TABLE = np.array([[3, 0, 0, 0, 0, 0], [7, 1, 4, 0, 0, 0],
                  [2, 9, 11, 5, 6, 10]], np.int32)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _slopes(rng, kind, b, h):
    """None, (h,) or (b, h) slopes of ALiBi's magnitudes."""
    if kind is None:
        return None
    s = (0.05 + 0.5 * rng.random((b, h))).astype(np.float32)
    return s[0] if kind == "1d" else s


def _assert_lse(lse_t, lse_j):
    lse_t, lse_j = lse_t.numpy(), np.asarray(lse_j)
    np.testing.assert_array_equal(np.isneginf(lse_t), np.isneginf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], **TOL)


# (name, sq, sk, causal, softcap, slopes, window): the cap alone, ALiBi with
# (h,) and (b, h) slopes causal and not at sq < sk, sq = sk and sq > sk
# (rows that see no key), both together, both under a window
FWD_CASES = [
    ("cap", 37, 70, False, 2.0, None, (-1, -1)),
    ("cap, causal", 50, 50, True, 50.0, None, (-1, -1)),
    ("alibi 1-D, causal, sq < sk", 37, 70, True, 0.0, "1d", (-1, -1)),
    ("alibi 2-D, sq > sk", 70, 37, False, 0.0, "2d", (-1, -1)),
    ("alibi 2-D, causal, sq > sk", 70, 37, True, 0.0, "2d", (-1, -1)),
    ("both, causal", 50, 50, True, 3.0, "2d", (-1, -1)),
    ("both under a causal window", 40, 70, True, 3.0, "1d", (9, 0)),
]


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: c[0])
def test_flash_attn_func_score_matches_jax(case):
    """out, lse and S_dmask (return_attn_probs) against JAX's flash_attn_func
    in fp32 (GQA 4/2); out in bf16 by the 2x rule."""
    _, sq, sk, causal, cap, kind, window = case
    rng = np.random.default_rng(sq * sk + int(cap))
    q, k, v = _rand(rng, 2, sq, 4, 64), _rand(rng, 2, sk, 2, 64), \
        _rand(rng, 2, sk, 2, 64)
    sl = _slopes(rng, kind, 2, 4)
    kw = dict(causal=causal, softcap=cap, window_size=window)
    jsl = {} if sl is None else dict(alibi_slopes=jnp.asarray(sl))
    tsl = {} if sl is None else dict(alibi_slopes=_t(sl))
    out_j, lse_j, p_j = jax_flash_attn_func(
        *(jnp.asarray(x) for x in (q, k, v)), **kw, **jsl,
        return_attn_probs=True)
    out_t, lse_t, p_t = flash_attn_func(_t(q), _t(k), _t(v), **kw, **tsl,
                                        return_attn_probs=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **TOL)

    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    f32 = [x.float().numpy() for x in (qb, kb, vb)]
    ref = jax_flash_attn_func(*map(jnp.asarray, f32), **kw, **jsl)
    ref_lp = jax_flash_attn_func(
        *(jnp.asarray(x, jnp.bfloat16) for x in f32), **kw, **jsl)
    check_against_ref(flash_attn_func(qb, kb, vb, **kw, **tsl), ref,
                      np.asarray(ref_lp, np.float32), msg=case[0])


# (name, sq, causal, softcap, slopes, window, num_splits)
DECODE_CASES = [
    ("cap, sq=1", 1, True, 2.0, None, (-1, -1), 3),
    ("alibi 1-D, causal, sq=5", 5, True, 0.0, "1d", (-1, -1), 3),
    ("alibi 2-D, sq=5", 5, False, 0.0, "2d", (-1, -1), 2),
    ("both under a window, sq=1", 1, True, 3.0, "2d", (20, 0), 4),
]


@pytest.mark.parametrize("case, paged", [
    (case, paged) for case in DECODE_CASES for paged in (False, True)
    if not (paged and case[0].startswith("alibi 2-D"))],
    ids=lambda x: x[0] if isinstance(x, tuple) else
    ("paged" if x else "linear"))
def test_flash_attn_with_kvcache_score_matches_jax(case, paged):
    """Decode with an append (GQA 4/2) over a linear and a paged cache:
    out, the lse (causal ALiBi relative to each row's own last key) and the
    mutated caches, at the lengths of three rows in one call."""
    _, sq, causal, cap, kind, window, splits = case
    rng = np.random.default_rng(sq + int(cap) + 7 * paged)
    b, h, h_k, d = 3, 4, 2, 64
    q = _rand(rng, b, sq, h, d)
    k_new, v_new = _rand(rng, b, sq, h_k, d), _rand(rng, b, sq, h_k, d)
    shape = (12, h_k, PAGE, d) if paged else (b, h_k, 96, d)
    kc, vc = _rand(rng, *shape), _rand(rng, *shape)
    seqlens = np.array([3, 35, 82], np.int32)  # before the append
    sl = _slopes(rng, kind, b, h)
    table = dict(block_table=TABLE) if paged else {}
    if sl is not None:
        table["alibi_slopes"] = sl
    kw = dict(causal=causal, softcap=cap, window_size=window,
              num_splits=splits, return_softmax_lse=True)
    if paged:  # JAX's paged decode at a KV tile of one page
        jkw = {n: x for n, x in kw.items()
               if n not in ("num_splits", "return_softmax_lse")}
        out_j, kc_j, vc_j, lse_j = jax_kvcache_paged(
            *(jnp.asarray(x) for x in (q, kc, vc)), jnp.asarray(seqlens),
            jnp.asarray(TABLE), splits, k=jnp.asarray(k_new),
            v=jnp.asarray(v_new), **jkw,
            **{n: jnp.asarray(x) for n, x in table.items()
               if n != "block_table"})
    else:
        out_j, kc_j, vc_j, lse_j = jax_flash_attn_with_kvcache(
            *(jnp.asarray(x) for x in (q, kc, vc)), k=jnp.asarray(k_new),
            v=jnp.asarray(v_new), cache_seqlens=jnp.asarray(seqlens), **kw,
            **{n: jnp.asarray(x) for n, x in table.items()})
    kc_t, vc_t = _t(kc), _t(vc)
    out_t, lse_t = flash_attn_with_kvcache(
        _t(q), kc_t, vc_t, k=_t(k_new), v=_t(v_new),
        cache_seqlens=_t(seqlens), **kw,
        **{n: _t(x) for n, x in table.items()})
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j), **TOL)
    np.testing.assert_allclose(vc_t.numpy(), np.asarray(vc_j), **TOL)


def test_decode_splits_keep_the_last_key_form():
    """Under causal ALiBi every split partial's lse takes the bias relative
    to its row's last key, so combine_splits merges them as they are: at
    2, 3 and 8 splits the merged out and lse equal one split's (fp32,
    1e-5), and one split's lse equals the dense plain forward's over the
    same rows (the form JAX's flash_attn_func returns)."""
    rng = np.random.default_rng(3)
    b, sq, h, h_k, d = 2, 5, 4, 2, 64
    q = torch.from_numpy(_rand(rng, b, sq, h, d))
    kc = torch.from_numpy(_rand(rng, b, h_k, 320, d))
    vc = torch.from_numpy(_rand(rng, b, h_k, 320, d))
    lens = torch.tensor([300, 208], dtype=torch.int32)
    sl = torch.from_numpy(_slopes(rng, "2d", b, h))
    kw = dict(softcap=5.0, alibi_slopes=sl)
    one, lse_one = flash_attention_decode_partials(
        q, kc, vc, lens, 1, 0.125, True, **kw)
    for splits in (2, 3, 8):
        out_p, lse_p = flash_attention_decode_partials(
            q, kc, vc, lens, splits, 0.125, True, **kw)
        out, lse = combine_splits(out_p, lse_p)
        np.testing.assert_allclose(out.numpy(), one[0].numpy(), **TOL)
        np.testing.assert_allclose(lse.numpy(), lse_one[0].numpy(), **TOL)
    for i, n in enumerate(lens.tolist()):
        _, lse_d, _ = flash_attn_func(
            q[i:i + 1], kc[i:i + 1, :, :n].transpose(1, 2),
            vc[i:i + 1, :, :n].transpose(1, 2), softmax_scale=0.125,
            causal=True, return_attn_probs=True, softcap=5.0,
            alibi_slopes=sl[i])
        # packed row t * group + j of KV head kh is head kh * group + j
        want = lse_one[0, i].reshape(h_k, sq, h // h_k).permute(0, 2, 1) \
            .reshape(h, sq)
        np.testing.assert_allclose(want.numpy(), lse_d[0].numpy(), **TOL)


def test_flash_attn_varlen_paged_softcap_matches_jax():
    """flash_attn_varlen_func(block_table=) (B8's route) with a cap:
    ragged chunks, one padded by seqused_q, over cached keys, under a
    causal window (out and lse against JAX's kernel, one compile) and
    causal alone (against the oracle); out against the oracle both ways."""
    rng = np.random.default_rng(11)
    lens_q, lens_k, used = [9, 1, 30], [12, 40, 90], [9, 1, 24]
    cu = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    q = _rand(rng, int(cu[-1]), 4, 64)
    kp, vp = _rand(rng, 12, 2, PAGE, 64), _rand(rng, 12, 2, PAGE, 64)
    lens_k, used = np.array(lens_k, np.int32), np.array(used, np.int32)
    for window in ((10, 0), (-1, -1)):
        kw = dict(causal=True, softcap=2.0, window_size=window)
        out_t, lse_t = flash_attn_varlen_func(
            _t(q), _t(kp), _t(vp), _t(cu), None, max(lens_q), 96,
            block_table=_t(TABLE), seqused_k=_t(lens_k), seqused_q=_t(used),
            return_attn_probs=True, **kw)
        if window[0] > 0:
            out_j, lse_j = jax_varlen_paged(
                *(jnp.asarray(x) for x in (q, kp, vp)), jnp.asarray(cu),
                max(lens_q), jnp.asarray(lens_k), jnp.asarray(TABLE),
                seqused_q=jnp.asarray(used), **kw)
            np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                       **TOL)
            _assert_lse(lse_t, lse_j)
        want = testing.attention_varlen_paged_ref(
            _t(q), _t(kp), _t(vp), _t(cu), _t(lens_k), _t(TABLE),
            seqused_q=_t(used), causal=True, softcap=2.0,
            window_size=tuple(None if x < 0 else x for x in window))
        np.testing.assert_allclose(out_t.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_oracles_match_jax(causal, kind):
    """attn_bias_from_alibi_slopes (with query and key padding) and
    attention_ref with softcap and ALiBi against JAX's (attn_bias from its
    own attn_bias_from_alibi_slopes)."""
    rng = np.random.default_rng(5 + causal)
    b, sq, sk, h = 2, 30, 45, 4
    sl = _slopes(rng, kind, b, h)
    qpm = np.arange(sq)[None] < np.array([[30], [21]])
    kpm = np.arange(sk)[None] < np.array([[45], [33]])
    bias_j = jax_testing.attn_bias_from_alibi_slopes(
        jnp.asarray(sl), sq, sk, jnp.asarray(qpm), jnp.asarray(kpm),
        causal=causal)
    bias_t = testing.attn_bias_from_alibi_slopes(
        _t(sl), sq, sk, _t(qpm), _t(kpm), causal=causal)
    np.testing.assert_allclose(
        np.broadcast_to(bias_t.numpy(), (b, h, sq, sk)),
        np.broadcast_to(np.asarray(bias_j), (b, h, sq, sk)), **TOL)
    q, k, v = _rand(rng, b, sq, h, 32), _rand(rng, b, sk, 2, 32), \
        _rand(rng, b, sk, 2, 32)
    out_j, attn_j = jax_testing.attention_ref(
        *(jnp.asarray(x) for x in (q, k, v)), key_padding_mask=jnp.asarray(kpm),
        causal=causal, softcap=4.0,
        attn_bias=jax_testing.attn_bias_from_alibi_slopes(
            jnp.asarray(sl), sq, sk, None, jnp.asarray(kpm), causal=causal))
    out_t, attn_t = testing.attention_ref(
        _t(q), _t(k), _t(v), key_padding_mask=_t(kpm), causal=causal,
        softcap=4.0, alibi_slopes=_t(sl))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j), **TOL)


def _refusal(kind):
    """The call of one kind, and the words the message of its refusal must
    hold (None: a call that runs)."""
    x = torch.randn(1, 8, 2, 64)
    packed = torch.randn(12, 2, 64)
    cu = torch.tensor([0, 5, 12], dtype=torch.int32)
    sl = torch.ones(2)
    if kind == "gradient, softcap":
        q = x.clone().requires_grad_()
        return lambda: flash_attn_func(q, q, q, softcap=5.0), None
    if kind == "gradient, alibi":
        q = x.clone().requires_grad_()
        return lambda: flash_attn_func(q, q, q, alibi_slopes=sl), None
    if kind == "gradient, packed form":
        from flash_attn_tpu_torch.interface import flash_attn_qkvpacked_func
        qkv = torch.randn(1, 8, 3, 2, 64, requires_grad=True)
        return lambda: flash_attn_qkvpacked_func(qkv, softcap=5.0), None
    packed.requires_grad_()
    if kind in ("dense varlen, softcap", "dense varlen, alibi"):
        kw = dict(softcap=5.0) if "softcap" in kind else dict(alibi_slopes=sl)
        return (lambda: flash_attn_varlen_func(packed, packed, packed, cu, cu,
                                               7, 7, **kw)), None
    if kind == "qkv-packed varlen, softcap":
        from flash_attn_tpu_torch.interface import (
            flash_attn_varlen_qkvpacked_func,
        )
        return (lambda: flash_attn_varlen_qkvpacked_func(
            torch.stack([packed] * 3, 1), cu, 7, softcap=5.0)), None
    if kind == "kv-packed varlen, alibi":
        from flash_attn_tpu_torch.interface import (
            flash_attn_varlen_kvpacked_func,
        )
        return (lambda: flash_attn_varlen_kvpacked_func(
            packed, torch.stack([packed] * 2, 1), cu, cu, 7, 7,
            alibi_slopes=sl)), None
    if kind == "slopes on the paged route":
        kp = torch.zeros(12, 2, PAGE, 64)
        return (lambda: flash_attn_varlen_func(
            packed, kp, kp, cu, None, 7, 64, block_table=_t(TABLE[:2]),
            seqused_k=torch.tensor([5, 7]), alibi_slopes=sl)), "queue C"
    if kind == "the MLA route":
        q = torch.zeros(1, 1, 2, 64)
        k = torch.zeros(1, 1, 128, 64)
        v = torch.zeros(1, 1, 128, 128)
        return (lambda: flash_attn_with_kvcache(
            q, k, v, cache_seqlens=4, softcap=5.0,
            qv=torch.zeros(1, 1, 2, 128))), "item 7"
    raise ValueError(kind)


@pytest.mark.parametrize("kind", [
    "gradient, softcap", "gradient, alibi", "gradient, packed form",
    "dense varlen, softcap", "dense varlen, alibi",
    "qkv-packed varlen, softcap", "kv-packed varlen, alibi",
    "slopes on the paged route", "the MLA route"])
def test_score_refusals(kind):
    """What stays unported raises NotImplementedError before any kernel
    runs, naming its ROADMAP.md item: the slopes on the paged route (queue
    C: JAX's route drops them), the MLA route (item 7). What was refused
    until the backwards took the score map runs: a gradient through
    flash_attn_func and its packed forms, the dense varlen route and its
    packed forms, forward and backward, with finite outputs and gradients
    (held to JAX in tests/test_torch_score_backward.py)."""
    call, words = _refusal(kind)
    if words is not None:
        with pytest.raises(NotImplementedError, match=words):
            call()
        return
    out = call()
    assert torch.isfinite(out).all()
    out.square().sum().backward()
    leaf = next(t for t in _leaves(out) if t.grad is not None)
    assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().sum() > 0


def _leaves(out):
    """The leaf tensors that a graph's output reaches."""
    seen, todo, leaves = set(), [out.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if hasattr(fn, "variable"):
            leaves.append(fn.variable)
        todo.extend(f for f, _ in fn.next_functions)
    return leaves
