"""The ops the port adds beside its kernels (no kernel of their own): the
conjugate rotary and the qkv / kv rotary helpers, RotaryEmbedding's xPos
(scale_base) and dynamic NTK (ntk_orig_len) tables, the parallel-residual
and subset (drop-path) norms and bias_gelu, each against the JAX package's
function on the same numpy inputs on the CPU: values, and for the
differentiable ones the gradient of a seeded projection of the output
against jax.grad. Both run in fp32 and differ only in summation order and
in where the rotation rounds (the port rotates in fp32 and rounds once,
which in fp32 is the same): atol/rtol 1e-5, 1e-4 for the tables (powers
and cosines of arguments up to ~1e3, one float32 ulp of which is ~1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.modules.mha import RotaryEmbedding as JaxRotaryEmbedding
from flash_attn_tpu.ops import activations as jact
from flash_attn_tpu.ops import norm as jnorm
from flash_attn_tpu.ops import rotary as jrot
from flash_attn_tpu_torch.modules.mha import RotaryEmbedding
from flash_attn_tpu_torch.ops import activations, norm, rotary

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
TABLE_TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _grads_match(port_fn, jax_fn, arrays, tol=TOL):
    """port_fn and jax_fn over the same fp32 arrays: equal outputs, and
    equal gradients of sum(out * g) for a seeded g of each output."""
    rng = np.random.default_rng(len(arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out_t = port_fn(*ts)
    out_t = out_t if isinstance(out_t, tuple) else (out_t,)
    out_j = jax_fn(*map(jnp.asarray, arrays))
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    cots = [_rand(rng, *o.shape) for o in out_t if o is not None]
    for o_t, o_j in zip(out_t, out_j):
        if o_t is None:
            assert o_j is None
            continue
        np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                                   **tol)
    live = [o for o in out_t if o is not None]
    sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(live, cots)
        ).backward()

    def loss(*xs):
        outs = jax_fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        outs = [o for o in outs if o is not None]
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))
    grads_j = jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    for t, g_j in zip(ts, grads_j):  # an unused input: no grad, JAX's 0
        got = torch.zeros_like(t) if t.grad is None else t.grad
        np.testing.assert_allclose(got.numpy(), np.asarray(g_j), **tol)


def _tables(rng, s, rot):
    ang = rng.uniform(0, 6, (s, rot // 2)).astype(np.float32)
    return np.cos(ang), np.sin(ang)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("offsets", [0, 3, "per_row"])
def test_conjugate_rotary_matches_jax(interleaved, offsets):
    """apply_rotary_emb(conjugate=True) on half of each head, with int and
    per-row offsets: values and gradients as JAX's (the conjugate rotation
    undoes the rotation, too)."""
    rng = np.random.default_rng(interleaved + 2 * (offsets == 3))
    b, s, h, d = 2, 5, 3, 16
    cos, sin = _tables(rng, 12, 8)
    x = _rand(rng, b, s, h, d)
    off = offsets if offsets != "per_row" else np.array([2, 7], np.int32)
    off_t = torch.from_numpy(off) if offsets == "per_row" else off
    off_j = jnp.asarray(off) if offsets == "per_row" else off
    _grads_match(
        lambda x_: rotary.apply_rotary_emb(
            x_, torch.from_numpy(cos), torch.from_numpy(sin), interleaved,
            off_t, conjugate=True),
        lambda x_: jrot.apply_rotary_emb(x_, jnp.asarray(cos),
                                         jnp.asarray(sin), interleaved,
                                         off_j, conjugate=True),
        [x])
    xt = torch.from_numpy(x)
    there = rotary.apply_rotary_emb(xt, torch.from_numpy(cos),
                                    torch.from_numpy(sin), interleaved, off_t)
    back = rotary.apply_rotary_emb(there, torch.from_numpy(cos),
                                   torch.from_numpy(sin), interleaved, off_t,
                                   conjugate=True)
    np.testing.assert_allclose(back.numpy(), x, **TOL)


def test_conjugate_rotary_packed_matches_jax():
    """The conjugate rotation over packed sequences (cu_seqlens)."""
    rng = np.random.default_rng(7)
    cos, sin = _tables(rng, 16, 16)
    x = _rand(rng, 11, 2, 16)
    cu = np.array([0, 4, 4, 11], np.int32)
    _grads_match(
        lambda x_: rotary.apply_rotary_emb(
            x_, torch.from_numpy(cos), torch.from_numpy(sin), True,
            cu_seqlens=torch.from_numpy(cu), max_seqlen=7, conjugate=True),
        lambda x_: jrot.apply_rotary_emb(
            x_, jnp.asarray(cos), jnp.asarray(sin), True,
            cu_seqlens=jnp.asarray(cu), max_seqlen=7, conjugate=True),
        [x])


@pytest.mark.parametrize("interleaved", [False, True])
def test_qkv_and_kv_rotary_match_jax(interleaved):
    """apply_rotary_emb_qkv_ rotates q and k of packed qkv, and
    apply_rotary_emb_kv_ k of packed kv; v passes through."""
    rng = np.random.default_rng(10 + interleaved)
    cos, sin = _tables(rng, 9, 12)
    qkv, kv = _rand(rng, 2, 6, 3, 2, 16), _rand(rng, 2, 6, 2, 2, 16)
    tabs_t = (torch.from_numpy(cos), torch.from_numpy(sin))
    tabs_j = (jnp.asarray(cos), jnp.asarray(sin))
    _grads_match(
        lambda x: rotary.apply_rotary_emb_qkv_(x, *tabs_t, interleaved, 2),
        lambda x: jrot.apply_rotary_emb_qkv_(x, *tabs_j, interleaved, 2),
        [qkv])
    _grads_match(
        lambda x: rotary.apply_rotary_emb_kv_(x, *tabs_t, interleaved),
        lambda x: jrot.apply_rotary_emb_kv_(x, *tabs_j, interleaved),
        [kv])
    out = rotary.apply_rotary_emb_qkv_(torch.from_numpy(qkv), *tabs_t,
                                       interleaved)
    assert torch.equal(out[:, :, 2], torch.from_numpy(qkv)[:, :, 2])


@pytest.mark.parametrize("scale_base, ntk", [(None, None), (512.0, None),
                                             (None, 64), (256.0, 64)])
def test_rotary_embedding_tables_match_jax(scale_base, ntk):
    """RotaryEmbedding's cos_sin and cos_sin_scaled (xPos) against JAX's at
    lengths below and above ntk_orig_len (a base that grows with the
    length); a table is cached per (length, device) and the cache gives
    each length its own base."""
    port = RotaryEmbedding(32, 10000.0, False, scale_base, ntk)
    ref = JaxRotaryEmbedding(32, 10000.0, False, scale_base, ntk)
    for seqlen in (48, 200, 48):
        assert port._base_for(seqlen) == ref._base_for(seqlen)
        for got, want in zip(port.cos_sin(seqlen), ref.cos_sin(seqlen)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **TABLE_TOL)
        for got, want in zip(port.cos_sin_scaled(seqlen),
                             ref.cos_sin_scaled(seqlen)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **TABLE_TOL)
    if ntk is not None:
        assert port._base_for(200) > port._base_for(48) == 10000.0
        assert not torch.equal(port.cos_sin(200)[0][:48], port.cos_sin(48)[0])
    assert len(port._tables) == 2


@pytest.mark.parametrize("with_x1, with_w1, prenorm",
                         [(True, True, False), (False, True, True),
                          (True, False, True)])
def test_parallel_residual_norm_matches_jax(with_x1, with_w1, prenorm):
    """dropout_add_layer_norm_parallel_residual: two streams (or one), one
    residual add, two norms (or one) of the sum, the sum with prenorm."""
    rng = np.random.default_rng(20 + with_x1 + 2 * with_w1)
    x0, x1, res = (_rand(rng, 3, 5, 24) for _ in range(3))
    w0, b0, w1, b1 = (_rand(rng, 24) for _ in range(4))

    def run(mod):
        def fn(x0_, x1_, res_, w0_, b0_, w1_, b1_):
            return mod(x0_, x1_ if with_x1 else None, res_, w0_, b0_,
                       w1_ if with_w1 else None, b1_ if with_w1 else None,
                       epsilon=1e-5, prenorm=prenorm)
        return fn

    _grads_match(run(norm.dropout_add_layer_norm_parallel_residual),
                 run(jnorm.dropout_add_layer_norm_parallel_residual),
                 [x0, x1, res, w0, b0, w1, b1])


def _subset_of(mask, s):
    flat = np.repeat(mask, s)
    sub = np.cumsum(flat).astype(np.int32)
    sub[~flat] = 0
    return sub.reshape(len(mask), s)


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("prenorm", [False, True])
def test_subset_norms_match_jax(rms, prenorm):
    """dropout_add_{layer,rms}_norm_subset as JAX's own test drives them
    (tests/test_ops.py:107): kept rows scattered into the stream with the
    drop-path scale and a layerscale, the residual added, normed, and the
    rows of the output subset kept; one count larger than the subset
    (JAX's nonzero pads it with row 0)."""
    rng = np.random.default_rng(30 + rms + 2 * prenorm)
    b, s, d = 4, 8, 32
    keep_in = np.array([True, False, True, True])
    keep_out = np.array([True, True, False, True])
    x0_sub, out_sub = _subset_of(keep_in, s), _subset_of(keep_out, s)
    n_in = int(keep_in.sum()) * s
    x0, res = _rand(rng, n_in, d), _rand(rng, b, s, d)
    w, bias, ls = _rand(rng, d), _rand(rng, d), _rand(rng, d)
    for n_out in (int(keep_out.sum()) * s, int(keep_out.sum()) * s + 3):
        kw = dict(x0_subset=x0_sub, out_subset=out_sub,
                  rowscale_const=1.0 / 0.75, out_numrows=n_out,
                  prenorm=prenorm)
        kw_t = {**kw, "x0_subset": torch.from_numpy(x0_sub),
                "out_subset": torch.from_numpy(out_sub)}
        kw_j = {**kw, "x0_subset": jnp.asarray(x0_sub),
                "out_subset": jnp.asarray(out_sub)}
        if rms:
            _grads_match(
                lambda x_, r_, w_, l_: norm.dropout_add_rms_norm_subset(
                    x_, r_, w_, 0.0, 1e-6, layerscale=l_, **kw_t),
                lambda x_, r_, w_, l_: jnorm.dropout_add_rms_norm_subset(
                    x_, r_, w_, 0.0, 1e-6, layerscale=l_, **kw_j),
                [x0, res, w, ls])
        else:
            _grads_match(
                lambda x_, r_, w_, b_, l_: norm.dropout_add_layer_norm_subset(
                    x_, r_, w_, b_, 0.0, 1e-5, layerscale=l_, **kw_t),
                lambda x_, r_, w_, b_, l_: jnorm.dropout_add_layer_norm_subset(
                    x_, r_, w_, b_, 0.0, 1e-5, layerscale=l_, **kw_j),
                [x0, res, w, bias, ls])


def test_new_norms_refuse_dropout_naming_item_7():
    x = torch.randn(2, 4, 8)
    sub = torch.ones(2, 4, dtype=torch.int32).cumsum(-1).reshape(2, 4)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        norm.dropout_add_layer_norm_parallel_residual(
            x, x, x, torch.ones(8), None, dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        norm.dropout_add_layer_norm_subset(
            x.reshape(8, 8), x, torch.ones(8), None, 0.1, 1e-5,
            x0_subset=sub, out_subset=sub, out_numrows=8)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        norm.dropout_add_rms_norm_subset(
            x.reshape(8, 8), x, torch.ones(8), 0.1, 1e-6,
            x0_subset=sub, out_subset=sub, out_numrows=8)


def test_bias_gelu_matches_jax():
    rng = np.random.default_rng(40)
    _grads_match(activations.bias_gelu, jact.bias_gelu,
                 [_rand(rng, 3, 7, 16) * 3, _rand(rng, 16)])
