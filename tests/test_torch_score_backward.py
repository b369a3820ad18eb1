"""softcap and ALiBi in the port's attention backward against the JAX
package on the same numpy inputs, on the CPU: the port runs the plain
versions of its kernels (B3 and B2 take the score map in their score
instantiations on the card, B6's backward and B6's and B7's forwards on the
varlen route), JAX its Pallas kernels in interpret mode.

``flash_attn_func``'s gradients in both ``deterministic`` modes against
``jax.grad`` of JAX's ``flash_attn_func`` (fp32 on both sides: atol 1e-4,
as tests/test_torch_band_backward.py), the slopes' gradient exactly zero
(JAX returns zeros), the dense varlen route's out, lse and gradients
against JAX's ``flash_attn_varlen_func`` (out and lse atol/rtol 1e-5, the
lse in JAX's last-key form; gradients atol 1e-4), and the plain score
backward against JAX's ``flash_attention_bwd`` on the same saved
forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu.interface import flash_attn_varlen_func as jax_varlen
from flash_attn_tpu.kernels.flash_bwd import (
    flash_attention_bwd as jax_flash_attention_bwd,
)
from flash_attn_tpu.kernels.flash_fwd import (
    flash_attention_fwd as jax_flash_attention_fwd,
)
from flash_attn_tpu_torch import flash_attn_func, flash_attn_varlen_func
from flash_attn_tpu_torch.dispatch.config import normalize_window
from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 1e-4  # gradients, fp32 on both sides: summation order only

# (name, sq, sk, h, h_k, causal, window, softcap, slopes) at head dim 32,
# two batch rows; slopes None, "1d" ((h,)) or "2d" ((b, h)). sq = sk = 1
# causal stays out (JAX's dv fault at one row, ROADMAP.md queue C).
GRAD_CASES = [
    ("cap 5, causal", 70, 70, 4, 2, True, (-1, -1), 5.0, None),
    ("alibi (h,), causal, sq < sk", 37, 70, 4, 4, True, (-1, -1), 0.0, "1d"),
    ("alibi (b, h), not causal, sq > sk", 70, 37, 2, 2, False, (-1, -1),
     0.0, "2d"),
    ("both, causal, sq > sk (rows with no key)", 70, 37, 2, 2, True,
     (-1, -1), 3.0, "2d"),
    ("both under a causal window", 64, 64, 4, 2, True, (9, 0), 4.0, "1d"),
    ("alibi (b, h) and cap 2, not causal, GQA 4/1", 48, 48, 4, 1, False,
     (-1, -1), 2.0, "2d"),
]


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


def _inputs(case, seed=0):
    _, sq, sk, h, h_k, *_, kind = case
    rng = np.random.default_rng(seed + sq * sk + h)
    return (_rand(rng, 2, sq, h, 32), _rand(rng, 2, sk, h_k, 32),
            _rand(rng, 2, sk, h_k, 32), _rand(rng, 2, sq, h, 32),
            _slopes(rng, kind, 2, h))


def _kw(case):
    *_, causal, window, cap, _ = case
    return dict(causal=causal, window_size=window, softcap=cap)


def _jax_grads(q, k, v, g, sl, kw):
    def f(q_, k_, v_):
        return (jax_flash_attn_func(
            q_, k_, v_, alibi_slopes=None if sl is None else jnp.asarray(sl),
            **kw) * g).sum()
    return [np.asarray(x) for x in
            jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


def _port_grads(q, k, v, g, sl, kw, deterministic):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attn_func(*leaves, deterministic=deterministic,
                          alibi_slopes=None if sl is None else _t(sl), **kw)
    out.backward(torch.from_numpy(g))
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: c[0])
def test_flash_attn_func_score_grads_match_jax(case):
    q, k, v, g, sl = _inputs(case)
    kw = _kw(case)
    want = _jax_grads(q, k, v, g, sl, kw)
    for deterministic in (True, False):
        got = _port_grads(q, k, v, g, sl, kw, deterministic)
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(
                a, b, atol=ATOL, rtol=0,
                err_msg=f"{case[0]} d{name} deterministic={deterministic}")


@pytest.mark.parametrize("route", ["dense", "packed", "varlen"])
def test_slope_gradients_are_zero(route):
    """A slopes tensor with requires_grad gets exact zeros, as JAX returns
    (flash_attn_tpu/interface.py:182-184); the other gradients flow."""
    rng = np.random.default_rng(3)
    sl = _t(_slopes(rng, "2d", 2, 4)).requires_grad_()
    if route == "varlen":
        q = _t(_rand(rng, 30, 4, 32)).requires_grad_()
        cu = torch.tensor([0, 12, 30], dtype=torch.int32)
        out = flash_attn_varlen_func(q, q, q, cu, cu, 18, 18, causal=True,
                                     alibi_slopes=sl, softcap=3.0)
    elif route == "packed":
        from flash_attn_tpu_torch.interface import flash_attn_qkvpacked_func

        q = _t(_rand(rng, 2, 20, 3, 4, 32)).requires_grad_()
        out = flash_attn_qkvpacked_func(q, causal=True, alibi_slopes=sl)
    else:
        q = _t(_rand(rng, 2, 20, 4, 32)).requires_grad_()
        out = flash_attn_func(q, q, q, alibi_slopes=sl, softcap=3.0)
    out.square().sum().backward()
    assert torch.equal(sl.grad, torch.zeros_like(sl))
    assert torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0


# (name, lens_q, lens_k, causal, window, softcap, slopes, h, h_k): ragged
# lengths with a zero-length sequence, sq != sk under the causal shift, GQA
VARLEN_CASES = [
    ("alibi (b, h), causal", [40, 0, 70, 33], [40, 0, 70, 33], True,
     (-1, -1), 0.0, "2d", 4, 2),
    ("cap, sq != sk, not causal", [50, 21, 64], [30, 40, 64], False,
     (-1, -1), 4.0, None, 2, 2),
    ("both under a causal window, sq != sk", [30, 50, 17], [45, 50, 40],
     True, (12, 0), 3.0, "1d", 4, 1),
]


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


@pytest.mark.parametrize("case", VARLEN_CASES, ids=lambda c: c[0])
def test_varlen_score_out_lse_and_grads_match_jax(case):
    """The dense varlen route (ALiBi through B6's forward, the cap alone
    through B7, B6's backward) against JAX's flash_attn_varlen_func, each
    sequence with its row of slopes."""
    _, lens_q, lens_k, causal, window, cap, kind, h, h_k = case
    rng = np.random.default_rng(sum(lens_q) + h)
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    q, k, v = _rand(rng, tq, h, 32), _rand(rng, tk, h_k, 32), \
        _rand(rng, tk, h_k, 32)
    g = _rand(rng, tq, h, 32)
    sl = _slopes(rng, kind, len(lens_q), h)
    kw = dict(causal=causal, window_size=window, softcap=cap)
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
    for name, leaf, gj in zip("qkv", leaves, grads_j):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gj),
                                   atol=ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("case", [GRAD_CASES[i] for i in (0, 3, 5)],
                         ids=lambda c: c[0])
def test_plain_score_backward_matches_jax_kernels(case):
    """flash_attention_bwd_plain against JAX's flash_attention_bwd on the
    same saved forward (JAX's kernel's out and lse, (b, h, s, d), the
    slopes (b, h)), and the port's plain forward's out and lse against that
    kernel's."""
    q, k, v, g, sl = (x if x is None or x.ndim < 4 else np.swapaxes(x, 1, 2)
                      for x in _inputs(case, seed=1))
    if sl is not None and sl.ndim == 1:
        sl = np.broadcast_to(sl, (2, sl.shape[0])).copy()
    kw = _kw(case)
    jsl = None if sl is None else jnp.asarray(sl)
    out_j, lse_j = jax_flash_attention_fwd(*map(jnp.asarray, (q, k, v)),
                                           alibi_slopes=jsl, **kw,
                                           interpret=True)
    want = jax_flash_attention_bwd(
        jnp.asarray(g), *map(jnp.asarray, (q, k, v)), out_j, lse_j,
        alibi_slopes=jsl, **kw, interpret=True)
    kw["window_size"] = normalize_window(kw["window_size"])
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (g, q, k, v)]
    tsl = None if sl is None else _t(sl)
    out_t, lse_t = flash_fwd.flash_attention_fwd_plain(*t[1:],
                                                       alibi_slopes=tsl, **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    fin = np.isfinite(np.asarray(lse_j))
    np.testing.assert_array_equal(np.isfinite(lse_t.numpy()), fin)
    np.testing.assert_allclose(lse_t.numpy()[fin], np.asarray(lse_j)[fin],
                               **TOL)
    got = flash_bwd.flash_attention_bwd_plain(
        *t, torch.from_numpy(np.array(out_j)),
        torch.from_numpy(np.array(lse_j)), alibi_slopes=tsl, **kw)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0, err_msg=f"d{name}")
