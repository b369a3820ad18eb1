"""The band masks (sliding window, chunked attention, sink tokens) in the
port's attention backward against the JAX package on the same numpy
inputs, on the CPU: the port runs the plain versions of its backward
kernels (B3 and B2 take the band in their band instantiations on the
card), JAX its Pallas backward kernels in interpret mode.

``flash_attn_func``'s gradients in both ``deterministic`` modes against
``jax.grad`` of JAX's ``flash_attn_func`` (fp32, atol 1e-4 as
tests/test_torch_backward.py); the host's query-tile bounds against JAX's
``_q_block_bounds``; the plain band backward against JAX's
``flash_attention_bwd`` called on the same saved forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu.kernels.flash_bwd import _q_block_bounds
from flash_attn_tpu.kernels.flash_bwd import (
    flash_attention_bwd as jax_flash_attention_bwd,
)
from flash_attn_tpu.kernels.flash_fwd import (
    flash_attention_fwd as jax_flash_attention_fwd,
)
from flash_attn_tpu_torch import flash_attn_func
from flash_attn_tpu_torch.dispatch.band import q_band_static
from flash_attn_tpu_torch.dispatch.config import normalize_window
from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd

torch.set_num_threads(1)

ATOL = 1e-4  # gradients, fp32 on both sides: summation order only

# (name, sq, sk, h, h_k, causal, window, attention_chunk, sink_token_length)
# at head dim 32: every form the band takes in training. sq = sk = 1 causal
# stays out (JAX's dv fault at one row, ROADMAP.md queue C).
GRAD_CASES = [
    ("causal left window", 70, 70, 4, 2, True, (9, 0), 0, 0),
    ("window both ways", 64, 64, 2, 2, False, (8, 5), 0, 0),
    ("window both ways, sq > sk", 70, 37, 2, 2, False, (8, 8), 0, 0),
    ("left window only", 50, 50, 2, 2, False, (10, -1), 0, 0),
    ("right window only", 40, 50, 2, 2, False, (-1, 6), 0, 0),
    ("chunk, causal", 70, 70, 2, 2, True, (-1, -1), 16, 0),
    ("sinks under a causal window", 70, 70, 2, 2, True, (12, 0), 0, 4),
    ("causal window, sq < sk", 37, 70, 4, 4, True, (31, 0), 0, 0),
    ("causal window, sq > sk (rows with no key)", 70, 37, 2, 2, True, (7, 0),
     0, 0),
    ("GQA 4/1, window", 48, 48, 4, 1, True, (5, 0), 0, 0),
]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(case, seed=0):
    _, sq, sk, h, h_k, *_ = case
    rng = np.random.default_rng(seed + sq * sk)
    return (_rand(rng, 2, sq, h, 32), _rand(rng, 2, sk, h_k, 32),
            _rand(rng, 2, sk, h_k, 32), _rand(rng, 2, sq, h, 32))


def _band(case):
    *_, causal, window, chunk, sink = case
    return dict(causal=causal, window_size=window, attention_chunk=chunk,
                sink_token_length=sink)


def _jax_grads(q, k, v, g, band):
    def f(q_, k_, v_):
        return (jax_flash_attn_func(q_, k_, v_, **band) * g).sum()
    return [np.asarray(x) for x in
            jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


def _port_grads(q, k, v, g, band, deterministic):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attn_func(*leaves, deterministic=deterministic, **band)
    out.backward(torch.from_numpy(g))
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: c[0])
def test_flash_attn_func_band_grads_match_jax(case):
    q, k, v, g = _inputs(case)
    band = _band(case)
    want = _jax_grads(q, k, v, g, band)
    for deterministic in (True, False):
        got = _port_grads(q, k, v, g, band, deterministic)
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(
                a, b, atol=ATOL, rtol=0,
                err_msg=f"{case[0]} d{name} deterministic={deterministic}")


# (nq, nk, block_q, block_k, shift, causal, window_left, window_right,
# sink_token_length, attention_chunk)
Q_BAND_CASES = [
    (4, 8, 128, 64, 0, True, None, None, 0, 0),
    (4, 8, 128, 64, 0, True, 100, None, 0, 0),
    (8, 4, 64, 128, 0, False, 100, 30, 0, 0),
    (3, 5, 128, 64, -100, True, 10, None, 0, 0),
    (4, 8, 128, 64, 200, False, None, 0, 0, 0),
    (4, 8, 128, 64, 0, True, None, None, 0, 96),
    (4, 8, 128, 64, -37, False, None, None, 0, 96),
    (4, 8, 128, 64, 0, True, 100, None, 4, 0),
    (16, 2, 64, 128, 700, True, 3000, None, 0, 0),
    (5, 5, 64, 64, 37, False, 10, 5, 0, 1000),
]


@pytest.mark.parametrize("case", Q_BAND_CASES)
def test_q_band_static_matches_jax(case):
    nq, nk, bq, bk, shift, causal, wl, wr, sink, chunk = case
    want = [_q_block_bounds(j, bq, bk, shift, nq, causal, wl, wr, sink, chunk)
            for j in range(nk)]
    assert q_band_static(*case) == (tuple(int(x[0]) for x in want),
                                    tuple(int(x[1]) for x in want))


@pytest.mark.parametrize("case", [GRAD_CASES[i] for i in (0, 5, 6, 8)],
                         ids=lambda c: c[0])
def test_plain_band_backward_matches_jax_kernels(case):
    """flash_attention_bwd_plain against JAX's flash_attention_bwd on the
    same saved forward (JAX's kernel's out and lse, (b, h, s, d)), and the
    port's plain forward's out and lse against that kernel's."""
    q, k, v, g = (np.swapaxes(x, 1, 2) for x in _inputs(case, seed=1))
    band = _band(case)
    out_j, lse_j = jax_flash_attention_fwd(*map(jnp.asarray, (q, k, v)),
                                           **band, interpret=True)
    want = jax_flash_attention_bwd(
        jnp.asarray(g), *map(jnp.asarray, (q, k, v)), out_j, lse_j, **band,
        interpret=True)
    window = normalize_window(band.pop("window_size"))
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (g, q, k, v)]
    out_t, lse_t = flash_fwd.flash_attention_fwd_plain(*t[1:],
                                                       window_size=window,
                                                       **band)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(np.isneginf(lse_t.numpy()),
                                  np.isneginf(np.asarray(lse_j)))
    got = flash_bwd.flash_attention_bwd_plain(
        *t, torch.from_numpy(np.array(out_j)),
        torch.from_numpy(np.array(lse_j)), window_size=window, **band)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0, err_msg=f"d{name}")
