"""The port's attention backward (flash_attn_tpu_torch) against the JAX
package on the same numpy inputs, on the CPU: the port runs the plain
version of its backward kernels, JAX its Pallas backward kernels in
interpret mode (through ``jax.grad`` of its ``flash_attn_func``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu_torch import flash_attn_func
from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
from flash_attn_tpu_torch.utils.testing import (
    attention_ref_grads,
    check_against_ref,
)

torch.set_num_threads(1)

# fp32 on both sides at unit-scale inputs: the two differ only in
# summation order (sums of up to a few hundred products).
ATOL = 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _grads_jax(q, k, v, g, causal):
    def f(q, k, v):
        return (jax_flash_attn_func(q, k, v, causal=causal) * g).sum()
    return [np.asarray(x) for x in
            jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))]


@pytest.mark.parametrize("sq,sk,h,h_k,d,causal", [
    (128, 128, 4, 4, 64, True),
    (128, 128, 4, 4, 64, False),
    (96, 96, 4, 2, 64, True),      # GQA 4/2
    (96, 96, 4, 2, 128, True),
    (64, 160, 4, 2, 128, True),    # sq < sk, bottom-right causal
    (100, 100, 4, 4, 64, True),    # ragged length
    (72, 130, 4, 2, 128, False),   # ragged, non-causal, sq != sk
])
def test_flash_attn_func_grads_match_jax(sq, sk, h, h_k, d, causal):
    rng = np.random.default_rng(sq * 7 + sk)
    q, k, v = _rand(rng, 2, sq, h, d), _rand(rng, 2, sk, h_k, d), \
        _rand(rng, 2, sk, h_k, d)
    g = _rand(rng, 2, sq, h, d)
    want = _grads_jax(q, k, v, g, causal)
    for deterministic in (True, False):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = flash_attn_func(*leaves, causal=causal,
                              deterministic=deterministic)
        (out * torch.from_numpy(g)).sum().backward()
        for name, leaf, ref in zip("qkv", leaves, want):
            assert leaf.grad.shape == ref.shape
            np.testing.assert_allclose(
                leaf.grad.numpy(), ref, atol=ATOL, rtol=0,
                err_msg=f"d{name} deterministic={deterministic}")


@pytest.mark.parametrize("sq,sk,h,h_k,causal", [
    (40, 24, 4, 2, True),    # sq > sk: the first rows see no key
    (33, 57, 4, 1, True),    # MQA, sq < sk
    (33, 57, 2, 2, False),
])
def test_plain_backward_matches_autograd_reference(sq, sk, h, h_k, causal):
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.from_numpy(_rand(rng, 2, s, n, 32))
               for s, n in ((sq, h), (sk, h_k), (sk, h_k)))
    do = torch.from_numpy(_rand(rng, 2, sq, h, 32))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out, lse = flash_fwd.flash_attention_fwd_plain(qt, kt, vt, causal=causal)
    got = flash_bwd.flash_attention_bwd_plain(dot, qt, kt, vt, out, lse,
                                              causal=causal)
    want = attention_ref_grads(q, k, v, do, causal=causal)
    for g, r in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.transpose(1, 2), r, atol=1e-5, rtol=1e-5)


def test_bf16_grads_two_times_rule():
    """The plain backward in bf16 (fp32 inside) against the bf16 autograd
    reference: the repo's 2x rule, as chip_smoke.py holds the kernels."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(_rand(rng, 2, 80, 4, 64)).to(torch.bfloat16)
                   for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attn_func(*leaves, causal=True).backward(do)
    ref = attention_ref_grads(q.float(), k.float(), v.float(), do.float(),
                              causal=True)
    ref_lp = attention_ref_grads(q, k, v, do, causal=True, upcast=False)
    for name, leaf, r, lp in zip("qkv", leaves, ref, ref_lp):
        assert leaf.grad.dtype == torch.bfloat16
        check_against_ref(leaf.grad, r, lp, atol=1e-4, msg=f"d{name}")


def test_backward_wrapper_counts_no_plain_launches():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_rand(rng, 1, 16, 2, 64)).requires_grad_()
    before = (flash_bwd.launches_dkdv, flash_bwd.launches_dq,
              flash_bwd.launches_fused)
    flash_attn_func(q, q, q, causal=True).sum().backward()
    assert (flash_bwd.launches_dkdv, flash_bwd.launches_dq,
            flash_bwd.launches_fused) == before
