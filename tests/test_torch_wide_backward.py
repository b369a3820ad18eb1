"""Training at head dims 80 (BTLM-3B-8K), 96 (GPT-NeoX-20B) and 256
(GPT-J): the port's
gradients against the JAX package's on the same numpy inputs, on the CPU in
fp32. The port runs the plain versions of its backward kernels (B3 and B2
through flash_attn_func, B6 and B7 through flash_attn_varlen_func and the
packed MHA); JAX runs its Pallas kernels in interpret mode, through
jax.grad / jax.vjp. The two differ only in summation order: gradients at
atol/rtol 1e-4 (sums over up to 256 columns and 70 keys of unit-scale
products), outputs at 2e-5 / 1e-5. The case sq = sk = 1 under causal
masking is left out: JAX's dv there is not the group's sum of dO (ROADMAP
queue C), as tests/test_torch_backward.py leaves it out too.

One training step of each family's shape is in
tests/test_torch_wide_training.py; ALiBi, the cap and the band at 80, and a
tiny BTLM's Trainer, are in tests/test_torch_head_dim_80.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu import flash_attn_varlen_func as jax_varlen
from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu.modules.mha import MHA as JaxMHA
from flash_attn_tpu_torch import flash_attn_func, flash_attn_varlen_func
from flash_attn_tpu_torch.modules.mha import MHA

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


# (sq, sk, h, h_k, causal): GQA 2/1 with sq < sk under the causal shift,
# sq > sk (the first rows see no key), non-causal; key counts that are not
# a multiple of the kernels' 64-key tile.
FUNC_CASES = [(37, 70, 2, 1, True), (70, 37, 2, 2, True),
              (48, 48, 2, 1, False)]


@pytest.mark.parametrize("sq, sk, h, h_k, causal", FUNC_CASES)
@pytest.mark.parametrize("d", [80, 96, 256])
def test_flash_attn_func_grads_match_jax(d, sq, sk, h, h_k, causal):
    """dq, dk, dv of flash_attn_func at 80, 96 and 256, deterministic (B3) and
    not (B2), against jax.grad of JAX's flash_attn_func."""
    rng = np.random.default_rng(d + sq)
    q, k, v = _rand(rng, 2, sq, h, d), _rand(rng, 2, sk, h_k, d), \
        _rand(rng, 2, sk, h_k, d)
    g = _rand(rng, 2, sq, h, d)

    def loss(q_, k_, v_):
        return (jax_flash_attn_func(q_, k_, v_, causal=causal) * g).sum()
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    for deterministic in (True, False):
        leaves = [_t(x).requires_grad_() for x in (q, k, v)]
        out = flash_attn_func(*leaves, causal=causal,
                              deterministic=deterministic)
        (out * _t(g)).sum().backward()
        for name, leaf, ref in zip("qkv", leaves, want):
            np.testing.assert_allclose(
                leaf.grad.numpy(), np.asarray(ref), **GRAD_TOL,
                err_msg=f"d{name} deterministic={deterministic}")


@pytest.mark.parametrize("d, causal", [(96, True), (256, False)])
def test_varlen_func_grads_match_jax(d, causal):
    """The dense flash_attn_varlen_func (B7 forward, B6 backward) at 96 and
    256: out and dq, dk, dv against jax.vjp of JAX's, with a zero-length
    sequence, sq != sk and GQA 2/1 (at 80 under ALiBi and the cap in
    tests/test_torch_head_dim_80.py)."""
    rng = np.random.default_rng(d)
    lens_q, lens_k = [40, 0, 70], [55, 10, 70]
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    q = _rand(rng, int(cu_q[-1]), 2, d)
    k, v = _rand(rng, int(cu_k[-1]), 1, d), _rand(rng, int(cu_k[-1]), 1, d)
    g = _rand(rng, *q.shape)

    def jfn(q_, k_, v_):
        out, lse, _ = jax_varlen(q_, k_, v_, jnp.asarray(cu_q),
                                 jnp.asarray(cu_k), 70, 70, causal=causal,
                                 return_attn_probs=True)
        return out, lse
    (out_j, lse_j), vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    grads_j = vjp((jnp.asarray(g), jnp.zeros_like(lse_j)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out_t = flash_attn_varlen_func(*leaves, _t(cu_q), _t(cu_k), 70, 70,
                                   causal=causal)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    out_t.backward(_t(g))
    for name, leaf, gj in zip("qkv", leaves, grads_j):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gj),
                                   err_msg=f"d{name}", **GRAD_TOL)


# (embed_dim, heads, rotary dim, interleaved): GPT-J's head of 256 with
# interleaved rotary on 64 columns, GPT-NeoX-20B's of 96 with rotary on 24
# (BTLM-3B-8K's head of 80, under ALiBi, is in
# tests/test_torch_head_dim_80.py).
MHA_CASES = {256: (512, 2, 64, True), 96: (192, 2, 24, False)}


@pytest.mark.parametrize("d", [96, 256])
def test_packed_mha_grads_match_jax(d):
    """MHA on packed input (cu_seqlens) at 96 and 256 against JAX's MHA
    with cu_seqlens over the same weights: the output, and the gradients
    of a seeded projection of it with respect to x and every weight."""
    embed, heads, rot, interleaved = MHA_CASES[d]
    rng = np.random.default_rng(d + 1)
    kw = dict(num_heads=heads, causal=True, rotary_emb_dim=rot,
              rotary_emb_interleaved=interleaved)
    jm = JaxMHA(embed_dim=embed, dtype=jnp.float32, **kw)
    tm = MHA(embed, dtype=torch.float32, device="cpu", **kw)
    cu = _cu([30, 0, 47])
    x = _rand(rng, 80, embed)
    g = _rand(rng, 80, embed)
    qkv = 3 * heads * d
    params = {"Wqkv": {"kernel": _rand(rng, embed, qkv) / embed ** 0.5,
                       "bias": _rand(rng, qkv) * 0.02},
              "out_proj": {"kernel": _rand(rng, heads * d, embed) / embed ** 0.5,
                           "bias": _rand(rng, embed) * 0.02}}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    with torch.no_grad():
        for lin, name in ((tm.Wqkv, "Wqkv"), (tm.out_proj, "out_proj")):
            lin.weight.copy_(_t(params[name]["kernel"]).T)
            lin.bias.copy_(_t(params[name]["bias"]))

    def loss(p, x_):
        out = jm.apply({"params": p}, x_, cu_seqlens=jnp.asarray(cu),
                       max_seqlen=47)
        return (out * g).sum(), out
    (_, out_j), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    out_t = tm(xt, cu_seqlens=_t(cu), max_seqlen=47)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    (out_t * _t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    for lin, name in ((tm.Wqkv, "Wqkv"), (tm.out_proj, "out_proj")):
        np.testing.assert_allclose(lin.weight.grad.numpy().T,
                                   np.asarray(gp[name]["kernel"]),
                                   err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(lin.bias.grad.numpy(),
                                   np.asarray(gp[name]["bias"]),
                                   err_msg=name, **GRAD_TOL)
