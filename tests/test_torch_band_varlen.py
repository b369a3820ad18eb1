"""The band masks on the port's packed varlen route and in training,
against the JAX package on the same numpy inputs, on the CPU: the port
runs the plain versions of its kernels (B7's forward, B6's backward, their
band instantiations on the card), JAX its Pallas kernels in interpret mode.

The dense ``flash_attn_varlen_func`` with a window and with a chunk on
ragged lengths (out and lse atol 1e-5, gradients 1e-4, fp32, as
tests/test_torch_varlen.py); ``get_scheduler_metadata(window_size=)``; the
packed ``MHA`` with a window against JAX's ``MHA`` on ``cu_seqlens``; a
``Trainer`` on a windowed config against JAX's ``Trainer`` for 4 steps,
over sequences longer than the window."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from flash_attn_tpu.dispatch.scheduler_metadata import (
    get_scheduler_metadata as jax_scheduler_metadata,
)
from flash_attn_tpu.interface import flash_attn_varlen_func as jax_varlen
from flash_attn_tpu.modules.mha import MHA as JaxMHA
from flash_attn_tpu.training.trainer import TrainConfig as JaxTrainConfig
from flash_attn_tpu.training.trainer import Trainer as JaxTrainer
from flash_attn_tpu_torch import flash_attn_varlen_func, get_scheduler_metadata
from flash_attn_tpu_torch.dispatch.config import normalize_window
from flash_attn_tpu_torch.kernels import flash_varlen
from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp
from flash_attn_tpu_torch.models.gpt import GPTConfig, jax_param_arrays
from flash_attn_tpu_torch.modules.mha import MHA
from flash_attn_tpu_torch.training.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=0)

# (name, lens_q, lens_k, causal, window, attention_chunk, h, h_k): ragged
# lengths with a zero-length sequence, sq != sk under the causal shift, GQA
CASES = [
    ("causal window", [40, 0, 70, 33], [40, 0, 70, 33], True, (9, 0), 0, 4,
     2),
    ("window both ways, sq != sk", [50, 21, 64], [30, 40, 64], False, (8, 5),
     0, 2, 2),
    ("chunk", [70, 33, 50], [70, 33, 50], True, (-1, -1), 16, 4, 2),
]


def _t(x):
    return torch.from_numpy(np.array(x))


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_varlen_band_out_lse_and_grads_match_jax(case):
    _, lens_q, lens_k, causal, window, chunk, h, h_k = case
    rng = np.random.default_rng(sum(lens_q) + chunk)
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    q, k, v = _rand(rng, tq, h, 32), _rand(rng, tk, h_k, 32), \
        _rand(rng, tk, h_k, 32)
    g = _rand(rng, tq, h, 32)
    band = dict(causal=causal, window_size=window, attention_chunk=chunk)
    args = (max(lens_q), max(lens_k))

    def jfn(q_, k_, v_):
        out, lse, _ = jax_varlen(q_, k_, v_, jnp.asarray(cu_q),
                                 jnp.asarray(cu_k), *args, **band,
                                 return_attn_probs=True)
        return out, lse

    (out_j, lse_j), vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    grads_j = vjp((jnp.asarray(g), jnp.zeros_like(lse_j)))

    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out_t, lse_t, _ = flash_attn_varlen_func(*leaves, _t(cu_q), _t(cu_k),
                                             *args, **band,
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
                                   err_msg=f"d{name}", **GRAD_TOL)
    # the persistent forward's plain walk (band tiles from their first key)
    # gives the B6 forward's plain result
    vargs = (_t(q), _t(k), _t(v), _t(cu_q), _t(cu_k), *args)
    kw = dict(causal=causal, window_size=normalize_window(window),
              attention_chunk=chunk)
    out_p, lse_p = fvp.flash_attention_varlen_fwd_persistent_plain(*vargs,
                                                                   **kw)
    out_b, lse_b = flash_varlen.flash_attention_varlen_fwd_plain(*vargs, **kw)
    torch.testing.assert_close(out_p, out_b, atol=1e-6, rtol=1e-6)
    assert torch.equal(torch.isfinite(lse_p), torch.isfinite(lse_b))


def test_scheduler_metadata_takes_a_window():
    """get_scheduler_metadata(window_size=) builds, as JAX's does (its
    per-token vectors equal JAX's); its lists hold the tiles of the lists
    without the window, the forward's schedule ordered by the window's
    bands (longest first); and flash_attn_varlen_func gives the same out
    and gradients with it as without it."""
    lens = [100, 20, 64, 130]
    cu = _cu(lens)
    b, ms, window = len(lens), max(lens), (15, 0)
    md = get_scheduler_metadata(b, ms, ms, 4, 2, 32, cu_seqlens_q=_t(cu),
                                cu_seqlens_k=_t(cu), causal=True,
                                window_size=window)
    plain = get_scheduler_metadata(b, ms, ms, 4, 2, 32, cu_seqlens_q=_t(cu),
                                   cu_seqlens_k=_t(cu), causal=True)
    jmd = jax_scheduler_metadata(b, ms, ms, 4, 2, 32,
                                 cu_seqlens_q=jnp.asarray(cu),
                                 cu_seqlens_k=jnp.asarray(cu), causal=True,
                                 window_size=window)
    n = int(cu[-1])
    for name in ("seg_q", "pos_q", "sq_of_q", "sk_of_q"):
        np.testing.assert_array_equal(getattr(md.meta, name).numpy()[:n],
                                      np.asarray(getattr(jmd.meta, name))[:n])
    for field in ("schedule", "k_schedule"):
        assert sorted(getattr(md.meta, field).tolist()) == sorted(
            getattr(plain.meta, field).tolist())
    # the forward's tiles of 128 rows: keys [max(0, r0 - 15), r_hi] (the
    # window's band in 64-key tiles), longest first
    bands = [(min(r0 + 128, lens[s]) - 1) // 64 - max(0, r0 - 15) // 64 + 1
             for s, r0 in md.meta.schedule.tolist() if s >= 0]
    assert bands == sorted(bands, reverse=True)
    rng = np.random.default_rng(6)
    x = [_t(_rand(rng, n, h, 32)) for h in (4, 2, 2)]
    grads = []
    for meta in (md, None):
        leaves = [t.clone().requires_grad_() for t in x]
        out = flash_attn_varlen_func(*leaves, _t(cu), _t(cu), ms, ms,
                                     causal=True, window_size=window,
                                     scheduler_metadata=meta)
        out.sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves])
    assert all(torch.equal(a, c) for a, c in zip(*grads))


def test_packed_mha_with_a_window_matches_jax():
    """The packed MHA (cu_seqlens) with a window of 12 against JAX's MHA on
    the same cu_seqlens: the output and the input's gradient (jax.grad)."""
    rng = np.random.default_rng(9)
    kw = dict(num_heads=4, num_heads_kv=2, causal=True, rotary_emb_dim=8,
              window_size=(12, 0))
    jm = JaxMHA(embed_dim=64, dtype=jnp.float32, **kw)
    tm = MHA(64, dtype=torch.float32, device="cpu", **kw)
    cu = _cu([30, 0, 47])
    x, g = _rand(rng, 77, 64), _rand(rng, 77, 64)
    # the parameters depend on the widths alone: a tiny dense input gives
    # the same ones without lowering the packed kernels for init
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8, 64), jnp.float32))["params"]
    tm.load_state_dict({n: _t(a) for n, a in tm.jax_param_arrays(
        jax.tree_util.tree_map(np.asarray, params)).items()})

    def jf(x_):
        out = jm.apply({"params": params}, x_, cu_seqlens=jnp.asarray(cu),
                       max_seqlen=47)
        return (out * g).sum(), out
    (_, out_j), dx_j = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    out_t = tm(xt, cu_seqlens=_t(cu), max_seqlen=47)
    out_t.backward(_t(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **GRAD_TOL)


def test_windowed_trainer_matches_jax_trainer():
    """A Trainer on the tiny GPT with window (15, 0) against JAX's Trainer
    on the same config, 4 steps over sequences of 64 tokens (past the
    window), fp32 optimizer state: the losses and gradient norms at every
    step, and the parameters after (as tests/test_torch_training.py's
    float32 case)."""
    jcfg = dataclasses.replace(_tiny_config(dtype=jnp.float32),
                               window_size=(15, 0))
    cfg = GPTConfig(**{f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(jcfg) if f.name != "dtype"},
                    dtype=torch.float32)
    train = dict(batch_size=2, seqlen=64, lr=1e-2, warmup_steps=1,
                 total_steps=10, zero1=False, fused_ce=True,
                 fused_ce_chunk=48, log_every=1, opt_state_dtype="float32")
    jtr = JaxTrainer(JaxTrainConfig(model=jcfg, **train))
    tr = Trainer(TrainConfig(model=cfg, **train), device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jtr.params)
    tr.load_jax_params(tree)
    rng = np.random.default_rng(15)
    for _ in range(4):
        b = rng.integers(0, 512, (2, 65)).astype(np.int32)
        out = jtr._step(jtr.params, jtr.opt_state, jnp.asarray(b[:, :-1]),
                        jnp.asarray(b[:, 1:]), jtr.ema_params, jtr.scaler)
        jtr.params, jtr.opt_state = out[0], out[1]
        loss, gnorm = tr.train_step(torch.from_numpy(b[:, :-1]).long(),
                                    torch.from_numpy(b[:, 1:]).long())
        np.testing.assert_allclose(float(loss), float(out[2]), rtol=1e-4)
        np.testing.assert_allclose(float(gnorm), float(out[3]), rtol=1e-4)
    want = jax_param_arrays(tr.model,
                            jax.tree_util.tree_map(np.asarray, jtr.params))
    diffs = np.concatenate([np.abs(tr.masters[n].numpy() - a).ravel()
                            for n, a in want.items()])
    assert diffs.max() <= 1e-4
