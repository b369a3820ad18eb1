"""Training through softcap and ALiBi: the port's Trainer and packed MHA
against the JAX package's on the same numpy inputs, on the CPU (the port's
plain kernel versions, JAX's Pallas kernels in interpret mode).

A Trainer on a tiny ALiBi GPT (no rotary, as Baichuan-13B) and on a tiny
softcap GPT against JAX's Trainer on the same config, 4 steps: the losses
and gradient norms at every step (rtol 1e-4) and the parameters after
(atol 1e-4), as tests/test_torch_band_varlen.py's windowed trainer; the
packed MHA (cu_seqlens) with each option against JAX's packed MHA: the
output (atol/rtol 1e-5) and the input's gradient (atol 1e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from flash_attn_tpu.modules.mha import MHA as JaxMHA
from flash_attn_tpu.training.trainer import TrainConfig as JaxTrainConfig
from flash_attn_tpu.training.trainer import Trainer as JaxTrainer
from flash_attn_tpu_torch.models.gpt import GPTConfig, jax_param_arrays
from flash_attn_tpu_torch.modules.mha import MHA
from flash_attn_tpu_torch.training.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=0)

# the score map of each scenario: ALiBi replaces rotary and the linear
# layers take no bias (Baichuan-13B's form: without rotary a key bias adds a
# constant to each row's scores, which softmax cancels, so its gradient is
# zero up to rounding and Adam's step on that noise compares nothing), the
# cap keeps the tiny GPT's rotary and biases (the 913M softcap GPT's form,
# Gemma-2's cap of 50 cut to 5 so that it bites at these widths)
SCORES = {"alibi": dict(use_alibi=True, rotary_emb_fraction=0.0,
                        qkv_proj_bias=False, out_proj_bias=False,
                        mlp_bias=False),
          "softcap": dict(softcap=5.0)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


@pytest.mark.parametrize("score", list(SCORES))
def test_score_trainer_matches_jax_trainer(score):
    """A Trainer on the tiny GPT with the score map against JAX's Trainer,
    4 steps over sequences of 64 tokens, fp32 optimizer state."""
    jcfg = dataclasses.replace(_tiny_config(dtype=jnp.float32),
                               **SCORES[score])
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
    rng = np.random.default_rng(20)
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


@pytest.mark.parametrize("score", list(SCORES))
def test_packed_score_mha_matches_jax(score):
    """The packed MHA (cu_seqlens, a zero-length sequence among them) with
    ALiBi or the cap against JAX's MHA on the same cu_seqlens: the output
    and the input's gradient (jax.grad)."""
    rng = np.random.default_rng(21)
    kw = dict(num_heads=4, num_heads_kv=2, causal=True)
    kw.update(dict(use_alibi=True) if score == "alibi" else
              dict(softcap=5.0, rotary_emb_dim=8))
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
