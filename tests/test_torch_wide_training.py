"""One Trainer.train_step at head dims 96 (GPT-NeoX-20B) and 256 (GPT-J)
against the JAX package's Trainer from the same weights and batch, on the
CPU in fp32: a two-layer GPT-J-shaped model (heads of 256, parallel block
with one norm, interleaved rotary on a quarter of each head, untied head)
and a GPT-NeoX-shaped one (heads of 96, untied norms, rotary on a
quarter). The port runs the plain versions of its kernels (the forward B1,
the backward B3), JAX its Pallas kernels in interpret mode. Their
vocabulary, 200, is not a multiple of 128, as GPT-J's 50400 and
GPT-NeoX's 50432 are not: the fused CE's chunks end ragged.

The loss and the gradient norm agree at rtol 1e-4 (summation order). Adam's
first step moves each element by lr * m / (sqrt(v) + eps), about lr either
way: for an element whose gradient is within a few eps (1e-8) of zero, a
summation-order difference in it moves its update by a sizeable part of
lr (observed 0.125 lr at most, on 0.05% of the elements). So every updated
fp32 master is held within 0.2 lr of JAX's, their mean difference within
1e-6 (observed 1.4e-7), and every parameter must have moved."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.training.trainer import TrainConfig as JaxTrainConfig
from flash_attn_tpu.training.trainer import Trainer as JaxTrainer
from flash_attn_tpu_torch.models.gpt import GPTConfig, jax_param_arrays
from flash_attn_tpu_torch.training.trainer import TrainConfig, Trainer

torch.set_num_threads(1)


# Two-layer models of each family's shape, as the HF adapters configure
# them (tests/test_torch_wide_models.py's FAMILIES).
FAMILIES = {
    "gptj_256": dict(n_embd=512, n_head=2, rotary_emb_fraction=0.25,
                     rotary_emb_interleaved=True, activation="gelu_approx",
                     parallel_block=True, parallel_block_tied_norm=True,
                     qkv_proj_bias=False, out_proj_bias=False),
    "neox_96": dict(n_embd=192, n_head=2, rotary_emb_fraction=0.25,
                    activation="gelu", parallel_block=True,
                    parallel_block_tied_norm=False),
}
VOCAB = 200
TRAIN = dict(batch_size=2, seqlen=64, lr=1e-2, warmup_steps=0,
             total_steps=10, zero1=False, fused_ce=True, fused_ce_chunk=48,
             log_every=1, opt_state_dtype="float32")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_trainer_step_matches_jax_trainer(name):
    """Trainer.train_step of a two-layer model of the family's shape
    against JAX's Trainer step from the same weights and batch."""
    fields = dict(vocab_size=VOCAB, n_positions=0, n_layer=2, n_inner=256,
                  tie_word_embeddings=False, max_decode_seqlen=64,
                  **FAMILIES[name])
    jcfg = JaxGPTConfig(dtype=jnp.float32, **fields)
    cfg = GPTConfig(dtype=torch.float32, **fields)
    jtr = JaxTrainer(JaxTrainConfig(model=jcfg, **TRAIN))
    tr = Trainer(TrainConfig(model=cfg, **TRAIN), device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jtr.params)
    tr.load_jax_params(params)
    batch = np.random.default_rng(3).integers(0, VOCAB, (2, 65)).astype(
        np.int32)
    out = jtr._step(jtr.params, jtr.opt_state, jnp.asarray(batch[:, :-1]),
                    jnp.asarray(batch[:, 1:]), jtr.ema_params, jtr.scaler)
    loss, gnorm = tr.train_step(torch.from_numpy(batch[:, :-1]).long(),
                                torch.from_numpy(batch[:, 1:]).long())
    np.testing.assert_allclose(float(loss), float(out[2]), rtol=1e-4)
    np.testing.assert_allclose(float(gnorm), float(out[3]), rtol=1e-4)
    want = jax_param_arrays(tr.model, jax.tree_util.tree_map(np.asarray,
                                                             out[0]))
    before = jax_param_arrays(tr.model, params)
    diffs = []
    for n, a in want.items():
        got = tr.masters[n].numpy()
        assert not np.array_equal(got, before[n]), n  # it took an update
        diffs.append(np.abs(got - a).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 0.2 * TRAIN["lr"] and diffs.mean() <= 1e-6
