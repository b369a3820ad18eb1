"""The port's training slice (flash_attn_tpu_torch: fused CE, optimizer,
Trainer, data pipeline) against the JAX package on the same numpy inputs,
on the CPU in fp32, at the tiny configuration of __graft_entry__.py."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _tiny_config
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.models.gpt import lm_head_weights as jax_lm_head_weights
from flash_attn_tpu.ops import cross_entropy as jax_ce
from flash_attn_tpu.training import data as jax_data
from flash_attn_tpu.training.trainer import TrainConfig as JaxTrainConfig
from flash_attn_tpu.training.trainer import Trainer as JaxTrainer
from flash_attn_tpu.training.trainer import (
    _stochastic_round_bf16 as jax_stochastic_round_bf16,
)
from flash_attn_tpu_torch.models.gpt import GPTConfig, jax_param_arrays
from flash_attn_tpu_torch.ops.cross_entropy import (
    cross_entropy_loss,
    fused_linear_cross_entropy,
)
from flash_attn_tpu_torch.training import data
from flash_attn_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    _stochastic_round_bf16,
    make_schedule,
    model_flops_per_token,
)

torch.set_num_threads(1)

JCFG = _tiny_config(dtype=jnp.float32)
CFG = GPTConfig(**{f.name: getattr(JCFG, f.name)
                   for f in dataclasses.fields(JCFG) if f.name != "dtype"},
                dtype=torch.float32)
# A short run of the tiny model: warmup 1 (so step 1 moves nothing, as
# optax's schedule(0) = 0) and a fused-CE chunk that does not divide the
# 2 x 64 tokens.
TRAIN = dict(batch_size=2, seqlen=64, lr=1e-2, warmup_steps=1,
             total_steps=10, zero1=False, fused_ce=True, fused_ce_chunk=48,
             log_every=1)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "tokens.bin"
    np.random.default_rng(0).integers(0, 512, 20_000, dtype=np.uint16).tofile(path)
    return str(path)


# -- (c) cross-entropy --------------------------------------------------------

CE_CASES = [
    dict(),
    dict(label_smoothing=0.1),
    dict(lse_square_scale=1e-3, logit_scale=0.5),
    dict(label_smoothing=0.2, lse_square_scale=1e-2, logit_scale=2.0),
]


@pytest.mark.parametrize("kw", CE_CASES)
@pytest.mark.parametrize("transpose_kernel", [True, False])
def test_fused_linear_cross_entropy_matches_jax(kw, transpose_kernel):
    rng = np.random.default_rng(0)
    n, d, vocab = 50, 32, 97               # chunk 16 does not divide 50
    hidden = rng.standard_normal((2, 25, d)).astype(np.float32)
    kernel = (rng.standard_normal((vocab, d) if transpose_kernel
                                  else (d, vocab)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 25)).astype(np.int32)
    labels[0, :5] = -100                   # ignore_index
    labels[1, 7] = -100

    def jloss(h, w):
        return jax_ce.fused_linear_cross_entropy(
            h, w, jnp.asarray(labels), transpose_kernel=transpose_kernel,
            chunk_size=16, **kw)

    loss_j, (dh_j, dw_j) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(kernel))
    h_t = torch.from_numpy(hidden).requires_grad_()
    w_t = torch.from_numpy(kernel).requires_grad_()
    loss_t = fused_linear_cross_entropy(
        h_t, w_t, torch.from_numpy(labels), transpose_kernel=transpose_kernel,
        chunk_size=16, **kw)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    np.testing.assert_allclose(h_t.grad.numpy(), np.asarray(dh_j), atol=1e-6)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(dw_j), atol=1e-6)
    assert n == hidden.shape[0] * hidden.shape[1]


@pytest.mark.parametrize("kw", CE_CASES)
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_loss_matches_jax(kw, reduction):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 11, 37)) * 3).astype(np.float32)
    labels = rng.integers(0, 37, (3, 11)).astype(np.int32)
    labels[2, 4:] = -100

    def jloss(z):
        out = jax_ce.cross_entropy_loss(z, jnp.asarray(labels),
                                        reduction=reduction, **kw)
        return out.sum(), out

    (_, out_j), dz_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    z_t = torch.from_numpy(logits).requires_grad_()
    out_t = cross_entropy_loss(z_t, torch.from_numpy(labels),
                               reduction=reduction, **kw)
    out_t.sum().backward()
    # fp32 logsumexp and sums in another order: a few ulps of losses ~10
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(z_t.grad.numpy(), np.asarray(dz_j), rtol=1e-5,
                               atol=1e-6)


# -- (d) stochastic rounding, (e) schedules ------------------------------------

def test_stochastic_round_bf16_bit_identical_to_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(50_000)
         * np.exp(rng.uniform(-40, 40, 50_000))).astype(np.float32)
    x[:5] = [np.inf, -np.inf, np.nan, 0.0, -0.0]
    for count in (1, 2, 1000, 2 ** 31 + 5):
        salt_mu = (count * 0x9E3779B9) & 0xFFFFFFFF
        for salt in (salt_mu, salt_mu ^ 0x5851F42D):
            want = np.asarray(jax_stochastic_round_bf16(
                jnp.asarray(x), jnp.uint32(salt)))
            got = _stochastic_round_bf16(torch.from_numpy(x), salt)
            bits_w = want.view(np.uint16)
            bits_g = got.view(torch.int16).numpy().view(np.uint16)
            # NaN payloads differ between the frameworks' casts; NaN stays NaN.
            nan = np.isnan(x)
            np.testing.assert_array_equal(bits_g[~nan], bits_w[~nan])
            assert torch.isnan(got[torch.from_numpy(nan)]).all()


def _optax_schedule(cfg):
    """trainer.py:212-234 of the JAX package, written out."""
    warm = optax.linear_schedule(0.0, cfg.lr, cfg.warmup_steps)
    tail = {
        "cosine": None,
        "linear": optax.linear_schedule(cfg.lr, cfg.lr * 0.1,
                                        cfg.total_steps - cfg.warmup_steps),
        "constant": optax.constant_schedule(cfg.lr),
        "step": optax.piecewise_constant_schedule(
            cfg.lr, {int(cfg.total_steps * 0.6): 0.1,
                     int(cfg.total_steps * 0.85): 0.1}),
    }[cfg.lr_schedule]
    if tail is None:
        return optax.warmup_cosine_decay_schedule(
            0.0, cfg.lr, cfg.warmup_steps, cfg.total_steps, cfg.lr * 0.1)
    return optax.join_schedules([warm, tail], [cfg.warmup_steps])


@pytest.mark.parametrize("name", ["cosine", "linear", "constant", "step"])
def test_lr_schedules_match_optax(name):
    cfg = TrainConfig(lr=3e-4, warmup_steps=7, total_steps=40,
                      lr_schedule=name)
    want, got = _optax_schedule(cfg), make_schedule(cfg)
    # optax computes in fp32, the port in Python floats
    for count in range(0, 50):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12, err_msg=str(count))
    assert got(0) == 0.0
    with pytest.raises(ValueError):
        make_schedule(dataclasses.replace(cfg, lr_schedule="exp"))


def test_model_flops_per_token_matches_jax():
    from flash_attn_tpu.training.trainer import (
        model_flops_per_token as jax_flops,
    )
    assert model_flops_per_token(CFG, 2048) == jax_flops(JCFG, 2048)


# -- (f) Trainer vs the JAX Trainer ------------------------------------------

def test_loss_grads_match_jax():
    """The whole slice's gradient (trunk -> fused lm_head + CE) in fp32."""
    jmodel = JaxGPTLMHeadModel(JCFG)
    rng = np.random.default_rng(6)
    batch = rng.integers(0, 512, (2, 33)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(batch[:, :-1]))["params"]

    def jloss(p):
        hidden = jmodel.apply({"params": p}, jnp.asarray(batch[:, :-1]),
                              method="forward_hidden")
        kernel, tr = jax_lm_head_weights(p, JCFG)
        return jax_ce.fused_linear_cross_entropy(
            hidden, kernel, jnp.asarray(batch[:, 1:]), transpose_kernel=tr,
            chunk_size=48)

    loss_j, grads_j = jax.value_and_grad(jloss)(params)
    tr = Trainer(TrainConfig(model=CFG, **TRAIN), device="cpu")
    tr.load_jax_params(_np_tree(params))
    loss_t, grads_t = tr._grads(torch.from_numpy(batch[:, :-1]).long(),
                                torch.from_numpy(batch[:, 1:]).long())
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    want = jax_param_arrays(tr.model, _np_tree(grads_j))
    for name, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=2e-6,
                                   err_msg=name)


def test_fused_and_full_logits_losses_agree():
    """fused_ce=False (full logits, cross_entropy_loss) takes the same loss
    and gradients as the fused chunked path."""
    b = torch.from_numpy(np.random.default_rng(9).integers(0, 512, (2, 65))).long()
    fused = Trainer(TrainConfig(model=CFG, **TRAIN), device="cpu")
    full = Trainer(TrainConfig(model=CFG, **dict(TRAIN, fused_ce=False)),
                   device="cpu")
    l1, g1 = fused._grads(b[:, :-1], b[:, 1:])
    l2, g2 = full._grads(b[:, :-1], b[:, 1:])
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for name, g in g1.items():
        torch.testing.assert_close(g2[name], g, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("opt_state_dtype", ["float32", "bfloat16"])
def test_trainer_matches_jax_trainer(opt_state_dtype):
    kw = dict(TRAIN, opt_state_dtype=opt_state_dtype)
    jtr = JaxTrainer(JaxTrainConfig(model=JCFG, **kw))
    tr = Trainer(TrainConfig(model=CFG, **kw), device="cpu")
    tr.load_jax_params(_np_tree(jtr.params))
    rng = np.random.default_rng(5)
    for step in range(4):
        b = rng.integers(0, 512, (2, 65)).astype(np.int32)
        out = jtr._step(jtr.params, jtr.opt_state, jnp.asarray(b[:, :-1]),
                        jnp.asarray(b[:, 1:]), jtr.ema_params, jtr.scaler)
        jtr.params, jtr.opt_state = out[0], out[1]
        loss, gnorm = tr.train_step(torch.from_numpy(b[:, :-1]).long(),
                                    torch.from_numpy(b[:, 1:]).long())
        np.testing.assert_allclose(float(loss), float(out[2]), rtol=1e-4)
        np.testing.assert_allclose(float(gnorm), float(out[3]), rtol=1e-4)
        if step == 0:  # warmup: schedule(0) = 0 moves nothing
            want = jax_param_arrays(tr.model, _np_tree(jtr.params))
            assert all(np.array_equal(tr.masters[n].numpy(), a)
                       for n, a in want.items())
    want = jax_param_arrays(tr.model, _np_tree(jtr.params))
    diffs = np.concatenate([np.abs(tr.masters[n].numpy() - a).ravel()
                            for n, a in want.items()])
    if opt_state_dtype == "float32":
        # fp32 all the way: summation order only (observed 1.6e-05 at
        # lr 1e-2 after 3 updates).
        assert diffs.max() <= 1e-4
    else:
        # bf16 moments: a last-bit difference in an fp32 moment changes the
        # hash's dither, so ~1/3 of the stochastically rounded moments land
        # one bf16 step apart; where a moment nearly cancels that is a large
        # relative change of its update. Bounded by a fifth of the LR per
        # element, and small on average.
        assert diffs.max() <= 0.2 * TRAIN["lr"] and diffs.mean() <= 1e-4


# -- (g) accumulation, (h) checkpoint resume ----------------------------------

def test_grad_accumulation_matches_full_batch():
    cfg = TrainConfig(model=CFG, **dict(TRAIN, batch_size=4))
    full = Trainer(cfg, device="cpu")
    acc = Trainer(dataclasses.replace(cfg, accumulate_steps=2), device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(3):
        b = torch.from_numpy(rng.integers(0, 512, (4, 65))).long()
        l1, g1 = full.train_step(b[:, :-1], b[:, 1:])
        l2, g2 = acc.train_step(b[:, :-1], b[:, 1:])
        # the mean over tokens equals the mean of the two halves' means
        # (equal token counts, nothing ignored)
        np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
        np.testing.assert_allclose(float(g2), float(g1), rtol=1e-5)
    for name, m in full.masters.items():
        torch.testing.assert_close(acc.masters[name], m, atol=1e-5, rtol=0)


def test_checkpoint_resume_is_exact(tmp_path, token_file):
    cfg = TrainConfig(model=CFG, **dict(TRAIN, seqlen=32, ckpt_dir=str(tmp_path),
                                        opt_state_dtype="bfloat16",
                                        ema_decay=0.9, log_every=100))

    def loader():
        return data.LMDataLoader(data.TokenDataset(token_file, seqlen=32), 2,
                                 data.FaultTolerantSampler(600, seed=3))

    straight = Trainer(cfg, device="cpu")
    straight.fit(loader(), steps=4)
    first = Trainer(cfg, device="cpu")
    first_loader = loader()
    first.fit(first_loader, steps=2)
    path = first.save_checkpoint(first_loader)
    resumed = Trainer(dataclasses.replace(cfg, seed=9), device="cpu")
    resumed_loader = loader()
    resumed.load_checkpoint(path, resumed_loader)
    assert resumed.step_count == 2
    resumed.fit(resumed_loader, steps=2)
    for name, m in straight.masters.items():
        assert torch.equal(resumed.masters[name], m), name
        assert torch.equal(resumed.ema[name], straight.ema[name]), name
        for key in ("mu", "nu"):
            assert torch.equal(resumed.opt_state[key][name],
                               straight.opt_state[key][name])
        assert torch.equal(resumed.params[name], straight.params[name])
    assert resumed.opt_state["count"] == straight.opt_state["count"] == 4


def test_fit_logs_and_evaluate(token_file):
    cfg = TrainConfig(model=CFG, **dict(TRAIN, seqlen=32, log_every=2))
    tr = Trainer(cfg, device="cpu")
    ds = data.TokenDataset(token_file, seqlen=32)
    logs = []
    tr.fit(data.LMDataLoader(ds, 2), steps=4, log_fn=logs.append,
           val_dataloader=data.LMDataLoader(ds, 2), eval_every=4, eval_steps=2)
    assert [m["step"] for m in logs if "loss" in m] == [2, 4]
    # the logged TFLOP/s is the logged rate times the model's flops a token,
    # within the two fields' own rounding (tflops_per_s to 0.01, as JAX's
    # trainer rounds it, tokens_per_s to 0.1): a slow host's step may round
    # it to 0.0, which says nothing of the program
    fpt = model_flops_per_token(cfg.model, cfg.seqlen) / 1e12
    for m in (m for m in logs if "loss" in m):
        assert math.isfinite(m["loss"]) and m["tokens_per_s"] > 0
        assert abs(m["tflops_per_s"] - m["tokens_per_s"] * fpt) \
            <= 0.005 + 0.05 * fpt
    assert [m["step"] for m in logs if "val_loss" in m] == [4]
    leaks = tr.causality_check(seqlen=16, splits=(1, 8))
    assert set(leaks) == {"causality_leak_1", "causality_leak_8"}
    assert max(leaks.values()) == 0.0


def test_loss_scaler_skips_non_finite_steps():
    tr = Trainer(TrainConfig(model=CFG, **dict(TRAIN, loss_scale_init=2.0 ** 130,
                                                 loss_scale_growth_interval=2)),
                 device="cpu")
    b = torch.from_numpy(np.random.default_rng(8).integers(0, 512, (2, 65))).long()
    before = {n: m.clone() for n, m in tr.masters.items()}
    _, gnorm = tr.train_step(b[:, :-1], b[:, 1:])   # scale overflows fp32
    assert not math.isfinite(float(gnorm))
    assert tr.scaler == {"scale": 2.0 ** 129, "good_steps": 0}
    assert tr.opt_state["count"] == 0
    assert all(torch.equal(tr.masters[n], m) for n, m in before.items())
    tr.scaler["scale"] = 4.0
    for expect in ({"scale": 4.0, "good_steps": 1}, {"scale": 8.0, "good_steps": 0}):
        _, gnorm = tr.train_step(b[:, :-1], b[:, 1:])
        assert math.isfinite(float(gnorm)) and tr.scaler == expect


def test_unported_training_options_raise():
    """Data, model and sequence parallelism still raise (queue A item 8);
    remat, once refused here too, is ported: a Trainer over
    GPTConfig(remat=True) builds and takes a step
    (tests/test_torch_remat_dwconv.py holds its gradients to JAX's)."""
    for key in ("data_parallel", "model_parallel", "seq_parallel"):
        with pytest.raises(NotImplementedError, match="queue A, item 8"):
            Trainer(TrainConfig(model=CFG, **{key: 2}), device="cpu")
    tr = Trainer(TrainConfig(model=dataclasses.replace(CFG, remat=True),
                             **{**TRAIN, "seqlen": 16}), device="cpu")
    assert tr.model.config.remat
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, 512, (2, 17)))
    loss, gnorm = tr.train_step(ids[:, :-1], ids[:, 1:])
    assert math.isfinite(float(loss)) and math.isfinite(float(gnorm))


# -- (i) the data pipeline ------------------------------------------------------

def test_data_pipeline_matches_jax_with_resume(token_file):
    def loaders(mod):
        ds = mod.TokenDataset(token_file, seqlen=48)
        return ds, mod.LMDataLoader(ds, 5, mod.FaultTolerantSampler(len(ds),
                                                                    seed=11))

    ds_j, lj = loaders(jax_data)
    ds_t, lt = loaders(data)
    assert ds_t._native is not None, "the port's native loader did not build"
    assert len(ds_t) == len(ds_j)
    it_j, it_t = iter(lj), iter(lt)
    for _ in range(90):   # past an epoch (416 samples / 5 a batch)
        (xj, yj), (xt, yt) = next(it_j), next(it_t)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
    assert lt.state_dict() == lj.state_dict() and lt.state_dict()["epoch"] == 1
    _, resumed = loaders(data)
    resumed.load_state_dict(lt.state_dict())
    it_r = iter(resumed)
    for _ in range(3):
        (xj, _), (xr, _) = next(it_j), next(it_r)
        np.testing.assert_array_equal(xr, xj)
    from flash_attn_tpu_torch.csrc import native_loader
    with pytest.raises(IndexError):
        native_loader.fill_batch(ds_t._native, np.array([10 ** 9]), 49,
                                 np.uint16)
