"""Activation rematerialization (GPTConfig.remat) and MHA's causal
depthwise conv (dwconv) of the port (flash_attn_tpu_torch) against the JAX
package on the same numpy inputs, on the CPU in fp32.

remat recomputes each block in the backward: on the CPU the port's loss and
gradients under either policy equal its own without remat bitwise (the
recompute runs the same ops on the same inputs), and JAX's remat=True
gradients within 1e-5 (the two differ in summation order). dwconv matches
JAX's MHA in train mode, in prefill then decode, and in the slot-mapped
padded prefill's state, at atol/rtol 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from __graft_entry__ import _tiny_config
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.modules.mha import MHA as JaxMHA
from flash_attn_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    jax_param_arrays,
    load_jax_params,
)
from flash_attn_tpu_torch.modules.mha import MHA, KVCache
from flash_attn_tpu_torch.training.trainer import TrainConfig, Trainer

from jax_paged_refs import one_page_tiles

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_paged_kernels_at_one_page_tiles():
    """JAX's paged kernels run at a KV tile of one page wherever its package
    calls them (tests/jax_paged_refs.py): the same functions, lowered
    faster."""
    with one_page_tiles():
        yield

TOL = dict(atol=1e-5, rtol=1e-5)
JCFG = _tiny_config(dtype=jnp.float32, vocab=128, embd=64)
CFG = GPTConfig(**{f.name: getattr(JCFG, f.name)
                   for f in dataclasses.fields(JCFG) if f.name != "dtype"},
                dtype=torch.float32)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- remat ---------------------------------------------------------------------

class _CountMatmuls(TorchDispatchMode):
    """Counts the aten.mm / aten.addmm calls dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _port_step(params, ids, **fields):
    """The port's loss and gradients (by parameter name) of one step on the
    JAX params, and the matmuls its backward dispatched."""
    model = GPTLMHeadModel(dataclasses.replace(CFG, **fields), device="cpu")
    load_jax_params(model, params)
    x = torch.from_numpy(ids).long()
    logits = model(x[:, :-1])
    loss = torch.nn.functional.cross_entropy(logits.flatten(0, 1),
                                             x[:, 1:].flatten())
    with _CountMatmuls() as count:
        loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, \
        count.n


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPTLMHeadModel(JCFG)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    ids = np.random.default_rng(0).integers(0, 128, (2, 33))
    return jax.tree_util.tree_map(np.asarray, params), ids


def test_remat_gradients_equal_the_step_without_remat(jax_params):
    """Under 'full' and 'dots' the loss and every gradient equal the step's
    without remat bitwise. 'dots' keeps the Dense products (aten.mm /
    addmm): its backward dispatches the matmuls of the step without remat
    and no more, while 'full' recomputes them (3 of a layer's 4: the
    recompute stops once what the backward saved is back, and nothing
    saves fc2's output)."""
    params, ids = jax_params
    loss0, grads0, mm0 = _port_step(params, ids)
    mms = {}
    for policy in ("full", "dots"):
        loss, grads, mms[policy] = _port_step(params, ids, remat=True,
                                              remat_policy=policy)
        assert torch.equal(loss, loss0), policy
        for name, g in grads.items():
            assert torch.equal(g, grads0[name]), (policy, name)
    assert mms["dots"] == mm0
    assert mms["full"] == mm0 + 3 * CFG.n_layer


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_match_jax(jax_params, policy):
    """The port's remat step against jax.grad of JAX's model with
    remat=True and the same policy, gradient by gradient."""
    params, ids = jax_params
    jmodel = JaxGPTLMHeadModel(dataclasses.replace(JCFG, remat=True,
                                                   remat_policy=policy))

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids[:, :-1]))
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.take_along_axis(logp, jnp.asarray(ids[:, 1:])[..., None],
                                    -1).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    model = GPTLMHeadModel(CFG, device="cpu")
    want = jax_param_arrays(model, jax.tree_util.tree_map(np.asarray,
                                                          jgrads))
    loss, grads, _ = _port_step(params, ids, remat=True, remat_policy=policy)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **TOL)


def test_trainer_with_remat_takes_the_steps_without_it():
    """A Trainer over GPTConfig(remat=True) ('dots') takes the same three
    steps (losses and updated masters bitwise) as one without remat."""
    ids = np.random.default_rng(1).integers(0, 128, (2, 33))
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        cfg = dataclasses.replace(CFG, remat=remat, remat_policy="dots")
        tr = Trainer(TrainConfig(model=cfg, batch_size=2, seqlen=32,
                                 lr=1e-2, warmup_steps=1, total_steps=10,
                                 zero1=False, fused_ce=True, log_every=1),
                     device="cpu")
        tr.model.reset_parameters(torch.Generator().manual_seed(0))
        tr.masters = {n: p.detach().float().clone()
                      for n, p in tr.model.named_parameters()}
        x = torch.from_numpy(ids).long()
        losses = [float(tr.train_step(x[:, :-1], x[:, 1:])[0])
                  for _ in range(3)]
        runs.append((losses, tr.masters))
    (l0, m0), (l1, m1) = runs
    assert l0 == l1 and all(np.isfinite(l0))
    assert all(torch.equal(m0[n], m1[n]) for n in m0)


# -- dwconv --------------------------------------------------------------------

MHA_KW = dict(num_heads=4, num_heads_kv=2, causal=True, rotary_emb_dim=8,
              max_decode_seqlen=40)


def _mha_pair(seed=0, **kw):
    """JAX's MHA(dwconv=True) with initialised params and the port's with
    the same weights, loaded through MHA.jax_param_arrays (the dwconv kernel
    from flax's (3, 1, C) to conv1d's (C, 1, 3))."""
    kw = {**MHA_KW, **kw}
    jm = JaxMHA(embed_dim=64, dwconv=True, dtype=jnp.float32, **kw)
    tm = MHA(64, dwconv=True, dtype=torch.float32, device="cpu", **kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 5, 64)))["params"]
    # a non-zero bias, so that its mapping is checked too
    params = {**params, "dwconv_bias": jnp.asarray(np.random.default_rng(
        seed).standard_normal(params["dwconv_bias"].shape) * 0.1,
        jnp.float32)}
    arrays = tm.jax_param_arrays(jax.tree_util.tree_map(np.asarray, params))
    assert arrays["dwconv_kernel"].shape == (tm.Wqkv.out_features, 1, 3)
    named = dict(tm.named_parameters())
    assert set(arrays) == set(named)
    with torch.no_grad():
        for name, arr in arrays.items():
            named[name].copy_(_t(arr))
    return jm, params, tm


def test_mha_dwconv_train_prefill_and_decode_match_jax():
    """Train mode, then a 5-token prefill and 4 decode steps against JAX's
    (outputs, caches and the conv state), and prefill + decode against the
    port's own train mode over the same tokens (JAX
    tests/test_models_misc.py:187)."""
    rng = np.random.default_rng(3)
    jm, params, tm = _mha_pair()
    x = _rand(rng, 2, 9, 64)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        train = tm(_t(x))
    np.testing.assert_allclose(train.numpy(), want, **TOL)

    cache = KVCache()
    out_j, state = jm.apply({"params": params}, jnp.asarray(x[:, :5]),
                            mode="prefill", mutable=["cache"])
    with torch.no_grad():
        outs = [tm(_t(x[:, :5]), mode="prefill", cache=cache)]
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(out_j), **TOL)
    for t in range(5, 9):
        out_j, state = jm.apply({"params": params, "cache": state["cache"]},
                                jnp.asarray(x[:, t:t + 1]), mode="decode",
                                mutable=["cache"])
        with torch.no_grad():
            outs.append(tm(_t(x[:, t:t + 1]), mode="decode", cache=cache))
        np.testing.assert_allclose(outs[-1].numpy(), np.asarray(out_j), **TOL)
    jc = state["cache"]
    np.testing.assert_allclose(cache.dwconv_state.numpy(),
                               np.asarray(jc["dwconv_state"]), **TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), train.numpy(),
                               atol=2e-5, rtol=0)


def test_mha_dwconv_slot_mapped_padded_prefill_matches_jax():
    """The engine's admission: a right-padded batch (true lengths 4 and 1)
    into slots (1, 0) of a preallocated cache keeps, in place, the last two
    pre-conv rows of each true length (zeros before the first token), and
    the decode step after it gives JAX's outputs."""
    rng = np.random.default_rng(4)
    jm, params, tm = _mha_pair(seed=1)
    x = _rand(rng, 2, 6, 64)
    lengths = np.array([4, 1], np.int32)
    slots = np.array([1, 0], np.int32)
    jcache = jax.tree_util.tree_map(jnp.zeros_like, jm.apply(
        {"params": params}, jnp.asarray(x), mode="prefill",
        mutable=["cache"])[1]["cache"])
    _, state = jm.apply({"params": params, "cache": jcache}, jnp.asarray(x),
                        mode="prefill", mutable=["cache"],
                        slot_ids=jnp.asarray(slots),
                        prefill_lengths=jnp.asarray(lengths))
    cache = tm.allocate_cache(2)
    ptr = cache.dwconv_state.data_ptr()
    with torch.no_grad():
        tm(_t(x), mode="prefill", cache=cache, slot_ids=_t(slots),
           prefill_lengths=_t(lengths))
    assert cache.dwconv_state.data_ptr() == ptr
    np.testing.assert_allclose(cache.dwconv_state.numpy(),
                               np.asarray(state["cache"]["dwconv_state"]),
                               **TOL)
    assert not cache.dwconv_state[0, 0].any()  # slot 0 held one token
    xt = _rand(rng, 2, 1, 64)
    out_j, _ = jm.apply({"params": params, "cache": state["cache"]},
                        jnp.asarray(xt), mode="decode", mutable=["cache"])
    with torch.no_grad():
        out_t = tm(_t(xt), mode="decode", cache=cache)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_mha_dwconv_refuses_packed_input_and_prefix_caching():
    """As JAX asserts: dwconv takes non-packed input only, and prefix
    caching with dwconv is unsupported."""
    tm = MHA(64, dwconv=True, dtype=torch.float32, device="cpu",
             paged_kv_num_pages=8, paged_kv_page_size=16, **MHA_KW)
    with pytest.raises(ValueError, match="non-packed"):
        tm(torch.zeros(6, 64), cu_seqlens=torch.tensor([0, 6],
                                                       dtype=torch.int32),
           max_seqlen=6)
    table = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="prefix caching"):
        tm(torch.zeros(1, 4, 64), mode="prefill", cache=tm.allocate_cache(1),
           block_table=table, prefix_lengths=torch.tensor([16]))
