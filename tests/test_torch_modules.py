"""The port's ops and modules (flash_attn_tpu_torch) against the JAX
package's, in fp32 on the CPU, with the same numpy inputs and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.modules.mha import MHA as JaxMHA
from flash_attn_tpu.modules.mlp import GatedMlp as JaxGatedMlp
from flash_attn_tpu.modules.mlp import Mlp as JaxMlp
from flash_attn_tpu.ops import norm as jax_norm
from flash_attn_tpu.ops.rotary import apply_rotary_emb as jax_apply_rotary_emb
from flash_attn_tpu_torch.modules.mha import MHA, KVCache
from flash_attn_tpu_torch.modules.mlp import GatedMlp, Mlp
from flash_attn_tpu_torch.ops import norm
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb

torch.set_num_threads(1)

# fp32 on both sides; the norms and projections sum in another order.
TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _dense(lin, p):
    with torch.no_grad():
        lin.weight.copy_(_t(p["kernel"]).T)
        if lin.bias is not None:
            lin.bias.copy_(_t(p["bias"]))


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("offsets", ["int", "per_batch", "per_batch_past_end"])
def test_apply_rotary_emb_matches_jax(interleaved, offsets):
    """Per-row offsets with s > 1 are the prefix-cached prefill's (q and k
    rotated at each slot's prefix length); past the table's end both take
    its last row."""
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 7, 2, 32)
    cos, sin = _rand(rng, 40, 12), _rand(rng, 40, 12)  # rotary dim 24 < 32
    off = {"int": 5, "per_batch": np.array([0, 9, 33], np.int32),
           "per_batch_past_end": np.array([16, 0, 37], np.int32)}[offsets]
    out_j = jax_apply_rotary_emb(jnp.asarray(x), jnp.asarray(cos),
                                 jnp.asarray(sin), interleaved,
                                 seqlen_offsets=off if offsets == "int"
                                 else jnp.asarray(off))
    out_t = apply_rotary_emb(_t(x), _t(cos), _t(sin), interleaved,
                             seqlen_offsets=off if offsets == "int" else _t(off))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("residual", [None, "fp32"])
def test_norms_match_jax(kind, residual):
    rng = np.random.default_rng(1)
    x0, w, bias = _rand(rng, 2, 5, 48), _rand(rng, 48), _rand(rng, 48)
    res = None if residual is None else _rand(rng, 2, 5, 48)
    jfn = jax_norm.dropout_add_rms_norm if kind == "rms" \
        else jax_norm.dropout_add_layer_norm
    tfn = norm.dropout_add_rms_norm if kind == "rms" \
        else norm.dropout_add_layer_norm
    b = None if kind == "rms" else bias
    out_j, pre_j = jfn(jnp.asarray(x0), None if res is None else jnp.asarray(res),
                       jnp.asarray(w), None if b is None else jnp.asarray(b),
                       prenorm=True)
    out_t, pre_t = tfn(_t(x0), None if res is None else _t(res), _t(w),
                       None if b is None else _t(b), prenorm=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(pre_t.numpy(), np.asarray(pre_j), **TOL)
    plain_j = (jax_norm.rms_norm(jnp.asarray(x0), jnp.asarray(w)) if kind == "rms"
               else jax_norm.layer_norm(jnp.asarray(x0), jnp.asarray(w),
                                        jnp.asarray(bias)))
    plain_t = (norm.rms_norm(_t(x0), _t(w)) if kind == "rms"
               else norm.layer_norm(_t(x0), _t(w), _t(bias)))
    np.testing.assert_allclose(plain_t.numpy(), np.asarray(plain_j), **TOL)


def test_dropout_add_norm_rejects_dropout():
    x = torch.ones(2, 8)
    with pytest.raises(NotImplementedError):
        norm.dropout_add_rms_norm(x, None, torch.ones(8), dropout_p=0.1)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_jax(gated):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 5, 48)
    if gated:
        jm = JaxGatedMlp(hidden_features=100, multiple_of=32, dtype=jnp.float32)
        tm = GatedMlp(48, 100, multiple_of=32, dtype=torch.float32,
                      device="cpu")
    else:
        jm = JaxMlp(hidden_features=96, dtype=jnp.float32)
        tm = Mlp(48, 96, dtype=torch.float32, device="cpu")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    if gated:
        assert params["fc1"]["kernel"].shape == (48, 256)  # 100 -> 128, x2
    _dense(tm.fc1, params["fc1"])
    _dense(tm.fc2, params["fc2"])
    out_j = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out_t = tm(_t(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_mha_prefill_then_decode_matches_jax():
    rng = np.random.default_rng(3)
    kw = dict(num_heads=4, num_heads_kv=2, causal=True, rotary_emb_dim=8,
              max_decode_seqlen=40)
    jm = JaxMHA(embed_dim=64, dtype=jnp.float32, **kw)
    tm = MHA(64, dtype=torch.float32, device="cpu", **kw)
    x = _rand(rng, 2, 9, 64)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    _dense(tm.Wqkv, params["Wqkv"])
    _dense(tm.out_proj, params["out_proj"])

    cache = KVCache()
    out_j, state = jm.apply({"params": params}, jnp.asarray(x),
                            mode="prefill", mutable=["cache"])
    with torch.no_grad():
        out_t = tm(_t(x), mode="prefill", cache=cache)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    for _ in range(3):
        xt = _rand(rng, 2, 1, 64)
        out_j, state = jm.apply({"params": params, "cache": state["cache"]},
                                jnp.asarray(xt), mode="decode",
                                mutable=["cache"])
        with torch.no_grad():
            out_t = tm(_t(xt), mode="decode", cache=cache)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    jc = state["cache"]
    assert cache.k.shape == jc["k"].shape == (2, 2, 128, 16)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jc["v"]), **TOL)
    np.testing.assert_array_equal(cache.offset.numpy(), np.asarray(jc["offset"]))


def test_mha_prefill_into_preallocated_cache_keeps_its_tensors():
    """A prefill into a cache made up front (allocate_cache) writes the
    keys, values and offsets in place: the cache keeps its tensors (a
    captured decode graph reads them there), and prefill and decode give
    JAX's outputs, twice over the same cache."""
    rng = np.random.default_rng(4)
    kw = dict(num_heads=4, num_heads_kv=2, causal=True, rotary_emb_dim=8,
              max_decode_seqlen=40)
    jm = JaxMHA(embed_dim=64, dtype=jnp.float32, **kw)
    tm = MHA(64, dtype=torch.float32, device="cpu", **kw)
    params = jm.init(jax.random.PRNGKey(1),
                     jnp.asarray(_rand(rng, 2, 5, 64)))["params"]
    _dense(tm.Wqkv, params["Wqkv"])
    _dense(tm.out_proj, params["out_proj"])
    cache = tm.allocate_cache(2)
    ptrs = [t.data_ptr() for t in (cache.k, cache.v, cache.offset)]
    for s in (9, 6):  # the second prefill is shorter than the first
        x = _rand(rng, 2, s, 64)
        out_j, state = jm.apply({"params": params}, jnp.asarray(x),
                                mode="prefill", mutable=["cache"])
        with torch.no_grad():
            out_t = tm(_t(x), mode="prefill", cache=cache)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
        for _ in range(2):
            xt = _rand(rng, 2, 1, 64)
            out_j, state = jm.apply(
                {"params": params, "cache": state["cache"]}, jnp.asarray(xt),
                mode="decode", mutable=["cache"])
            with torch.no_grad():
                out_t = tm(_t(xt), mode="decode", cache=cache)
            np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                       **TOL)
        np.testing.assert_array_equal(cache.offset.numpy(),
                                      np.asarray(state["cache"]["offset"]))
        assert [t.data_ptr() for t in (cache.k, cache.v, cache.offset)] \
            == ptrs
