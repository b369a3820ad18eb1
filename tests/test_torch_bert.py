"""The port's BERT encoder (flash_attn_tpu_torch.models.bert) against the
JAX package's on the same weights, in fp32 on the CPU: BertModel on masked
(packed, varlen attention) and unmasked (dense attention) input,
BertForMaskedLM with masked_positions, BertForPreTraining's MLM and NSP
logits, the gradients of an MLM loss against jax.grad, and the Hugging Face
checkpoint remap against JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import bert as jax_bert
from flash_attn_tpu_torch.models.bert import (
    BertConfig,
    BertForMaskedLM,
    BertForPreTraining,
    BertModel,
    bert_config_from_hf,
    bert_large,
    jax_param_arrays,
    load_jax_params,
    remap_state_dict_hf_bert,
)

torch.set_num_threads(1)

# fp32 on both sides through 2 layers: the projections, norms and attention
# sum in other orders (the GPT parity tests hold logits to the same bound).
TOL = dict(atol=1e-4, rtol=1e-4)
# Gradients of the summed MLM loss (a sum over 6 positions of a 128-way
# log-softmax) through the same 2 layers.
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)

SIZES = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=64)
B, S = 3, 40
LENGTHS = np.array([40, 17, 29])


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SIZES["vocab_size"], (B, S)).astype(np.int32)
    mask = np.arange(S)[None] < LENGTHS[:, None]
    types = (np.arange(S)[None] >= np.array([[20], [9], [14]])).astype(np.int32)
    pos = np.stack([rng.choice(n, 2, replace=False) for n in LENGTHS]
                   ).astype(np.int32)
    return ids, mask, types, pos


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def pretraining():
    jcfg = jax_bert.BertConfig(**SIZES)
    jmodel = jax_bert.BertForPreTraining(jcfg)
    # the parameters depend on the widths alone: the first 8 tokens of one
    # row, unmasked (the dense attention path), give the same ones without
    # lowering the packed kernels for init
    ids, _, types, pos = _inputs()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids[:1, :8]),
                         None, jnp.asarray(types[:1, :8]),
                         jnp.asarray(pos[:1] % 8))["params"]
    # flax initialises biases and norms to 0 / 1: move them so that the
    # parity covers them.
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), x.shape)
        if "bias" in str(path) or "norm" in str(path) else x, params)
    tmodel = BertForPreTraining(BertConfig(**SIZES), device="cpu")
    load_jax_params(tmodel, _tree(params))
    return jcfg, params, tmodel


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("masked", [True, False])
def test_bert_model_matches_jax(pretraining, masked):
    """Masked input packs and runs the varlen kernels; unmasked runs the
    dense forward; both give JAX's hidden states and pooled output."""
    jcfg, params, tmodel = pretraining
    ids, mask, types, _ = _inputs(1)
    jm = jax_bert.BertModel(jcfg, with_pooler=True)
    args = (ids, mask if masked else None, types)
    hid_j, pool_j = jm.apply({"params": params["bert"]},
                             *(None if a is None else jnp.asarray(a)
                               for a in args))
    with torch.no_grad():
        hid_t, pool_t = tmodel.bert(*(None if a is None else _t(a)
                                      for a in args))
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j), **TOL)
    np.testing.assert_allclose(pool_t.numpy(), np.asarray(pool_j), **TOL)


def test_masked_lm_with_positions_matches_jax(pretraining):
    jcfg, params, tmodel = pretraining
    mlm = BertForMaskedLM(BertConfig(**SIZES), device="cpu")
    tree = _tree({"bert": {k: v for k, v in params["bert"].items()
                           if k != "pooler"}, "cls": params["cls"]})
    load_jax_params(mlm, tree)
    ids, mask, types, pos = _inputs(2)
    args = [jnp.asarray(a) for a in (ids, mask, types, pos)]
    logits_j = jax_bert.BertForMaskedLM(jcfg).apply({"params": tree}, *args)
    with torch.no_grad():
        logits_t = mlm(*map(_t, (ids, mask, types, pos)))
        full_t = mlm(*map(_t, (ids, mask, types)))
    assert logits_t.dtype == torch.float32 and logits_t.shape == (B, 2, 128)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(
        logits_t.numpy(), np.take_along_axis(full_t.numpy(), pos[:, :, None],
                                             axis=1), atol=1e-5, rtol=1e-5)


def test_pretraining_logits_and_mlm_grads_match_jax(pretraining):
    """MLM + NSP logits, and the gradients of MLM + NSP cross-entropy with
    respect to every parameter, against jax.grad (the masked, packed path:
    the varlen backward)."""
    jcfg, params, tmodel = pretraining
    ids, mask, types, pos = _inputs(3)
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 128, pos.shape)
    nsp_labels = rng.integers(0, 2, (B,))
    jmodel = jax_bert.BertForPreTraining(jcfg)

    def loss_j(p):
        mlm, nsp = jmodel.apply({"params": p}, *map(jnp.asarray,
                                                    (ids, mask, types, pos)))
        lm = -jnp.take_along_axis(jax.nn.log_softmax(mlm), labels[..., None],
                                  -1).sum()
        ns = -jnp.take_along_axis(jax.nn.log_softmax(nsp),
                                  nsp_labels[:, None], -1).sum()
        return lm + ns, (mlm, nsp)

    (_, (mlm_j, nsp_j)), grads_j = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))(params)
    tmodel.zero_grad()
    mlm_t, nsp_t = tmodel(*map(_t, (ids, mask, types, pos)))
    np.testing.assert_allclose(mlm_t.detach().numpy(), np.asarray(mlm_j), **TOL)
    np.testing.assert_allclose(nsp_t.detach().numpy(), np.asarray(nsp_j), **TOL)
    loss = (torch.nn.functional.cross_entropy(
        mlm_t.flatten(0, 1), _t(labels).flatten().long(), reduction="sum")
        + torch.nn.functional.cross_entropy(nsp_t, _t(nsp_labels).long(),
                                            reduction="sum"))
    loss.backward()
    want = jax_param_arrays(tmodel, _tree(grads_j))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)


def test_packed_path_equals_per_row_dense(pretraining):
    """The reference's dual-path contract (tests/test_models_misc.py:12):
    each row alone, unmasked, through the dense kernel gives the packed
    path's valid hidden states; padded positions are what the packed tail
    computes."""
    _, _, tmodel = pretraining
    ids, mask, types, _ = _inputs(5)
    with torch.no_grad():
        hid, _ = tmodel.bert(_t(ids), _t(mask), _t(types))
        for i, n in enumerate(LENGTHS):
            ref, _ = tmodel.bert(_t(ids[i:i + 1, :n]), None,
                                 _t(types[i:i + 1, :n]))
            np.testing.assert_allclose(hid[i, :n].numpy(), ref[0].numpy(),
                                       atol=1e-5, rtol=1e-5)


def test_remap_hf_checkpoint_matches_jax():
    """remap_state_dict_hf_bert gives JAX's tree exactly, and the port
    loaded from it gives the Hugging Face model's logits."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=97, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=160,
        max_position_embeddings=64, type_vocab_size=2)
    torch.manual_seed(0)
    hf = transformers.BertForPreTraining(hf_cfg).eval()
    cfg = bert_config_from_hf(hf_cfg)
    jcfg = jax_bert.bert_config_from_hf(hf_cfg)
    assert dataclasses.asdict(cfg) == {**dataclasses.asdict(jcfg),
                                       "dtype": torch.float32}
    tree = remap_state_dict_hf_bert(hf.state_dict(), cfg)
    tree_j = jax_bert.remap_state_dict_hf_bert(hf.state_dict(), jcfg)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    flat_j = jax.tree_util.tree_leaves_with_path(tree_j)
    assert [p for p, _ in flat] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat, flat_j):
        np.testing.assert_array_equal(a, np.asarray(b), str(path))
    model = load_jax_params(BertForPreTraining(cfg, device="cpu"), tree)
    ids = torch.randint(0, 97, (2, 30))
    mask = torch.arange(30)[None] < torch.tensor([[30], [19]])
    with torch.no_grad():
        want = hf(ids, attention_mask=mask.long())
        mlm, nsp = model(ids, mask)
    for i, n in enumerate((30, 19)):
        np.testing.assert_allclose(mlm[i, :n].numpy(),
                                   want.prediction_logits[i, :n].numpy(),
                                   atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(nsp.numpy(),
                               want.seq_relationship_logits.numpy(),
                               atol=2e-4, rtol=2e-3)


def test_bert_large_config_and_entry_points_default_to_the_card():
    cfg = bert_large()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.vocab_size,
            cfg.max_position_embeddings, cfg.type_vocab_size,
            cfg.layer_norm_eps) == (1024, 24, 16, 4096, 30522, 512, 2, 1e-12)
    small = BertConfig(**SIZES)
    if torch.cuda.is_available():
        assert next(BertModel(small).parameters()).device.type == "cuda"
        return
    for cls in (BertModel, BertForMaskedLM, BertForPreTraining):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(small)
