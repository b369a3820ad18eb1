"""The port's packed varlen attention (flash_attn_tpu_torch) against the JAX
package on the same numpy inputs, on the CPU: the padding utilities, the
per-token varlen metadata, ``flash_attn_varlen_func`` (out, lse and
gradients), its packed forms, ``get_scheduler_metadata``, rotary over
packed sequences and the packed ``MHA``. The port runs its kernels' plain
versions, JAX its Pallas kernels in interpret mode. The CUDA kernels are
held against their plain versions on the card (tests/test_torch_package.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu import flash_attn_kvpacked_func as jax_kvpacked
from flash_attn_tpu import flash_attn_qkvpacked_func as jax_qkvpacked
from flash_attn_tpu import flash_attn_varlen_func as jax_varlen
from flash_attn_tpu import flash_attn_varlen_kvpacked_func as jax_varlen_kvpacked
from flash_attn_tpu import flash_attn_varlen_qkvpacked_func as jax_varlen_qkvpacked
from flash_attn_tpu.dispatch.scheduler_metadata import (
    get_scheduler_metadata as jax_scheduler_metadata,
)
from flash_attn_tpu.dispatch.varlen_meta import (
    compute_varlen_meta as jax_compute_varlen_meta,
)
from flash_attn_tpu.modules.mha import MHA as JaxMHA
from flash_attn_tpu.ops.rotary import apply_rotary_emb as jax_apply_rotary_emb
from flash_attn_tpu.utils import padding as jax_padding
from flash_attn_tpu_torch import (
    flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func,
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_varlen_qkvpacked_func,
    get_scheduler_metadata,
)
from flash_attn_tpu_torch.dispatch.varlen_meta import compute_varlen_meta
from flash_attn_tpu_torch.kernels import flash_varlen, flash_varlen_persistent
from flash_attn_tpu_torch.modules.mha import MHA
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb
from flash_attn_tpu_torch.utils import padding
from flash_attn_tpu_torch.utils.testing import (
    attention_ref,
    attention_varlen_ref,
    attention_varlen_ref_grads,
    check_against_ref,
    generate_random_padding_mask,
)

torch.set_num_threads(1)

# fp32 on both sides: the two differ only in summation order (one more
# order for the gradients, summed over a sequence's rows or keys).
TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _assert_lse(lse_t, lse_j):
    lse_t, lse_j = lse_t.numpy(), np.asarray(lse_j)
    np.testing.assert_array_equal(np.isneginf(lse_t), np.isneginf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], **TOL)


# ------------------------------ padding ---------------------------------


def test_unpad_and_pad_input_match_jax_exactly():
    rng = np.random.default_rng(0)
    x = _rand(rng, 4, 9, 3, 2)
    mask = np.arange(9)[None] < np.array([[9], [4], [0], [6]])
    unused = (np.arange(9)[None] < np.array([[9], [6], [2], [8]])) & ~mask
    for um in (None, unused):
        got = padding.unpad_input(_t(x), _t(mask),
                                  None if um is None else _t(um))
        want = jax_padding.unpad_input(jnp.asarray(x), jnp.asarray(mask),
                                       None if um is None else jnp.asarray(um))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        packed, idx = got[0], got[1]
        back = padding.pad_input(packed, idx, 4, 9)
        back_j = jax_padding.pad_input(want[0], want[1], 4, 9)
        np.testing.assert_array_equal(back.numpy(), np.asarray(back_j))
        rows = padding.index_first_axis(_t(x).reshape(36, 3, 2), idx)
        rows_j = jax_padding.index_first_axis(jnp.asarray(x).reshape(36, 3, 2),
                                              want[1])
        np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_j))


@pytest.mark.parametrize("max_segments", [None, 8])
def test_unpad_concatenated_sequences_matches_jax_exactly(max_segments):
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, 6, 2, 4)
    lens = np.array([[2, 3, 0, 0, 0, 0], [3, 2, 0, 0, 0, 0],
                     [6, 0, 0, 0, 0, 0]], np.int32)
    got = padding.unpad_input_for_concatenated_sequences(
        _t(x), _t(lens), max_segments)
    want = jax_padding.unpad_input_for_concatenated_sequences(
        jnp.asarray(x), jnp.asarray(lens), max_segments)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ------------------------------ metadata --------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_meta_token_vectors_match_jax(causal):
    """Per-token vectors equal JAX's (over the packed rows; JAX pads them to
    its tile grid), with seqused and a packed tail; the work lists cover
    every live row once, and the schedule is longest band first."""
    lens_q, lens_k = [70, 0, 130, 9], [50, 40, 200, 0]
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    used_q, used_k = np.array([70, 0, 100, 9], np.int32), \
        np.array([50, 1, 200, 0], np.int32)
    total_q, total_k = int(cu_q[-1]) + 30, int(cu_k[-1]) + 7
    meta = compute_varlen_meta(_t(cu_q), _t(cu_k), 130, 200, total_q, total_k,
                               causal=causal, seqused_q=_t(used_q),
                               seqused_k=_t(used_k))
    jm = jax_compute_varlen_meta(
        jnp.asarray(cu_q), jnp.asarray(cu_k), 64, 64, -(-total_q // 64),
        -(-total_k // 64), causal=causal, window_left=None,
        window_right=None, seqused_q=jnp.asarray(used_q),
        seqused_k=jnp.asarray(used_k))
    for name, n in (("seg_q", total_q), ("pos_q", total_q), ("seg_k", total_k),
                    ("pos_k", total_k), ("sq_of_q", total_q),
                    ("sk_of_q", total_q)):
        np.testing.assert_array_equal(getattr(meta, name).numpy(),
                                      np.asarray(getattr(jm, name))[:n], name)
    rows = [(s, r) for s, r0 in meta.q_tiles.tolist() if s >= 0
            for r in range(r0, min(r0 + 64, int(used_q[s])))]
    assert rows == [(s, r) for s in range(4) for r in range(used_q[s])]
    keys = [(s, r) for s, r0 in meta.k_tiles.tolist() if s >= 0
            for r in range(r0, min(r0 + 64, int(used_k[s])))]
    assert keys == [(s, r) for s in range(4) for r in range(used_k[s])]
    assert sorted(meta.schedule.tolist()) == sorted(meta.q_tiles.tolist())
    live = meta.schedule[meta.schedule[:, 0] >= 0]
    bands = [-(-int(used_k[s]) // 64) if not causal else max(0, min(
        -(-int(used_k[s]) // 64),
        (min(r0 + 64, int(used_q[s])) - 1 + int(used_k[s] - used_q[s])) // 64
        + 1)) for s, r0 in live.tolist()]
    assert bands == sorted(bands, reverse=True)


# ------------------------------ attention -------------------------------

# (name, lens_q, lens_k, seqused_q, seqused_k, tail rows, h, h_k, d, causal):
# a zero-length sequence and unpad_input's packed tail; sq != sk under the
# causal shift with GQA at d=128; seqused_q/k inside padded slots; a
# sequence with no keys.
CASES = [
    ("tail", [100, 0, 70, 130], None, None, None, 20, 4, 4, 64, False),
    ("gqa_shift", [90, 64, 33], [120, 64, 20], None, None, 0, 4, 2, 128,
     True),
    ("seqused", [80, 80, 80], None, [80, 50, 0], [60, 80, 10], 0, 2, 2, 64,
     True),
    ("no_keys", [40, 75], [0, 90], None, [0, 70], 5, 4, 2, 128, False),
]


def _case_inputs(case, seed=0):
    _, lens_q, lens_k, used_q, used_k, tail, h, h_k, d, causal = case
    lens_k = lens_k or lens_q
    rng = np.random.default_rng(seed)
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    tq, tk = int(cu_q[-1]) + tail, int(cu_k[-1]) + tail
    q, k, v = _rand(rng, tq, h, d), _rand(rng, tk, h_k, d), _rand(rng, tk, h_k, d)
    g = _rand(rng, tq, h, d)
    extra = {}
    if used_q is not None:
        extra["seqused_q"] = np.array(used_q, np.int32)
    if used_k is not None:
        extra["seqused_k"] = np.array(used_k, np.int32)
    args = (cu_q, cu_k, max(lens_q), max(lens_k))
    return (q, k, v, g), args, extra, causal


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_varlen_func_out_lse_and_grads_match_jax(case):
    (q, k, v, g), (cu_q, cu_k, mq, mk), extra, causal = _case_inputs(case)

    def jfn(q_, k_, v_):
        out, lse, _ = jax_varlen(q_, k_, v_, jnp.asarray(cu_q),
                                 jnp.asarray(cu_k), mq, mk, causal=causal,
                                 return_attn_probs=True,
                                 **{n: jnp.asarray(x) for n, x in extra.items()})
        return out, lse

    (out_j, lse_j), vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
    grads_j = vjp((jnp.asarray(g), jnp.zeros_like(lse_j)))

    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out_t, lse_t, none = flash_attn_varlen_func(
        *leaves, _t(cu_q), _t(cu_k), mq, mk, causal=causal,
        return_attn_probs=True, **{n: _t(x) for n, x in extra.items()})
    assert none is None and out_t.shape == q.shape
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    out_t.backward(_t(g))
    for name, leaf, gj in zip("qkv", leaves, grads_j):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gj),
                                   err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("case", [CASES[1], CASES[3]], ids=["gqa_shift",
                                                              "no_keys"])
def test_varlen_bf16_two_times_rule(case):
    """bf16 inputs through the port against the fp32 per-sequence
    reference: out within 2x the bf16 reference's error, gradients within
    3x (+1e-4), as tests/test_flash_attn_varlen.py holds JAX."""
    (q, k, v, g), (cu_q, cu_k, mq, mk), extra, causal = _case_inputs(case, 3)
    qb, kb, vb, gb = (_t(x).to(torch.bfloat16) for x in (q, k, v, g))
    cq, ck = _t(cu_q), _t(cu_k)
    used = {n: _t(x) for n, x in extra.items()}
    su = (used.get("seqused_q"), used.get("seqused_k"))
    leaves = [x.clone().requires_grad_() for x in (qb, kb, vb)]
    out = flash_attn_varlen_func(*leaves, cq, ck, mq, mk, causal=causal,
                                 **used)
    assert out.dtype == torch.bfloat16
    ref = attention_varlen_ref(qb, kb, vb, cq, ck, *su, causal=causal)
    ref_lp = attention_varlen_ref(qb, kb, vb, cq, ck, *su, causal=causal,
                                  upcast=False)
    check_against_ref(out, ref, ref_lp, msg="varlen bf16")
    out.backward(gb)
    refs = attention_varlen_ref_grads(qb.float(), kb.float(), vb.float(),
                                      gb.float(), cq, ck, *su, causal=causal)
    lps = attention_varlen_ref_grads(qb, kb, vb, gb, cq, ck, *su,
                                     causal=causal, upcast=False)
    for name, leaf, r, lp in zip("qkv", leaves, refs, lps):
        check_against_ref(leaf.grad, r, lp, mult=3.0, atol=1e-4,
                          msg=f"varlen bf16 d{name}")


def test_padded_batch_through_unpad_matches_masked_reference():
    """unpad_input -> flash_attn_varlen_func -> pad_input equals attention
    with query and key padding masks (the reference's varlen suite)."""
    rng = np.random.default_rng(5)
    b, s, h, d = 3, 70, 2, 64
    q, k, v = (_t(_rand(rng, b, s, h, d)) for _ in range(3))
    qmask = generate_random_padding_mask(s, b, rng, mode="third")
    kmask = generate_random_padding_mask(s, b, rng, mode="third")
    q_un, idx_q, cu_q, msq, _ = padding.unpad_input(q, qmask)
    k_un, _, cu_k, msk, _ = padding.unpad_input(k, kmask)
    v_un, _, _, _, _ = padding.unpad_input(v, kmask)
    for causal in (False, True):
        out = padding.pad_input(flash_attn_varlen_func(
            q_un, k_un, v_un, cu_q, cu_k, msq, msk, causal=causal), idx_q, b, s)
        ref, _ = attention_ref(q, k, v, kmask, causal=causal,
                               query_padding_mask=qmask)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_packed_forms_match_jax():
    rng = np.random.default_rng(6)
    lens = [33, 0, 64]
    cu, tot, h, d = _cu(lens), sum(lens) + 3, 2, 64
    qkv = _rand(rng, tot, 3, h, d)
    out_j = jax_varlen_qkvpacked(jnp.asarray(qkv), jnp.asarray(cu), 64,
                                 causal=True)
    out_t = flash_attn_varlen_qkvpacked_func(_t(qkv), _t(cu), 64, causal=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    q, kv = qkv[:, 0], qkv[:, 1:]
    out_j = jax_varlen_kvpacked(jnp.asarray(q), jnp.asarray(kv),
                                jnp.asarray(cu), jnp.asarray(cu), 64, 64)
    out_t = flash_attn_varlen_kvpacked_func(_t(q), _t(kv), _t(cu), _t(cu),
                                            64, 64)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    dense = _rand(rng, 2, 40, 3, h, d)
    out_j = jax_qkvpacked(jnp.asarray(dense), causal=True)
    out_t = flash_attn_qkvpacked_func(_t(dense), causal=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    out_j = jax_kvpacked(jnp.asarray(dense[:, :, 0]), jnp.asarray(dense[:, :, 1:]))
    out_t = flash_attn_kvpacked_func(_t(dense[:, :, 0]), _t(dense[:, :, 1:]))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_scheduler_metadata_matches_jax_and_gives_the_same_result():
    """get_scheduler_metadata: JAX's per-token vectors, and the same bits
    from flash_attn_varlen_func with and without it."""
    (q, k, v, g), (cu_q, cu_k, mq, mk), _, causal = _case_inputs(CASES[0])
    b = len(cu_q) - 1
    md = get_scheduler_metadata(b, mq, mk, 4, 4, 64, cu_seqlens_q=_t(cu_q),
                                cu_seqlens_k=_t(cu_k), causal=causal)
    jmd = jax_scheduler_metadata(b, mq, mk, 4, 4, 64,
                                 cu_seqlens_q=jnp.asarray(cu_q),
                                 cu_seqlens_k=jnp.asarray(cu_k), causal=causal)
    n = b * mq
    for name in ("seg_q", "pos_q", "sq_of_q", "sk_of_q"):
        np.testing.assert_array_equal(getattr(md.meta, name).numpy(),
                                      np.asarray(getattr(jmd.meta, name))[:n])
    assert (md.block_q, md.block_k) == (64, 64)
    args = (_t(cu_q), _t(cu_k), mq, mk)
    qt, kt, vt = _t(q[:n]), _t(k[:n]), _t(v[:n])
    with_md = flash_attn_varlen_func(qt, kt, vt, *args, causal=causal,
                                     scheduler_metadata=md)
    without = flash_attn_varlen_func(qt, kt, vt, *args, causal=causal)
    assert torch.equal(with_md, without)


def test_scheduler_metadata_device_is_explicit():
    """Without cu_seqlens_q the metadata is built on ``device`` (the card
    by default, raising without one); flash_attn_varlen_func refuses
    metadata that is not on q's device instead of handing its host
    pointers to a kernel."""
    md = get_scheduler_metadata(2, 32, 32, 4, 4, 64, causal=True,
                                device="cpu")
    assert all(t.device.type == "cpu" for t in md.meta)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_scheduler_metadata(2, 32, 32, 4, 4, 64)
    rng = np.random.default_rng(2)
    q, k, v = (_t(rng.standard_normal((64, 4, 64)).astype(np.float32))
               for _ in range(3))
    cu = torch.tensor([0, 32, 64], dtype=torch.int32)
    with_md = flash_attn_varlen_func(q, k, v, cu, cu, 32, 32, causal=True,
                                     scheduler_metadata=md)
    assert torch.equal(with_md, flash_attn_varlen_func(
        q, k, v, cu, cu, 32, 32, causal=True))
    away = md._replace(meta=md.meta._replace(
        q_tiles=md.meta.q_tiles.to("meta")))
    with pytest.raises(ValueError, match="q_tiles"):
        flash_attn_varlen_func(q, k, v, cu, cu, 32, 32, causal=True,
                               scheduler_metadata=away)


@pytest.mark.parametrize("causal", [False, True])
def test_persistent_plain_equals_banded_plain(causal):
    """The persistent kernel's walk (tile by tile, longest band first)
    computes what the per-sequence plain forward does."""
    (q, k, v, _), (cu_q, cu_k, mq, mk), extra, _ = _case_inputs(CASES[2], 7)
    args = (_t(q), _t(k), _t(v), _t(cu_q), _t(cu_k), mq, mk,
            _t(extra["seqused_q"]), _t(extra["seqused_k"]))
    out_b, lse_b = flash_varlen.flash_attention_varlen_fwd_plain(
        *args, causal=causal)
    out_p, lse_p = flash_varlen_persistent.flash_attention_varlen_fwd_persistent_plain(
        *args, causal=causal)
    np.testing.assert_allclose(out_p.numpy(), out_b.numpy(), atol=1e-6,
                               rtol=1e-6)
    _assert_lse(lse_p, lse_b.numpy())


@pytest.mark.parametrize("kwargs", [
    dict(alibi_slopes=torch.ones(2)), dict(window_size=(8, 0)),
    dict(softcap=5.0), dict(dropout_p=0.1), dict(attention_chunk=16),
    dict(learnable_sink=torch.zeros(2)), dict(qv=torch.ones(1)),
    dict(q_descale=torch.ones(1, 2))])
def test_varlen_refusals_name_queue_a_7(kwargs):
    q = torch.zeros(8, 2, 64)
    cu = torch.tensor([0, 8], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_attn_varlen_func(q, q, q, cu, cu, 8, 8, **kwargs)


# ------------------------- rotary and MHA -------------------------------


@pytest.mark.parametrize("interleaved", [False, True])
def test_packed_rotary_matches_jax(interleaved):
    """Positions restart at each sequence; the packed tail takes the last
    sequence's continued positions, clamped to the table, as in JAX."""
    rng = np.random.default_rng(8)
    cu = _cu([5, 0, 12, 3])
    x = _rand(rng, 26, 2, 16)
    cos, sin = _rand(rng, 12, 6), _rand(rng, 12, 6)
    out_j = jax_apply_rotary_emb(jnp.asarray(x), jnp.asarray(cos),
                                 jnp.asarray(sin), interleaved,
                                 cu_seqlens=jnp.asarray(cu), max_seqlen=12)
    out_t = apply_rotary_emb(_t(x), _t(cos), _t(sin), interleaved,
                             cu_seqlens=_t(cu), max_seqlen=12)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_packed_mha_with_rotary_matches_jax():
    rng = np.random.default_rng(9)
    kw = dict(num_heads=4, num_heads_kv=2, causal=True, rotary_emb_dim=8)
    jm = JaxMHA(embed_dim=64, dtype=jnp.float32, **kw)
    tm = MHA(64, dtype=torch.float32, device="cpu", **kw)
    cu = _cu([30, 0, 47])
    x = _rand(rng, 80, 64)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     cu_seqlens=jnp.asarray(cu), max_seqlen=47)["params"]
    with torch.no_grad():
        for lin, name in ((tm.Wqkv, "Wqkv"), (tm.out_proj, "out_proj")):
            lin.weight.copy_(_t(params[name]["kernel"]).T)
            lin.bias.copy_(_t(params[name]["bias"]))
    out_j = jm.apply({"params": params}, jnp.asarray(x),
                     cu_seqlens=jnp.asarray(cu), max_seqlen=47)
    with torch.no_grad():
        out_t = tm(_t(x), cu_seqlens=_t(cu), max_seqlen=47)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
