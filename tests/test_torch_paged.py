"""The port's paged-cache attention (flash_attn_tpu_torch) against the JAX
package on the same numpy inputs, in fp32 on the CPU: paged decode through
``flash_attn_with_kvcache``, the paged ``kv_cache_update``, the packed-
varlen prefill ``flash_attn_varlen_func(block_table=...)``, and the MHA and
GPT modules' slot-mapped, paged and prefix-cached prefill followed by
decode. The port runs its kernels' plain versions, JAX its Pallas kernels
in interpret mode. The kernels themselves are checked against their plain
versions on the card, in tests/test_torch_package.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.cache.kvcache import kv_cache_update as jax_kv_cache_update
from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.modules.mha import MHA as JaxMHA
from flash_attn_tpu_torch import flash_attn_varlen_func, flash_attn_with_kvcache
from flash_attn_tpu_torch.cache.kvcache import kv_cache_update
from flash_attn_tpu_torch.dispatch.varlen_meta import varlen_tiles
from flash_attn_tpu_torch.kernels import flash_varlen_paged
from flash_attn_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    load_jax_params,
)
from flash_attn_tpu_torch.modules.mha import MHA
from flash_attn_tpu_torch.utils.testing import (
    attention_varlen_paged_ref,
    paged_to_linear,
)

from jax_paged_refs import (
    jax_kvcache_paged,
    jax_varlen_paged,
    one_page_tiles,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_paged_kernels_at_one_page_tiles():
    """JAX's paged kernels run at a KV tile of one page wherever its package
    calls them (tests/jax_paged_refs.py): the same functions, lowered
    faster."""
    with one_page_tiles():
        yield

# fp32 on both sides: the two differ only in summation order (JAX's own
# paged-varlen test reports ~1e-6 for the same math).
TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 16


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_lse(lse_t, lse_j):
    lse_t, lse_j = lse_t.numpy(), np.asarray(lse_j)
    np.testing.assert_array_equal(np.isneginf(lse_t), np.isneginf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], **TOL)


def _rope(d, n=64):
    t = np.arange(n, dtype=np.float32)[:, None]
    inv = 1.0 / 10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d)
    return np.cos(t * inv), np.sin(t * inv)


# Three sequences over 12 pages of 16 with 4 table columns; unused columns
# point at the null page 0.
TABLE = np.array([[3, 0, 0, 0], [7, 1, 0, 0], [2, 9, 11, 0]], np.int32)


@pytest.mark.parametrize("num_splits", [1, 2])
def test_paged_decode_with_append_matches_jax(num_splits):
    rng = np.random.default_rng(0)
    b, h, h_k, d = 3, 4, 2, 64
    q = _rand(rng, b, 1, h, d)
    k_new, v_new = _rand(rng, b, 1, h_k, d), _rand(rng, b, 1, h_k, d)
    kp, vp = _rand(rng, 12, h_k, PAGE, d), _rand(rng, 12, h_k, PAGE, d)
    seqlens = np.array([5, 30, 47], np.int32)  # before the append
    cos, sin = _rope(d)
    out_j, kc_j, vc_j, _ = jax_kvcache_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(seqlens), jnp.asarray(TABLE), num_splits,
        k=jnp.asarray(k_new), v=jnp.asarray(v_new),
        rotary_cos=jnp.asarray(cos), rotary_sin=jnp.asarray(sin),
        causal=True)
    kp_t, vp_t = _t(kp), _t(vp)
    out_t = flash_attn_with_kvcache(
        _t(q), kp_t, vp_t, k=_t(k_new), v=_t(v_new), rotary_cos=_t(cos),
        rotary_sin=_t(sin), cache_seqlens=_t(seqlens), block_table=_t(TABLE),
        causal=True, num_splits=num_splits)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(kp_t.numpy(), np.asarray(kc_j), **TOL)
    np.testing.assert_allclose(vp_t.numpy(), np.asarray(vc_j), **TOL)


def test_paged_bounds_guard():
    """Lengths the host holds that overflow the table raise, as in JAX;
    cache_batch_idx with a block table raises ValueError, as in JAX."""
    q = torch.zeros(3, 1, 4, 64)
    kp = torch.zeros(12, 2, PAGE, 64)
    table = _t(TABLE)
    with pytest.raises(ValueError, match="capacity 64"):
        flash_attn_with_kvcache(q, kp, kp, cache_seqlens=65,
                                block_table=table)
    with pytest.raises(ValueError, match="cache_batch_idx"):
        flash_attn_with_kvcache(q, kp, kp, cache_seqlens=4, block_table=table,
                                cache_batch_idx=torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("s_new", [1, 9])
def test_paged_kv_cache_update_matches_jax(s_new):
    rng = np.random.default_rng(1)
    h_k, d = 2, 32
    kp, vp = _rand(rng, 12, h_k, PAGE, d), _rand(rng, 12, h_k, PAGE, d)
    k_new, v_new = _rand(rng, 3, s_new, h_k, d), _rand(rng, 3, s_new, h_k, d)
    offs = np.array([3, 15, 40], np.int32)
    lengths = np.array([s_new, 2, 0], np.int32)  # padded rows drop their tail
    kw = {} if s_new == 1 else {"new_lengths": lengths}
    kc_j, vc_j = jax_kv_cache_update(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(offs), block_table=jnp.asarray(TABLE),
        **{n: jnp.asarray(x) for n, x in kw.items()})
    kp_t, vp_t = _t(kp), _t(vp)
    kv_cache_update(kp_t, vp_t, _t(k_new), _t(v_new), _t(offs),
                    block_table=_t(TABLE), **{n: _t(x) for n, x in kw.items()})
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kc_j))
    np.testing.assert_array_equal(vp_t.numpy(), np.asarray(vc_j))


VARLEN_CASES = {
    # ragged chunks, one of length 0; causal; GQA 4/2
    "ragged": dict(lens_q=[5, 0, 17], lens_k=[20, 9, 17], h=4, h_k=2,
                   causal=True, seqused=None),
    # the padded-flat layout of the prefix path (3 slots of 8 rows, the true
    # lengths in seqused_q, one empty dummy row), not causal; the causal
    # padded-flat call is the MHA test's prefix prefill below
    "padded_flat": dict(lens_q=[8, 8, 8], lens_k=[24, 19, 0], h=2, h_k=2,
                        causal=False, seqused=[8, 3, 0]),
}


@pytest.mark.parametrize("case", list(VARLEN_CASES))
def test_varlen_paged_matches_jax(case):
    c = VARLEN_CASES[case]
    rng = np.random.default_rng(2)
    d = 64
    cu = np.concatenate([[0], np.cumsum(c["lens_q"])]).astype(np.int32)
    q = _rand(rng, int(cu[-1]), c["h"], d)
    kp, vp = _rand(rng, 12, c["h_k"], PAGE, d), _rand(rng, 12, c["h_k"], PAGE, d)
    lens_k = np.array(c["lens_k"], np.int32)
    seqused = None if c["seqused"] is None else np.array(c["seqused"], np.int32)
    max_q = max(c["lens_q"])
    out_j, lse_j = jax_varlen_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(cu),
        max_q, jnp.asarray(lens_k), jnp.asarray(TABLE), causal=c["causal"],
        seqused_q=None if seqused is None else jnp.asarray(seqused))
    out_t, lse_t = flash_attn_varlen_func(
        _t(q), _t(kp), _t(vp), _t(cu), None, max_q, 64, causal=c["causal"],
        block_table=_t(TABLE), seqused_k=_t(lens_k),
        seqused_q=None if seqused is None else _t(seqused),
        return_attn_probs=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t, lse_j)
    ref = attention_varlen_paged_ref(
        _t(q), _t(kp), _t(vp), _t(cu), _t(lens_k), _t(TABLE),
        seqused_q=None if seqused is None else _t(seqused), causal=c["causal"])
    np.testing.assert_allclose(out_t.numpy(), ref.numpy(), **TOL)


def test_varlen_refusals_point_at_queue_a():
    """Dense varlen (B6/B7, queue A item 5) is ported and runs; so is qv
    over a paged cache (B8p, the MLA chunked prefill), the window on both
    routes and attention_chunk on the dense one, while qv on the dense
    route, attention_chunk on the paged one, and descales on the dense
    route and with qv (B8p) are still item 7; descales run on the paged
    route without qv (B8: tests/test_torch_kvquant.py); softcap runs on the
    paged route (B8) and, with ALiBi, on the dense one (forward and
    backward)."""
    q = torch.zeros(4, 2, 64)
    cu = torch.tensor([0, 4], dtype=torch.int32)
    assert flash_attn_varlen_func(q, q, q, cu, cu, 4, 4).shape == q.shape
    kp = torch.zeros(12, 2, PAGE, 64)
    paged = dict(block_table=_t(TABLE[:1]), seqused_k=torch.tensor([4]))
    assert flash_attn_varlen_func(q, kp, kp, cu, None, 4, 64, qv=q,
                                  **paged).shape == q.shape
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_attn_varlen_func(q, q, q, cu, cu, 4, 4, qv=q)
    assert flash_attn_varlen_func(q, kp, kp, cu, None, 4, 64, **paged,
                                  softcap=5.0).shape == q.shape
    assert flash_attn_varlen_func(q, q, q, cu, cu, 4, 4,
                                  softcap=5.0).shape == q.shape
    descale = dict(k_descale=torch.ones(1, 2))
    assert flash_attn_varlen_func(q, kp, kp, cu, None, 4, 64, **paged,
                                  **descale).shape == q.shape
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_attn_varlen_func(q, kp, kp, cu, None, 4, 64, qv=q, **paged,
                               **descale)
    chunk = dict(attention_chunk=16)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_attn_varlen_func(q, kp, kp, cu, None, 4, 64, **paged, **chunk)
    # the dense route takes the chunk, not the descales
    assert flash_attn_varlen_func(q, q, q, cu, cu, 4, 4, causal=True,
                                  **chunk).shape == q.shape
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_attn_varlen_func(q, q, q, cu, cu, 4, 4, **descale)
    # the window: both routes take it (B8; B7 and B6)
    window = dict(window_size=(8, 0))
    assert flash_attn_varlen_func(q, kp, kp, cu, None, 4, 64, **paged,
                                  **window).shape == q.shape
    assert flash_attn_varlen_func(q, q, q, cu, cu, 4, 4,
                                  **window).shape == q.shape


def test_paged_to_linear_gathers_pages():
    kp = torch.arange(12 * PAGE, dtype=torch.float32).reshape(12, 1, PAGE, 1)
    lin = paged_to_linear(kp, _t(TABLE), torch.tensor([5, 30, 47]))
    assert lin.shape == (3, 1, 4 * PAGE, 1)
    pos = torch.arange(4 * PAGE)
    want = kp.flatten()[_t(TABLE).long()[:, pos // PAGE] * PAGE + pos % PAGE]
    want = want * (pos[None] < torch.tensor([[5], [30], [47]]))
    assert torch.equal(lin[:, 0, :, 0], want)


def _dense(lin, p):
    with torch.no_grad():
        lin.weight.copy_(_t(p["kernel"]).T)
        if lin.bias is not None:
            lin.bias.copy_(_t(p["bias"]))


def test_mha_slot_paged_and_prefix_prefill_then_decode_match_jax():
    """Slot-mapped paged prefill of a padded batch, a prefix-cached chunked
    prefill that shares the first slot's first page (with a zero-length
    dummy row), then two decode steps of every slot."""
    rng = np.random.default_rng(3)
    kw = dict(num_heads=4, num_heads_kv=2, causal=True, rotary_emb_dim=16,
              max_decode_seqlen=64, paged_kv_num_pages=12,
              paged_kv_page_size=PAGE)
    jm = JaxMHA(embed_dim=64, dtype=jnp.float32, **kw)
    tm = MHA(64, dtype=torch.float32, device="cpu", **kw)
    table = np.array([[4, 5, 0, 0], [4, 8, 9, 0], [2, 3, 0, 0], [0, 0, 0, 0]],
                     np.int32)
    x1 = _rand(rng, 2, 24, 64)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x1))["params"]
    _dense(tm.Wqkv, params["Wqkv"])
    _dense(tm.out_proj, params["out_proj"])
    cache = tm.allocate_cache(4)
    calls = [
        (x1, dict(slot_ids=[0, 2], prefill_lengths=[24, 10]), "prefill"),
        (_rand(rng, 2, 16, 64), dict(slot_ids=[1, 3], prefill_lengths=[7, 0],
                                     prefix_lengths=[16, 0]), "prefill"),
        (_rand(rng, 4, 1, 64), {}, "decode"),
        (_rand(rng, 4, 1, 64), {}, "decode"),
    ]
    state = None
    for x, args, mode in calls:
        jargs = {n: jnp.asarray(np.array(v, np.int32)) for n, v in args.items()}
        variables = {"params": params}
        if state is not None:
            variables["cache"] = state
        out_j, st = jm.apply(variables, jnp.asarray(x), mode=mode,
                             mutable=["cache"], block_table=jnp.asarray(table),
                             **jargs)
        state = st["cache"]
        with torch.no_grad():
            out_t = tm(_t(x), mode=mode, cache=cache, block_table=_t(table),
                       **{n: torch.tensor(v, dtype=torch.int32)
                          for n, v in args.items()})
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(state["k"]), **TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(state["v"]), **TOL)
    np.testing.assert_array_equal(cache.offset.numpy(),
                                  np.asarray(state["offset"]))


def test_gpt_slot_prefill_then_decode_matches_jax():
    """GPTLMHeadModel at the engine's tiny configuration (with GQA 4/2) over
    a paged cache of 4 slots: a slot-mapped, padded prefill, a
    prefix-cached admission that shares the first slot's first page (with a
    zero-length dummy row), logits at each prompt's last position, then two
    decode steps of every slot. Its attention runs at the shapes of the
    MHA test above, so JAX's kernels compile once for both. (The linear
    cache's slot-mapped prefill is held against JAX through the engine, in
    tests/test_torch_engine.py.)"""
    fields = dict(vocab_size=96, n_positions=0, n_embd=64, n_layer=2,
                  n_head=4, n_head_kv=2, rotary_emb_fraction=1.0,
                  use_rms_norm=True, glu_act=True, max_decode_seqlen=64,
                  paged_kv_num_pages=12, paged_kv_page_size=PAGE)
    jmodel = JaxGPTLMHeadModel(JaxGPTConfig(dtype=jnp.float32, **fields))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = GPTLMHeadModel(GPTConfig(dtype=torch.float32, **fields),
                            device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(4)
    table = np.array([[4, 5, 0, 0], [4, 8, 9, 0], [2, 3, 0, 0], [0, 0, 0, 0]],
                     np.int32)
    kw_table = {"block_table": table}
    first = dict(slot_ids=[0, 2], prefill_lengths=[24, 10], **kw_table)
    # slot 1 shares slot 0's first page; slot 3 is a zero-length dummy row
    second = dict(slot_ids=[1, 3], prefill_lengths=[7, 0],
                  prefix_lengths=[16, 0], **kw_table)
    calls = [(rng.integers(0, 96, (2, 24)), first, "prefill"),
             (rng.integers(0, 96, (2, 16)), second, "prefill"),
             (rng.integers(0, 96, (4, 1)), dict(**kw_table), "decode"),
             (rng.integers(0, 96, (4, 1)), dict(**kw_table), "decode")]
    cache = tmodel.allocate_cache(4)
    state = None  # JAX makes its cache in the first prefill: a slot a row
    for ids, args, mode in calls:
        args = {n: np.array(v, np.int32) for n, v in args.items()}
        extra = {}
        if mode == "prefill":
            extra["logits_positions"] = np.maximum(
                args["prefill_lengths"] - 1, 0)
        variables = {"params": params}
        if state is not None:
            variables["cache"] = state
        lg_j, st = jmodel.apply(
            variables, jnp.asarray(ids, jnp.int32), mode=mode,
            mutable=["cache"],
            **{n: jnp.asarray(v) for n, v in {**args, **extra}.items()})
        state = st["cache"]
        with torch.no_grad():
            lg_t = tmodel(_t(ids).long(), mode=mode, cache=cache,
                          **{n: _t(v) for n, v in {**args, **extra}.items()})
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("block, want", [
    (64, [[0, 0], [2, 0], [2, 64], [2, 128], [3, 0]]),
    (128, [[0, 0], [2, 0], [2, 128], [3, 0]])])
def test_varlen_tiles_cover_every_row_once(block, want):
    """The tiles of ``block`` rows over the cu_seqlens deltas, b x
    ceil(max_seqlen_q / block) of them, cover every row once (the backward's
    64-row and the forward's 128-row lists); the paged prefill's running
    count of FWD_TILE's 128-row tiles (tile_ends) gives each sequence as
    many tiles."""
    cu = torch.tensor([0, 5, 5, 150, 214], dtype=torch.int32)
    lens = cu[1:] - cu[:-1]
    n = 4 * -(-150 // block)
    tiles = varlen_tiles(lens, n, block)
    assert tiles.shape == (n, 2)
    live = tiles[tiles[:, 0] >= 0].tolist()
    assert live == want
    ends = flash_varlen_paged.tile_ends(lens, block).tolist()
    counts = [e - s for s, e in zip([0] + ends[:-1], ends)]
    assert counts == [sum(t[0] == s for t in live) for s in range(4)]
