"""The port's continuous-batching engine (flash_attn_tpu_torch.serving.
engine) against the JAX engine, on the CPU in fp32 at the engine tests'
tiny configuration (tests/test_engine.py:16), with JAX's weights carried
across. Greedy decoding gives the same tokens exactly; the page pool's
accounting, stats() and the admission shapes equal the JAX engine's after
the same traffic. JAX runs once per scenario (its Pallas kernels in
interpret mode); the port runs its kernels' plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.serving.engine import InferenceEngine as JaxEngine
from flash_attn_tpu.serving.engine import PagePool as JaxPagePool
from flash_attn_tpu.serving.generation import GenerationConfig as JaxGenConfig
from flash_attn_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    load_jax_params,
)
from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
from flash_attn_tpu_torch.serving.generation import GenerationConfig

torch.set_num_threads(1)

FIELDS = dict(vocab_size=96, n_positions=0, n_embd=64, n_layer=2, n_head=4,
              rotary_emb_fraction=1.0, use_rms_norm=True, glu_act=True,
              max_decode_seqlen=64)
PAGE = 16
MPPS = -(-FIELDS["max_decode_seqlen"] // PAGE)  # max pages per sequence


@pytest.fixture(scope="module")
def params():
    model = JaxGPTLMHeadModel(JaxGPTConfig(dtype=jnp.float32, **FIELDS))
    return model.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 8), jnp.int32))["params"]


def _engines(params, num_pages=0, max_batch=2, eos=None, **kw):
    """A JAX engine and the port's over the same weights and options:
    linear with num_pages 0, else paged over pools of num_pages pages."""
    fields = dict(FIELDS)
    if num_pages:
        fields.update(paged_kv_num_pages=num_pages, paged_kv_page_size=PAGE)
    tmodel = GPTLMHeadModel(GPTConfig(dtype=torch.float32, **fields),
                            device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    jeng = JaxEngine(JaxGPTLMHeadModel(JaxGPTConfig(dtype=jnp.float32,
                                                    **fields)),
                     params, max_batch, JaxGenConfig(top_k=1, eos_token_id=eos),
                     page_pool=(JaxPagePool(num_pages, PAGE, MPPS, max_batch)
                                if num_pages else None), **kw)
    teng = InferenceEngine(tmodel, max_batch,
                           GenerationConfig(top_k=1, eos_token_id=eos),
                           page_pool=(PagePool(num_pages, PAGE, MPPS, max_batch)
                                      if num_pages else None),
                           device="cpu", **kw)
    return jeng, teng


def _pool_state(pool):
    return (list(pool.free), dict(pool.rc), list(pool.retained),
            sorted(pool.protected), pool.table.tolist(),
            {s: list(p) for s, p in pool.pages_of.items()})


def _assert_same_state(jeng, teng):
    assert teng.stats() == jeng.stats()
    if jeng.pool is not None:
        assert _pool_state(teng.pool) == _pool_state(jeng.pool)


def _submit_and_run(eng, jobs):
    ids = [eng.submit(p, max_new_tokens=m) for p, m in jobs]
    res = eng.run()
    return [res[i] for i in ids]


def _jobs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 96, size=n).tolist(), m) for n, m in shapes]


def test_linear_cache_with_slot_reuse_matches_jax(params):
    """More requests than slots, mixed lengths: slots are recycled."""
    jobs = _jobs(1, [(4, 3), (6, 12), (2, 5), (8, 8), (5, 2)])
    jeng, teng = _engines(params)
    want = _submit_and_run(jeng, jobs)
    got = _submit_and_run(teng, jobs)
    assert got == want
    assert [len(g) for g in got] == [m for _, m in jobs]
    _assert_same_state(jeng, teng)


def test_paged_cache_with_a_tight_pool_matches_jax(params):
    """A pool of two sequences' pages forces page recycling; every page
    returns to the pool and the accounting equals JAX's."""
    num_pages = 2 * MPPS + 2
    jobs = _jobs(3, [(5, 8), (7, 6), (3, 10), (6, 4)])
    jeng, teng = _engines(params, num_pages=num_pages)
    assert _submit_and_run(teng, jobs) == _submit_and_run(jeng, jobs)
    _assert_same_state(jeng, teng)
    assert len(teng.pool.free) == num_pages - 1 and 0 not in teng.pool.free


def test_token_budgeted_admission_matches_jax(params):
    """max_admit_tokens splits the admission across steps: the same tokens
    and the same bucketed prefill shapes as JAX."""
    jobs = _jobs(7, [(9, 6), (8, 6), (7, 6), (6, 6)])
    jeng, teng = _engines(params, max_batch=4, max_admit_tokens=10)
    assert _submit_and_run(teng, jobs) == _submit_and_run(jeng, jobs)
    # two rows padded to 16 tokens exceed the budget: one row per admission
    assert teng.prefill_shapes == jeng.prefill_shapes == {(1, 16)}
    _assert_same_state(jeng, teng)


def test_decode_blocks_of_1_and_4_match_jax(params):
    """Four decode steps per host round trip, with requests finishing mid-
    block, give the JAX engine's tokens, and so does one step per trip."""
    jobs = _jobs(3, [(4, 5), (6, 7), (3, 3), (7, 9)])
    jeng, teng = _engines(params, decode_block_size=4)
    want = _submit_and_run(jeng, jobs)
    assert _submit_and_run(teng, jobs) == want
    _assert_same_state(jeng, teng)
    _, single = _engines(params, decode_block_size=1)
    assert _submit_and_run(single, jobs) == want


def test_prefix_cache_sharing_retention_and_eviction_match_jax(params):
    """Prefix caching over one engine's life: two same-prefix requests
    admitted together share pages in the batch; a later one hits the
    retained pages; unrelated prompts force their eviction (with the index
    purged); the first prompt again decodes to its first tokens. Tokens,
    hit counts and page accounting equal JAX's after every phase."""
    rng = np.random.default_rng(13)
    common = rng.integers(0, 96, size=37).tolist()  # two full pages
    phases = [
        [(common + [1, 2], 4), (common + [5, 6, 7], 4)],
        [(common + [3], 4)],
        [(rng.integers(0, 96, size=40).tolist(), 4) for _ in range(3)],
        [(common + [1, 2], 4)],
    ]
    jeng, teng = _engines(params, num_pages=12, prefix_cache=True)
    outs = []
    for jobs in phases:
        want = _submit_and_run(jeng, jobs)
        assert _submit_and_run(teng, jobs) == want
        _assert_same_state(jeng, teng)
        outs.append(want)
    assert teng.stats()["prefix_hit_pages"] >= 2 + 2
    assert outs[3][0] == outs[0][0]


def test_prefix_hit_is_counted_once_when_the_pool_is_full(params):
    """A same-prefix request that the pool cannot take at once: it shares
    the first request's two prefix pages, its alloc of a third fails while
    the first request holds every other page, and it is retried each step
    until the first finishes. Its hit counts once, when it is admitted.
    The JAX engine counts it on every failed try
    (flash_attn_tpu/serving/engine.py:544-551 adds to prefix_hit_pages
    before alloc()); the port deliberately does not, so this runs the
    port's engine alone."""
    rng = np.random.default_rng(17)
    common = rng.integers(0, 96, size=2 * PAGE).tolist()
    jobs = [(common + [1, 2], 4), (common + [3, 4], 4)]
    # 3 pages besides the null page: each request needs 3 (36 + 4 + 1)
    _, teng = _engines(params, num_pages=4, prefix_cache=True)
    ids = [teng.submit(p, max_new_tokens=m) for p, m in jobs]
    tries = 0
    while teng.queue or any(s is not None for s in teng.slots):
        tries += bool(teng.queue)
        teng.step()
    res = teng.run()
    assert tries > 2  # the second request waited through failed allocs
    assert [len(res[i]) for i in ids] == [4, 4]
    assert teng.stats()["prefix_hit_pages"] == 2
    assert len(teng.pool.free) + len(teng.pool.retained) == 3


def test_eos_early_release_and_cancel_match_jax(params):
    """A request ends at its eos token and frees its slot; a queued and an
    active request are cancelled; later requests take the freed slots."""
    probe = _jobs(23, [(3, 1)])
    _, teng = _engines(params)
    eos = _submit_and_run(teng, probe)[0][0]
    jobs = [(probe[0][0], 32)] + _jobs(24, [(5, 8), (6, 8)])
    late = _jobs(25, [(4, 5)])
    results = []
    for eng in _engines(params, eos=eos):
        ids = [eng.submit(p, max_new_tokens=m) for p, m in jobs]
        eng.step()  # admits the first two; the third waits
        assert eng.cancel(ids[2]) and eng.cancel(ids[1])
        assert not eng.cancel(999)
        res = eng.run()
        results.append(([res[i] for i in ids], _submit_and_run(eng, late),
                        eng.stats()))
    (got, got_late, st_t), (want, want_late, st_j) = results[::-1]
    assert got == want and got_late == want_late and st_t == st_j
    assert got[0][-1] == eos and len(got[0]) < 32 and got[2] == []


def test_randomized_stress_keeps_page_accounting_exact(params):
    """Port of tests/test_engine.py:552 on the port's engine: a random
    submit/cancel/step trace over the prefix-cached paged engine keeps
    every page exactly one of free, retained or refcounted, and every
    request completes with at most max_new_tokens."""
    rng = np.random.default_rng(31)
    _, eng = _engines(params, num_pages=14, prefix_cache=True)
    pool = eng.pool
    total_pages = 14 - 1  # page 0 = null
    common = rng.integers(0, 96, size=20).tolist()
    live = []
    for _ in range(40):
        op = rng.random()
        if op < 0.4 and len(live) < 6:
            base = common if rng.random() < 0.5 else []
            p = base + rng.integers(0, 96,
                                    size=int(rng.integers(1, 30))).tolist()
            live.append(eng.submit(p, max_new_tokens=int(rng.integers(1, 6))))
        elif op < 0.5 and live:
            eng.cancel(live.pop(int(rng.integers(0, len(live)))))
        else:
            eng.step()
        held = {pg for pages in pool.pages_of.values() for pg in pages}
        assert set(pool.rc) == held, (pool.rc, held)
        assert len(pool.free) + len(pool.retained) + len(pool.rc) \
            == total_pages
        assert not (set(pool.free) & set(pool.retained))
        assert not (set(pool.free) & set(pool.rc))
    eng.run()
    for rid, req in eng.requests.items():
        assert req.done, rid
        assert len(req.generated) <= req.max_new_tokens
    assert len(pool.free) + len(pool.retained) == total_pages


def test_warmup_reset_and_close_leave_outputs_unchanged(params):
    """warmup() runs the admission and decode paths on dummy rows and
    leaves the offsets at 0; reset() keeps the cache tensors; a second trace
    after each gives the tokens of a fresh engine."""
    jobs = _jobs(4, [(7, 5), (4, 5)])
    _, fresh = _engines(params, num_pages=2 * MPPS + 2)
    want = _submit_and_run(fresh, jobs)
    _, eng = _engines(params, num_pages=2 * MPPS + 2)
    eng.warmup(prefill_shapes=[(2, 16)])
    assert (2, 16) in eng.prefill_shapes and not eng._offsets().any()
    assert _submit_and_run(eng, jobs) == want
    k_before = eng.cache[0].k
    eng.reset()
    assert eng.cache[0].k is k_before
    assert _submit_and_run(eng, jobs) == want
    eng.close()
    assert eng.cache is None and eng.stats()["active_slots"] == 0


def test_engine_is_freed_by_refcount(params):
    """The engine holds no reference cycle: dropping the last reference
    frees it, and its cache, at once (tests/test_engine.py:391)."""
    import weakref

    _, eng = _engines(params, num_pages=2 * MPPS + 2, prefix_cache=True)
    _submit_and_run(eng, [([1, 2, 3], 2)])
    ref = weakref.ref(eng)
    del eng
    assert ref() is None


def test_engine_refusals(params):
    """Speculative rounds are not ported; a pool and a model must agree on
    the paged cache; the default device is the card."""
    tmodel = GPTLMHeadModel(GPTConfig(dtype=torch.float32, **FIELDS),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="queue A, item 3a"):
        InferenceEngine(tmodel, 2, GenerationConfig(), draft_model=tmodel,
                        device="cpu")
    with pytest.raises(ValueError, match="page pool"):
        InferenceEngine(tmodel, 2, GenerationConfig(),
                        page_pool=PagePool(10, PAGE, MPPS, 2), device="cpu")
    paged = GPTLMHeadModel(GPTConfig(dtype=torch.float32, **dict(
        FIELDS, paged_kv_num_pages=10, paged_kv_page_size=PAGE)),
        device="cpu")
    with pytest.raises(ValueError, match="page pool"):
        InferenceEngine(paged, 2, GenerationConfig(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(tmodel, 2, GenerationConfig())
