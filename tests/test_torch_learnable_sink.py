"""The learnable sink in the port (flash_attn_tpu_torch) against the JAX
package on the same numpy inputs, on the CPU: the port runs its kernels'
plain versions (B1, B6, B7, B8 and B8p take the sink in their epilogues on
the card), JAX its Pallas kernels in interpret mode.

The sinks bite: head 0's sits 4 above the rows' log-sum, head 1's near
-30, head 2's at 0 (h = 4, h_k = 2, d = 64). Cases with rows that see no
key (sq > sk causal, a window that leaves rows empty, a sequence with no
keys, rows past seqused_q and the packed tail) check lse = sink there.

- ``flash_attn_func``: out and lse against JAX's (fp32 on both sides:
  atol/rtol 2e-5), dq, dk, dv and the sink's gradient against ``jax.vjp``
  (atol 1e-4: summation order; the sink's gradient rtol 1e-4 too, a sum
  over every row), in both ``deterministic`` modes, under causal masking,
  GQA, a window, the cap and ALiBi; ``return_attn_probs``' S_dmask.
- the dense ``flash_attn_varlen_func``: B7's route and B6's ALiBi route,
  out, lse and the gradients as above.
- the paged route: B8 (JAX's B8 at a KV tile of one page,
  tests/jax_paged_refs.py) with a window and the cap, and over an fp8
  page pool with descales (bf16 q: out within 1e-2, a bf16 step; lse
  within 5e-3, since JAX rounds q times its scale and descale to bf16
  before the product, 2.4e-3 apart at most here); B8p with ``qv`` against JAX's flash_attention_paged_prefill
  and JAX's route (fp32, 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu.interface import flash_attn_varlen_func as jax_varlen
from flash_attn_tpu.kernels.flash_paged_prefill import (
    flash_attention_paged_prefill as jax_paged_prefill,
)
from flash_attn_tpu_torch import flash_attn_func, flash_attn_varlen_func
from flash_attn_tpu_torch.dispatch.band import band_valid
from flash_attn_tpu_torch.dispatch.config import normalize_window
from flash_attn_tpu_torch.kernels.flash_paged_prefill import (
    flash_attention_paged_prefill,
)

from jax_paged_refs import jax_varlen_paged, one_page_tiles

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
H, H_K, D = 4, 2, 64


@pytest.fixture(scope="module", autouse=True)
def _jax_paged_kernels_at_one_page_tiles():
    """JAX's paged kernels at a KV tile of one page (tests/jax_paged_refs.
    py): the same functions, lowered faster."""
    with one_page_tiles():
        yield


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _sinks(keys: int):
    """(H,) sink logits that bite at these widths: head 0's 4 above a row's
    log-sum over ``keys`` keys of N(0, 1) scores (log keys + 1/2), head 1's
    near -30, head 2's at 0, head 3's just under the log-sum."""
    lse = float(np.log(max(keys, 1)) + 0.5)
    return np.array([lse + 4.0, -30.0, 0.0, lse - 1.0], np.float32)


def _assert_lse(lse_t, lse_j, **tol):
    lse_t, lse_j = np.asarray(lse_t), np.asarray(lse_j)
    np.testing.assert_array_equal(np.isfinite(lse_t), np.isfinite(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], **(tol or TOL))


def _assert_sink_rows(lse, sink, rows, head_axis):
    """lse equals each head's sink on ``rows`` (a bool mask over lse with
    the head axis taken out)."""
    lse = np.moveaxis(np.asarray(lse), head_axis, 0)
    for hh in range(lse.shape[0]):
        np.testing.assert_array_equal(lse[hh][rows], np.float32(sink[hh]))


# (name, sq, sk, causal, window, softcap, alibi, rows that see no key)
FUNC_CASES = [
    ("gqa, not causal, sq < sk", 64, 130, False, (-1, -1), 0.0, False),
    ("causal, sq > sk", 130, 64, True, (-1, -1), 0.0, False),
    ("window (10, 10), sq > sk: rows with no key", 130, 64, False, (10, 10),
     0.0, False),
    ("causal window (20, 0), cap 5", 96, 96, True, (20, 0), 5.0, False),
    ("causal alibi", 80, 100, True, (-1, -1), 0.0, True),
]


def _func_inputs(case, seed=0):
    _, sq, sk, *_ = case
    rng = np.random.default_rng(seed + sq + 7 * sk)
    q, k, v = (_rand(rng, 2, s, n, D) for s, n in ((sq, H), (sk, H_K),
                                                  (sk, H_K)))
    return q, k, v, _rand(rng, 2, sq, H, D), _sinks(sk)


def _func_kw(case):
    _, _, _, causal, window, cap, alibi = case
    slopes = np.array([0.25, 0.0625, 0.5, 0.125], np.float32) if alibi \
        else None
    return dict(causal=causal, window_size=window, softcap=cap), slopes


@pytest.mark.parametrize("case", FUNC_CASES, ids=lambda c: c[0])
def test_flash_attn_func_sink_matches_jax(case):
    """out, lse, dq, dk, dv and dsink against JAX's, in both deterministic
    modes; rows that see no key give out 0 and lse = sink."""
    q, k, v, g, sink = _func_inputs(case)
    kw, slopes = _func_kw(case)

    def jf(q_, k_, v_, s_):
        out, lse, _ = jax_flash_attn_func(
            q_, k_, v_, learnable_sink=s_, alibi_slopes=_j(slopes),
            return_attn_probs=True, **kw)
        return out, lse

    (out_j, lse_j), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v, sink)))
    grads_j = vjp((jnp.asarray(g), jnp.zeros_like(lse_j)))
    for deterministic in (True, False):
        leaves = [_t(x).requires_grad_() for x in (q, k, v, sink)]
        out_t, lse_t, _ = flash_attn_func(
            *leaves[:3], learnable_sink=leaves[3], alibi_slopes=_t(slopes),
            deterministic=deterministic, return_attn_probs=True, **kw)
        out_t.backward(_t(g))
        np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                                   **TOL)
        _assert_lse(lse_t.numpy(), lse_j)
        for name, leaf, want in zip(("dq", "dk", "dv", "dsink"), leaves,
                                    grads_j):
            np.testing.assert_allclose(
                leaf.grad.numpy(), np.asarray(want), **GRAD_TOL,
                err_msg=f"{case[0]} {name} deterministic={deterministic}")
        assert leaves[3].grad.dtype == torch.float32
    sq, sk = q.shape[1], k.shape[1]
    empty = ~band_valid(torch.arange(sq)[:, None], torch.arange(sk)[None],
                        sk - sq, kw["causal"],
                        normalize_window(kw["window_size"])).any(1).numpy()
    if "no key" in case[0] or "sq > sk" in case[0]:
        assert empty.any()
        _assert_sink_rows(lse_t.numpy(), sink, (slice(None), empty), 1)
        assert not out_t.detach().numpy()[:, empty].any()


def test_sink_gradient_in_its_own_type_and_only_when_asked():
    """A bf16 sink gets a bf16 gradient; a sink without requires_grad gets
    none while q, k and v train; a sink of the wrong length or device
    raises ValueError."""
    q, k, v, g, sink = _func_inputs(FUNC_CASES[0])
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    s16 = _t(sink).bfloat16().requires_grad_()
    flash_attn_func(*leaves, causal=True, learnable_sink=s16).backward(_t(g))
    assert s16.grad.dtype == torch.bfloat16 and s16.grad.abs().sum() > 0
    frozen = _t(sink)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    flash_attn_func(*leaves, causal=True,
                    learnable_sink=frozen).backward(_t(g))
    assert frozen.grad is None and leaves[0].grad is not None
    for bad in (torch.zeros(H + 1), torch.zeros(H, dtype=torch.int32)):
        with pytest.raises(ValueError, match="learnable_sink"):
            flash_attn_func(_t(q), _t(k), _t(v), learnable_sink=bad)
    with pytest.raises(ValueError, match="learnable_sink"):
        flash_attn_func(_t(q), _t(k), _t(v),
                        learnable_sink=torch.zeros(H, device="meta"))


def test_return_attn_probs_with_sink_matches_jax():
    """S_dmask normalised by the kernel's lse, which holds the sink: head
    0's rows (its sink 4 above their log-sum) sum to about e^-4, as in
    JAX."""
    case = FUNC_CASES[2]
    q, k, v, _, sink = _func_inputs(case)
    kw, _ = _func_kw(case)
    _, _, s_j = jax_flash_attn_func(*map(jnp.asarray, (q, k, v)),
                                    learnable_sink=jnp.asarray(sink),
                                    return_attn_probs=True, **kw)
    _, _, s_t = flash_attn_func(_t(q), _t(k), _t(v), learnable_sink=_t(sink),
                                return_attn_probs=True, **kw)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)
    assert float(s_t[:, 0].sum(-1).max()) < 0.05


# (name, lens_q, lens_k, seqused_q, tail, causal, alibi): B7's route, or
# B6's forward under ALiBi
VARLEN_CASES = [
    ("B7, a sequence with no keys, seqused_q, tail", [40, 0, 75, 12],
     [0, 10, 90, 12], [40, 0, 60, 12], 5, True, False),
    ("B6 under alibi, causal, a sequence with no keys", [40, 75],
     [0, 90], None, 3, True, True),
]


def _varlen_inputs(case, seed=3):
    _, lens_q, lens_k, used_q, tail, *_ = case
    rng = np.random.default_rng(seed + sum(lens_q))
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    tq, tk = int(cu_q[-1]) + tail, int(cu_k[-1]) + tail
    return (_rand(rng, tq, H, D), _rand(rng, tk, H_K, D),
            _rand(rng, tk, H_K, D), _rand(rng, tq, H, D), cu_q, cu_k,
            None if used_q is None else np.array(used_q, np.int32))


@pytest.mark.parametrize("case", VARLEN_CASES, ids=lambda c: c[0])
def test_varlen_sink_matches_jax(case):
    """The dense flash_attn_varlen_func: out, lse (the sink on every row in
    no sequence, past seqused_q or with no key) and dq, dk, dv, dsink."""
    q, k, v, g, cu_q, cu_k, used = _varlen_inputs(case)
    _, lens_q, lens_k, _, _, causal, alibi = case
    sink = _sinks(max(lens_k))
    slopes = np.array([0.25, 0.0625, 0.5, 0.125], np.float32) if alibi \
        else None
    kw = dict(causal=causal)
    mq, mk = max(lens_q), max(lens_k)

    def jf(q_, k_, v_, s_):
        out, lse, _ = jax_varlen(
            q_, k_, v_, jnp.asarray(cu_q), jnp.asarray(cu_k), mq, mk,
            seqused_q=_j(used), learnable_sink=s_, alibi_slopes=_j(slopes),
            return_attn_probs=True, **kw)
        return out, lse

    (out_j, lse_j), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v, sink)))
    grads_j = vjp((jnp.asarray(g), jnp.zeros_like(lse_j)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, sink)]
    out_t, lse_t, _ = flash_attn_varlen_func(
        *leaves[:3], _t(cu_q), _t(cu_k), mq, mk, seqused_q=_t(used),
        learnable_sink=leaves[3], alibi_slopes=_t(slopes),
        return_attn_probs=True, **kw)
    out_t.backward(_t(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    _assert_lse(lse_t.numpy(), lse_j)
    for name, leaf, want in zip(("dq", "dk", "dv", "dsink"), leaves,
                                grads_j):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL, err_msg=f"{case[0]} {name}")
    tail = np.arange(q.shape[0]) >= cu_q[-1]
    no_keys = np.zeros(q.shape[0], bool)
    for s, lk in enumerate(lens_k):
        no_keys[cu_q[s]:cu_q[s + 1]] |= lk == 0
    _assert_sink_rows(lse_t.numpy(), sink, tail | no_keys, 0)


PAGE = 16
TABLE = np.array([[3, 0, 0, 0, 0, 0], [7, 1, 4, 0, 0, 0],
                  [2, 9, 11, 5, 6, 10]], np.int32)


def _paged_inputs(seed, d=D, dv=D, h_k=H_K):
    rng = np.random.default_rng(seed)
    lens_q, lens_k, used = [9, 1, 30], [12, 40, 90], [9, 1, 24]
    cu = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    return (rng, _rand(rng, int(cu[-1]) + 2, H, d),
            _rand(rng, 12, h_k, PAGE, d), _rand(rng, 12, h_k, PAGE, dv), cu,
            np.array(lens_k, np.int32), np.array(used, np.int32))


@pytest.mark.parametrize("kw", [
    dict(causal=True, window_size=(7, 0)),
    dict(causal=False, window_size=(20, 3), softcap=4.0)],
    ids=["causal_window", "window_cap"])
def test_varlen_paged_sink_matches_jax(kw):
    """B8's route (block_table=, no qv): out and lse against JAX's B8, the
    sink on the rows past seqused_q, in the tail and with no key."""
    _, q, kp, vp, cu, lens_k, used = _paged_inputs(11)
    sink = _sinks(40)
    out_j, lse_j = jax_varlen_paged(
        _j(q), _j(kp), _j(vp), _j(cu), 30, _j(lens_k), _j(TABLE),
        seqused_q=_j(used), learnable_sink=_j(sink), **kw)
    out_t, lse_t = flash_attn_varlen_func(
        _t(q), _t(kp), _t(vp), _t(cu), None, 30, 96, block_table=_t(TABLE),
        seqused_k=_t(lens_k), seqused_q=_t(used), learnable_sink=_t(sink),
        return_attn_probs=True, **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t.numpy(), lse_j)
    dead = np.ones(q.shape[0], bool)
    for s in range(3):
        dead[cu[s]:cu[s] + used[s]] = False
    _assert_sink_rows(lse_t.numpy(), sink, dead, 0)
    assert not out_t.numpy()[dead].any()


def test_varlen_paged_sink_fp8_descales_match_jax():
    """B8 over an e4m3 page pool with (b, h_k) descales and a sink: v_descale
    scales 1 / l' (JAX flash_varlen_paged.py:194-207, :276-277). bf16 q:
    out within a bf16 step (1e-2), lse within 5e-3 (JAX's bf16 rounding of
    the scaled q)."""
    rng, q, kp, vp, cu, lens_k, used = _paged_inputs(12)
    q16 = q.astype(jnp.bfloat16)
    kp8, vp8 = (x.astype(jnp.float8_e4m3fn) for x in (kp, vp))
    qd, kd, vd = [(0.5 + rng.random((3, H_K))).astype(np.float32)
                  for _ in range(3)]
    sink = _sinks(40)
    out_j, lse_j = jax_varlen_paged(
        jnp.asarray(q16), jnp.asarray(kp8), jnp.asarray(vp8), _j(cu), 30,
        _j(lens_k), _j(TABLE), seqused_q=_j(used), q_descale=_j(qd),
        k_descale=_j(kd), v_descale=_j(vd), learnable_sink=_j(sink),
        causal=True)

    def fp8(x):
        return torch.from_numpy(np.asarray(x).view(np.uint8).copy()).view(
            torch.float8_e4m3fn)

    out_t, lse_t = flash_attn_varlen_func(
        _t(q16.astype(np.float32)).bfloat16(), fp8(kp8), fp8(vp8), _t(cu),
        None, 30, 96, block_table=_t(TABLE), seqused_k=_t(lens_k),
        seqused_q=_t(used), q_descale=_t(qd), k_descale=_t(kd),
        v_descale=_t(vd), learnable_sink=_t(sink), causal=True,
        return_attn_probs=True)
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=1e-2,
                               rtol=0)
    _assert_lse(lse_t.numpy(), lse_j, atol=5e-3, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_paged_prefill_sink_matches_jax(causal):
    """B8p (qv, d = 64, dv = 128): out and lse of the dense signature
    against JAX's flash_attention_paged_prefill, rows past seqused_q and
    rows that see no key (a chunk longer than its keys) at the sink, and
    the varlen route (block_table=, qv=) against JAX's route."""
    rng = np.random.default_rng(13)
    dv, sq_max = 128, 17
    used, lens_k = np.array([5, 0, 12], np.int32), np.array([3, 9, 40],
                                                            np.int32)
    q, qv = _rand(rng, 3, sq_max, H, D), _rand(rng, 3, sq_max, H, dv)
    kp, vp = _rand(rng, 12, 1, PAGE, D), _rand(rng, 12, 1, PAGE, dv)
    table = TABLE[:, :3]
    sink = _sinks(20)
    out_j, lse_j = jax_paged_prefill(
        _j(q), _j(kp), _j(vp), _j(used), _j(lens_k), _j(table), qv=_j(qv),
        learnable_sink=_j(sink), causal=causal, interpret=True)
    out_t, lse_t = flash_attention_paged_prefill(
        _t(q), _t(kp), _t(vp), _t(used), _t(lens_k), _t(table), qv=_t(qv),
        learnable_sink=_t(sink), causal=causal)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t.numpy(), lse_j)
    past = np.arange(sq_max)[None] >= used[:, None]
    _assert_sink_rows(lse_t.numpy(), sink, past, 1)
    if causal:  # sequence 0: 5 rows over 3 keys, its first 2 see none
        np.testing.assert_array_equal(lse_t[0, :, :2].numpy(),
                                      np.repeat(sink[:, None], 2, 1))
    lens_q = [6, 11, 1]
    cu = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    qp, qvp = _rand(rng, int(cu[-1]), H, D), _rand(rng, int(cu[-1]), H, dv)
    lens_k = np.array([30, 11, 47], np.int32)
    out_j, lse_j = jax_varlen(
        _j(qp), _j(kp), _j(vp), _j(cu), None, max(lens_q), 48,
        block_table=_j(table), seqused_k=_j(lens_k), qv=_j(qvp),
        learnable_sink=_j(sink), causal=causal, return_attn_probs=True)
    out_t, lse_t = flash_attn_varlen_func(
        _t(qp), _t(kp), _t(vp), _t(cu), None, max(lens_q), 48,
        block_table=_t(table), seqused_k=_t(lens_k), qv=_t(qvp),
        learnable_sink=_t(sink), causal=causal, return_attn_probs=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _assert_lse(lse_t.numpy(), lse_j)


def test_paged_route_is_forward_only_with_a_trained_sink():
    """block_table= with a sink that requires grad raises, as with q."""
    _, q, kp, vp, cu, lens_k, used = _paged_inputs(14)
    with pytest.raises(NotImplementedError, match="forward only"):
        flash_attn_varlen_func(
            _t(q), _t(kp), _t(vp), _t(cu), None, 30, 96,
            block_table=_t(TABLE), seqused_k=_t(lens_k),
            learnable_sink=_t(_sinks(40)).requires_grad_())
