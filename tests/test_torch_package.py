"""Package-level checks of the port (flash_attn_tpu_torch): what it
imports, what it refuses, and, on a CUDA card, each kernel against its
plain version (this file imports no JAX, so that these run on the card:
``python3 -m pytest --noconftest tests/test_torch_package.py``)."""

import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import flash_attn_tpu_torch
from flash_attn_tpu_torch import flash_attn_func, flash_attn_with_kvcache
from flash_attn_tpu_torch.cache.kvcache import kv_cache_update
from flash_attn_tpu_torch.dispatch.config import DECODE_BLOCK_K
from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel

torch.set_num_threads(1)

PKG = Path(flash_attn_tpu_torch.__file__).parent
REPO = PKG.parent


def test_import_pulls_in_no_jax_or_triton():
    code = (
        "import pkgutil, importlib, sys, flash_attn_tpu_torch as p\n"
        "mods = [m.name for m in\n"
        "        pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'triton', 'flash_attn_tpu')"
        " if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 20  # every subpackage and module was imported


def test_no_library_attention_in_the_package():
    banned = re.compile(
        r"scaled_dot_product_attention|torch\.compile|cudnn|cublas"
        r"|^\s*(import|from)\s+(jax|flax|optax|triton|flash_attn_tpu)\b",
        re.IGNORECASE)
    sources = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert sources
    hits = [f"{p.relative_to(REPO)}:{i}" for p in sources
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if banned.search(line.split("#")[0].split("//")[0])]
    assert not hits, hits


@pytest.mark.parametrize("kwargs", [
    dict(dropout_p=0.1), dict(window_size=(8, 0)), dict(softcap=5.0),
    dict(alibi_slopes=torch.ones(2)), dict(qv=torch.ones(1)),
    dict(score_mod=lambda s, *a: s)])
def test_flash_attn_func_rejects_unported_options(kwargs):
    q = torch.randn(1, 8, 2, 64)
    with pytest.raises(NotImplementedError):
        flash_attn_func(q, q, q, **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(rotary_seqlens=torch.zeros(1, dtype=torch.int32)),
    dict(cache_batch_idx=torch.zeros(1, dtype=torch.int32)),
    dict(cache_leftpad=torch.zeros(1, dtype=torch.int32)),
    dict(k_descale=torch.ones(1, 2))])
def test_flash_attn_with_kvcache_rejects_unported_options(kwargs):
    q = torch.randn(1, 1, 2, 64)
    cache = torch.zeros(1, 2, 128, 64)
    with pytest.raises(NotImplementedError):
        flash_attn_with_kvcache(q, cache, cache, **kwargs)


def test_gradient_request_raises():
    """flash_attn_func takes gradients; the decode path still refuses them,
    as the JAX package has no gradient of a decode step either."""
    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    out = flash_attn_func(q, q, q, causal=True)
    out.square().sum().backward()
    assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad).all())
    assert q.grad.abs().sum() > 0
    qd = torch.randn(1, 1, 2, 64, requires_grad=True)
    cache = torch.zeros(1, 2, 128, 64)
    with pytest.raises(NotImplementedError, match="forward only"):
        flash_attn_with_kvcache(qd, cache, cache, cache_seqlens=4)
    with torch.no_grad():
        assert flash_attn_with_kvcache(qd, cache, cache,
                                       cache_seqlens=4).shape == qd.shape


def test_dropout_refusals_point_at_queue_a_7():
    """The JAX trainer never turns dropout on, so training needs none;
    dropout (B9) is queue A item 7."""
    from flash_attn_tpu_torch.ops.norm import dropout_add_rms_norm

    x = torch.randn(2, 3, 8)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_attn_func(x[..., None, :], x[..., None, :], x[..., None, :],
                        dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        dropout_add_rms_norm(x, None, torch.ones(8), dropout_p=0.1)


def test_unported_model_options_raise():
    with pytest.raises(NotImplementedError, match="use_alibi"):
        GPTLMHeadModel(GPTConfig(n_positions=0, n_layer=1, use_alibi=True),
                       device="cpu")


def test_entry_points_default_to_the_card():
    """With no device the model and the trainer build on the CUDA card;
    without one they raise (after the unported-option checks), never
    silently taking the CPU."""
    from flash_attn_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = GPTConfig(vocab_size=64, n_positions=0, n_embd=32, n_layer=1,
                    n_head=2, rotary_emb_fraction=1.0, use_rms_norm=True,
                    glu_act=True, max_decode_seqlen=16)
    tcfg = TrainConfig(model=cfg, batch_size=1, seqlen=8)
    if torch.cuda.is_available():
        assert next(GPTLMHeadModel(cfg).parameters()).device.type == "cuda"
        assert Trainer(tcfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTLMHeadModel(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tcfg)
    assert next(GPTLMHeadModel(cfg, device="cpu").parameters()).device.type \
        == "cpu"


def test_kv_cache_update_in_place():
    cache_k, cache_v = torch.zeros(3, 2, 16, 8), torch.zeros(3, 2, 16, 8)
    ptrs = cache_k.data_ptr(), cache_v.data_ptr()
    k_new = torch.randn(3, 2, 2, 8)
    offs = torch.tensor([0, 5, 14], dtype=torch.int32)
    out_k, out_v = kv_cache_update(cache_k, cache_v, k_new, -k_new, offs)
    assert (out_k.data_ptr(), out_v.data_ptr()) == ptrs
    for i, o in enumerate(offs.tolist()):
        assert torch.equal(cache_k[i, :, o:o + 2], k_new[i].transpose(0, 1))
        assert torch.equal(cache_v[i, :, o:o + 2], -k_new[i].transpose(0, 1))
        cache_k[i, :, o:o + 2] = 0
    assert not cache_k.any()  # nothing else was written


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there "
                    "(python3 chip_smoke.py checks them on the card)")
    return torch.device("cuda")


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("causal", [False, True])
def test_kernels_match_plain_versions_on_the_card(causal):
    from flash_attn_tpu_torch.kernels import flash_decode, flash_fwd

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    q, k, v = randn(2, 4, 200, 128), randn(2, 2, 300, 128), randn(2, 2, 300, 128)
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd.flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)

    qd = randn(3, 1, 8, 128)
    kc, vc = randn(3, 2, 256, 128), randn(3, 2, 256, 128)
    seqlens = torch.tensor([1, 100, 256], dtype=torch.int32, device="cuda")
    out, lse = flash_decode.flash_attention_decode(qd, kc, vc, seqlens,
                                                   causal=causal, num_splits=3)
    parts = flash_decode.flash_attention_decode_partials_plain(
        qd, kc, vc, seqlens, 3, DECODE_BLOCK_K, 1 / math.sqrt(128), causal)
    ref, ref_lse = flash_decode.combine_splits(*parts)
    ref = ref.reshape(3, 2, 1, 4, 128).permute(0, 2, 1, 3, 4).reshape(3, 1, 8, 128)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse.reshape(3, 8, 1), atol=1e-4, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("deterministic", [True, False])
def test_backward_kernels_match_plain_version_on_the_card(causal,
                                                          deterministic):
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    q, do = randn(2, 4, 200, 128), randn(2, 4, 200, 128)
    k, v = randn(2, 2, 300, 128), randn(2, 2, 300, 128)
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal)
    got = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse, causal=causal,
                                        deterministic=deterministic)
    ref = flash_bwd.flash_attention_bwd_plain(do, q, k, v, out, lse,
                                              causal=causal)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r.float(), atol=5e-2, rtol=0)


def _included_sources(path: Path) -> str:
    """The text of a CUDA source and of every repo header it includes."""
    text = path.read_text()
    for name in re.findall(r'^#include "([^"]+)"', text, re.MULTILINE):
        text += _included_sources(path.parent / name)
    return text


def test_dense_backward_sources_use_wgmma_and_tma():
    """The dense backward (csrc/flash_bwd.cu and the headers it includes)
    runs its products on wgmma and loads its tiles asynchronously by TMA,
    and it no longer includes the mma.sync loops of bwd_tile.cuh."""
    text = _included_sources(PKG / "csrc" / "flash_bwd.cu")
    assert "wgmma.mma_async" in text
    assert "cp.async.bulk.tensor" in text and "cp.async.bulk.shared" in text
    assert "bwd_tile.cuh" not in text


# Edge shapes of the dense backward's tiles (b, sq, sk, h, h_k, d, causal,
# dtype): one row, lengths either side of the 64- and 128-row tiles, sq > sk
# (the first rows see no key), MQA and GQA, both head dims, fp16.
DENSE_BWD_EDGE_CASES = [
    (1, 1, 1, 2, 1, 64, True, torch.bfloat16),
    (2, 63, 65, 4, 1, 128, True, torch.bfloat16),
    (2, 127, 129, 4, 4, 64, False, torch.float16),
    (1, 200, 129, 4, 2, 128, True, torch.bfloat16),
    (2, 129, 200, 8, 2, 128, True, torch.float16),
    (1, 300, 300, 2, 2, 64, True, torch.bfloat16),
]


def _dense_bwd_inputs(case, seed=0):
    """q, k, v, do as (b, h, s, d) views of (b, s, h, d) tensors on the card,
    with the forward's out and lse."""
    from flash_attn_tpu_torch.kernels import flash_fwd

    b, sq, sk, h, h_k, d, causal, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(s, n):
        return torch.randn(b, s, n, d, device="cuda", generator=gen).to(
            dtype).transpose(1, 2)

    q, k, v, do = randn(sq, h), randn(sk, h_k), randn(sk, h_k), randn(sq, h)
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal)
    return q, k, v, do, out, lse


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("case", DENSE_BWD_EDGE_CASES)
def test_dense_backward_edge_shapes_on_the_card(case, deterministic):
    """Both backward paths against the plain fp32 backward under the 2x
    rule (autograd through attention_ref in the inputs' type as the
    low-precision reference), and the preprocess kernel against its plain
    version."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref_grads,
        check_against_ref,
    )

    causal = case[6]
    q, k, v, do, out, lse = _dense_bwd_inputs(case)
    got = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse, causal=causal,
                                        deterministic=deterministic)
    f32 = [x.float() for x in (q, k, v)]
    out32, lse32 = flash_fwd.flash_attention_fwd_plain(*f32, causal=causal)
    ref = flash_bwd.flash_attention_bwd_plain(do.float(), *f32, out32, lse32,
                                              causal=causal)
    ref_lp = attention_ref_grads(*(x.transpose(1, 2) for x in (q, k, v, do)),
                                 causal=causal, upcast=False)
    for name, g, r, lp in zip("qkv", got, ref, ref_lp):
        assert g.dtype == q.dtype and g.shape == r.shape
        check_against_ref(g.transpose(1, 2), r.transpose(1, 2), lp, atol=1e-4,
                          msg=f"d{name} {case} deterministic={deterministic}")
    delta, lse2 = flash_bwd.bwd_preprocess(do, out, lse)
    want = flash_bwd.bwd_preprocess_plain(do, out, lse, delta.shape[-1])
    torch.testing.assert_close(delta, want[0], atol=1e-3, rtol=1e-3)
    assert torch.equal(torch.isinf(lse2), torch.isinf(want[1]))
    fin = torch.isfinite(want[1])
    torch.testing.assert_close(lse2[fin], want[1][fin], atol=1e-5, rtol=1e-6)


@pytest.mark.usefixtures("cuda_card")
def test_dense_backward_is_bitwise_deterministic_on_the_card():
    """The deterministic backward gives the same bits twice and launches
    the preprocess, dK/dV and dQ kernels once each."""
    from flash_attn_tpu_torch.kernels import flash_bwd

    case = (2, 300, 300, 8, 2, 128, True, torch.bfloat16)
    q, k, v, do, out, lse = _dense_bwd_inputs(case, seed=1)
    before = (flash_bwd.launches_preprocess, flash_bwd.launches_dkdv,
              flash_bwd.launches_dq, flash_bwd.launches_fused)
    first = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse, causal=True)
    after = (flash_bwd.launches_preprocess, flash_bwd.launches_dkdv,
             flash_bwd.launches_dq, flash_bwd.launches_fused)
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1, 0]
    again = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse, causal=True)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, again))


@pytest.mark.usefixtures("cuda_card")
def test_dense_backward_refuses_misaligned_views_on_the_card():
    """TMA needs 16-byte aligned starts and strides: a view that breaks
    either raises ValueError, and nothing is copied quietly."""
    from flash_attn_tpu_torch.kernels import flash_bwd

    case = (1, 64, 64, 2, 2, 64, True, torch.bfloat16)
    q, k, v, do, out, lse = _dense_bwd_inputs(case)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:]
    shifted = shifted.view(1, 64, 2, 64).transpose(1, 2)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_bwd.flash_attention_bwd(do, shifted, k, v, out, lse, causal=True)
    wide = torch.zeros(1, 64, 2, 68, dtype=q.dtype, device="cuda")
    wide[..., :64] = k.transpose(1, 2)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_bwd.flash_attention_bwd(do, q, wide[..., :64].transpose(1, 2), v,
                                      out, lse, causal=True)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("page_size", [16, 256])
def test_paged_decode_kernel_matches_plain_version_on_the_card(page_size):
    from flash_attn_tpu_torch.kernels import flash_decode

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    b, h, h_k, d, width = 4, 8, 2, 128, -(-600 // page_size)
    kp, vp = randn(b * width + 1, h_k, page_size, d), randn(
        b * width + 1, h_k, page_size, d)
    table = (1 + torch.randperm(b * width, device="cuda", generator=gen)
             ).reshape(b, width).to(torch.int32)
    seqlens = torch.tensor([1, 100, 333, 600], dtype=torch.int32, device="cuda")
    q = randn(b, 1, h, d)
    for splits in (1, 3):
        out_p, lse_p = flash_decode.flash_attention_decode_partials(
            q, kp, vp, seqlens, splits, 1 / math.sqrt(d), True,
            block_table=table)
        ref_p, ref_lse = flash_decode.flash_attention_decode_paged_partials_plain(
            q, kp, vp, seqlens, table, splits, 64, 1 / math.sqrt(d), True)
        fin = torch.isfinite(ref_lse)
        torch.testing.assert_close(out_p, ref_p, atol=2e-2, rtol=0)
        assert torch.equal(torch.isfinite(lse_p), fin)
        torch.testing.assert_close(lse_p[fin], ref_lse[fin], atol=1e-4, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("causal", [False, True])
def test_varlen_paged_kernel_matches_plain_version_on_the_card(causal):
    import numpy as np

    from flash_attn_tpu_torch.kernels import flash_varlen_paged

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    lens_q, lens_k = [100, 0, 256, 7], [300, 40, 256, 519]
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                      dtype=torch.int32, device="cuda")
    q = randn(int(cu[-1]), 8, 128)
    kp, vp = randn(40, 2, 64, 128), randn(40, 2, 64, 128)
    table = (1 + torch.randperm(36, device="cuda", generator=gen)
             ).reshape(4, 9).to(torch.int32)
    seqlens_k = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    out, lse = flash_varlen_paged.flash_attention_varlen_paged_fwd(
        q, kp, vp, cu, 256, seqlens_k, table, causal=causal)
    ref, ref_lse = flash_varlen_paged.flash_attention_varlen_paged_fwd_plain(
        q, kp, vp, cu, 256, seqlens_k, table, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-4, rtol=0)


@pytest.mark.usefixtures("cuda_card")
def test_paged_overflow_poisons_rows_on_the_card():
    """Lengths on the card that overflow the block table give NaN rows (as
    JAX's do under jit) instead of a host read; the other rows are
    finite."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    kp = torch.randn(9, 2, 16, 64, device="cuda", generator=gen).to(
        torch.bfloat16)
    table = torch.arange(1, 9, dtype=torch.int32, device="cuda").reshape(2, 4)
    q = torch.randn(2, 1, 4, 64, device="cuda", generator=gen).to(
        torch.bfloat16)
    lens = torch.tensor([10, 64], dtype=torch.int32, device="cuda")
    out = flash_attn_with_kvcache(q, kp, kp, k=q[:, :, :2], v=q[:, :, :2],
                                  cache_seqlens=lens, block_table=table,
                                  causal=True)
    assert bool(torch.isfinite(out[0]).all()) and bool(torch.isnan(out[1]).all())


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_varlen_kernels_match_plain_versions_on_the_card(causal, d):
    """B6 forward, B7 and the B6 backward against their plain versions with
    a zero-length sequence, seqused_q/k, GQA and a packed tail; B7 gives B6
    forward's bits; the backward gives the same bits twice."""
    import numpy as np

    from flash_attn_tpu_torch.kernels import (
        flash_varlen,
        flash_varlen_persistent,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    lens_q, lens_k = [100, 0, 256, 7, 130], [300, 40, 256, 519, 0]
    cu_q, cu_k = (torch.tensor(np.concatenate([[0], np.cumsum(x)]),
                               dtype=torch.int32, device="cuda")
                  for x in (lens_q, lens_k))
    used_q = torch.tensor([100, 0, 200, 7, 130], dtype=torch.int32,
                          device="cuda")
    used_k = torch.tensor([300, 40, 256, 500, 0], dtype=torch.int32,
                          device="cuda")
    q, do = randn(int(cu_q[-1]) + 9, 8, d), randn(int(cu_q[-1]) + 9, 8, d)
    k, v = randn(int(cu_k[-1]) + 3, 2, d), randn(int(cu_k[-1]) + 3, 2, d)
    args = (cu_q, cu_k, 256, 519, used_q, used_k)
    out, lse = flash_varlen.flash_attention_varlen_fwd(q, k, v, *args,
                                                       causal=causal)
    ref, ref_lse = flash_varlen.flash_attention_varlen_fwd_plain(
        q, k, v, *args, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-4, rtol=0)
    out_p, lse_p = flash_varlen_persistent.flash_attention_varlen_fwd_persistent(
        q, k, v, *args, causal=causal)
    assert torch.equal(out_p, out) and torch.equal(lse_p, lse)
    got = flash_varlen.flash_attention_varlen_bwd(do, q, k, v, out, lse, *args,
                                                  causal=causal)
    want = flash_varlen.flash_attention_varlen_bwd_plain(
        do, q, k, v, out, lse, *args, causal=causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=5e-2, rtol=0)
    again = flash_varlen.flash_attention_varlen_bwd(do, q, k, v, out, lse,
                                                    *args, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("causal", [False, True])
def test_mla_kernels_match_plain_versions_on_the_card(causal):
    """B8p (the paged chunked prefill with qv) and the MLA decode route
    (qv, dv != d, the 576/512 latent view) against their plain versions."""
    from flash_attn_tpu_torch.kernels import flash_decode, flash_paged_prefill

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    b, h, page = 3, 128, 64
    table = (1 + torch.randperm(3 * 6, device="cuda", generator=gen)
             ).reshape(3, 6).to(torch.int32)
    kp, vp = randn(19, 1, page, 64), randn(19, 1, page, 512)
    q, qv = randn(b, 40, h, 64), randn(b, 40, h, 512)
    used = torch.tensor([40, 1, 17], dtype=torch.int32, device="cuda")
    lens = torch.tensor([300, 65, 384], dtype=torch.int32, device="cuda")
    args = (q, kp, vp, used, lens, table)
    out, lse = flash_paged_prefill.flash_attention_paged_prefill(
        *args, qv=qv, causal=causal)
    ref, ref_lse = flash_paged_prefill.flash_attention_paged_prefill_plain(
        *args, qv=qv, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-3, rtol=0)

    scale = 1 / math.sqrt(576)
    qd, qvd = randn(b, 1, h, 64), randn(b, 1, h, 512)
    for splits in (1, 3):
        got = flash_decode.flash_attention_decode_partials(
            qd, kp, vp, lens, splits, scale, causal, block_table=table,
            qv=qvd)
        want = flash_decode.flash_attention_decode_paged_partials_plain(
            qd, kp, vp, lens, table, splits, DECODE_BLOCK_K, scale, causal,
            qv=qvd)
        torch.testing.assert_close(got[0], want[0], atol=2e-2, rtol=0)
        fin = torch.isfinite(want[1])
        assert torch.equal(torch.isfinite(got[1]), fin)
        torch.testing.assert_close(got[1][fin], want[1][fin], atol=1e-3,
                                   rtol=0)
    kc = randn(2, 1, 256, 576)
    lat = torch.tensor([200, 33], dtype=torch.int32, device="cuda")
    ql = randn(2, 1, 16, 576)
    got = flash_decode.flash_attention_decode_partials(
        ql, kc, kc[..., :512], lat, 2, scale, causal)
    want = flash_decode.flash_attention_decode_partials_plain(
        ql, kc, kc[..., :512], lat, 2, DECODE_BLOCK_K, scale, causal)
    torch.testing.assert_close(got[0], want[0], atol=2e-2, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_mla_kernels_narrow_qv_forms_on_the_card(d, dtype):
    """The narrow qv forms (d 64 or 128, dv 128) of both MLA kernels, GQA
    16/2, against their plain versions."""
    from flash_attn_tpu_torch.kernels import flash_decode, flash_paged_prefill

    gen = torch.Generator(device="cuda").manual_seed(d)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    b, h, h_k, dv, page = 3, 16, 2, 128, 16
    table = (1 + torch.randperm(3 * 10, device="cuda", generator=gen)
             ).reshape(3, 10).to(torch.int32)
    kp, vp = randn(31, h_k, page, d), randn(31, h_k, page, dv)
    q, qv = randn(b, 33, h, d), randn(b, 33, h, dv)
    used = torch.tensor([33, 1, 20], dtype=torch.int32, device="cuda")
    lens = torch.tensor([150, 16, 100], dtype=torch.int32, device="cuda")
    args = (q, kp, vp, used, lens, table)
    out, lse = flash_paged_prefill.flash_attention_paged_prefill(*args, qv=qv)
    ref, ref_lse = flash_paged_prefill.flash_attention_paged_prefill_plain(
        *args, qv=qv)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-3, rtol=0)

    scale = 1 / math.sqrt(d + dv)
    qd, qvd = randn(b, 1, h, d), randn(b, 1, h, dv)
    for splits in (1, 2):
        got = flash_decode.flash_attention_decode_partials(
            qd, kp, vp, lens, splits, scale, True, block_table=table,
            qv=qvd)
        want = flash_decode.flash_attention_decode_paged_partials_plain(
            qd, kp, vp, lens, table, splits, DECODE_BLOCK_K, scale, True,
            qv=qvd)
        torch.testing.assert_close(got[0], want[0], atol=2e-2, rtol=0)
        fin = torch.isfinite(want[1])
        assert torch.equal(torch.isfinite(got[1]), fin)
        torch.testing.assert_close(got[1][fin], want[1][fin], atol=1e-3,
                                   rtol=0)


@pytest.mark.usefixtures("cuda_card")
def test_mla_kernels_refuse_other_forms_on_the_card():
    from flash_attn_tpu_torch.kernels import flash_decode, flash_paged_prefill

    q = torch.zeros(1, 1, 4, 576, dtype=torch.bfloat16, device="cuda")
    kc = torch.zeros(1, 1, 64, 576, dtype=torch.bfloat16, device="cuda")
    lens = torch.tensor([8], dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        # a separate V cache of another width, without qv
        flash_decode.flash_attention_decode(q, kc, kc[..., :512].clone(), lens)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_decode.flash_attention_decode(q[..., :96], kc[..., :96],
                                            kc[..., :32], lens)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        # B8p takes only qv forms: the latent view without qv is decode's
        flash_paged_prefill.flash_attention_paged_prefill(
            q, kc, kc[..., :512], lens[:1], lens,
            torch.ones(1, 1, dtype=torch.int32, device="cuda"))


@pytest.mark.usefixtures("cuda_card")
def test_scheduler_metadata_without_cu_seqlens_on_the_card():
    """get_scheduler_metadata without cu_seqlens builds on the card by
    default, and the varlen kernels run with it; the same call with the
    metadata on the CPU is refused."""
    from flash_attn_tpu_torch import flash_attn_varlen_func, get_scheduler_metadata

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, d = 3, 200, 4, 64
    q, k, v = (torch.randn(b * s, h, d, device="cuda", generator=gen).to(
        torch.bfloat16) for _ in range(3))
    cu = torch.arange(b + 1, dtype=torch.int32, device="cuda") * s
    md = get_scheduler_metadata(b, s, s, h, h, d, causal=True)
    assert all(t.device.type == "cuda" for t in md.meta)
    got = flash_attn_varlen_func(q, k, v, cu, cu, s, s, causal=True,
                                 scheduler_metadata=md)
    assert torch.equal(got, flash_attn_varlen_func(q, k, v, cu, cu, s, s,
                                                   causal=True))
    on_cpu = get_scheduler_metadata(b, s, s, h, h, d, causal=True,
                                    device="cpu")
    with pytest.raises(ValueError, match="not on q's device"):
        flash_attn_varlen_func(q, k, v, cu, cu, s, s, causal=True,
                               scheduler_metadata=on_cpu)


def _blocksparse_inputs(gen, b, h, sq, sk, d, dtype, mask, bshd=False):
    """q/do (b, h, sq, d), k/v (b, h, sk, d) on the card (with ``bshd``,
    strided views of (b, s, h, d) tensors) and the mask's lists."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs

    def randn(s):
        x = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
        return x.transpose(1, 2) if bshd else x.transpose(1, 2).contiguous()

    q, k, v, do = randn(sq), randn(sk), randn(sk), randn(sq)
    num, idx = bs.blockmask_to_kv_indices(mask.cuda())
    return q, k, v, do, num, idx


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_blocksparse_kernels_match_plain_versions_on_the_card(causal, d):
    """B10 forward and backward against their plain versions on per-entry
    random masks with an empty row and a duplicated list entry: tiles of
    128 (two 64-key tiles a listed tile), of 64 x 256 in fp16, and sq=200
    over sk=384 (a ragged last q tile, the causal shift) on strided (b, s,
    h, d) views; the backward gives the same bits twice; autograd casts to
    the inputs' type."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs

    gen = torch.Generator(device="cuda").manual_seed(d)
    for dtype, sq, sk, bq, bk, bshd in (
            (torch.bfloat16, 512, 512, 128, 128, False),
            (torch.float16, 512, 512, 64, 256, False),
            (torch.bfloat16, 200, 384, 64, 128, True)):
        nq, nk = -(-sq // bq), sk // bk
        mask = torch.rand(2, nq, nk, generator=torch.Generator().manual_seed(
            d)) < 0.5
        mask[:, :, 0] = True
        mask[0, 0, -1] = False
        mask[1, 1] = False  # an empty row
        q, k, v, do, num, idx = _blocksparse_inputs(gen, 2, 4, sq, sk, d,
                                                    dtype, mask, bshd)
        idx[0, 0, num[0, 0]] = idx[0, 0, 0]  # listed twice
        num[0, 0] += 1
        kw = dict(causal=causal, block_q=bq, block_k=bk)
        out, lse = bs.flash_attention_blocksparse_fwd(q, k, v, num, idx, **kw)
        ref, ref_lse = bs.flash_attention_blocksparse_fwd_plain(
            q, k, v, num, idx, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
        fin = torch.isfinite(ref_lse)
        assert torch.equal(torch.isfinite(lse), fin)
        torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-3, rtol=0)
        assert not out[1, :, bq:2 * bq].any()
        got = bs.flash_attention_blocksparse_bwd(do, q, k, v, out, lse, num,
                                                 idx, **kw)
        want = bs.flash_attention_blocksparse_bwd_plain(do, q, k, v, out, lse,
                                                        num, idx, **kw)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            torch.testing.assert_close(g, w, atol=5e-2, rtol=0)
        again = bs.flash_attention_blocksparse_bwd(do, q, k, v, out, lse, num,
                                                   idx, **kw)
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
        assert not got[0][1, :, bq:2 * bq].any()
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        bs.flash_attention_blocksparse(*leaves, num, idx, **kw).backward(do)
        for leaf, g in zip(leaves, got):
            assert leaf.grad.dtype == dtype
            assert torch.equal(leaf.grad, g.to(dtype))


@pytest.mark.usefixtures("cuda_card")
def test_blocksparse_kernels_refuse_other_forms_on_the_card():
    """d != dv, fp32 and tiles that are not multiples of 64 are forms JAX
    takes and the kernels do not (queue A, item 7); lists on the CPU would
    hand a kernel host pointers."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs

    gen = torch.Generator(device="cuda").manual_seed(0)
    mask = torch.ones(2, 2, dtype=torch.bool)
    q, k, v, _, num, idx = _blocksparse_inputs(gen, 1, 2, 256, 256, 64,
                                               torch.bfloat16, mask)
    kw = dict(block_q=128, block_k=128)
    with pytest.raises(ValueError, match="queue A, item 7"):
        bs.flash_attention_blocksparse_fwd(q, k, torch.cat([v, v], -1), num,
                                           idx, **kw)
    with pytest.raises(ValueError, match="queue A, item 7"):
        bs.flash_attention_blocksparse_fwd(q.float(), k.float(), v.float(),
                                           num, idx, **kw)
    with pytest.raises(ValueError, match="queue A, item 7"):
        bs.flash_attention_blocksparse_fwd(q[:, :, :40], k, v, num, idx,
                                           block_q=32, block_k=128)
    with pytest.raises(ValueError, match="int32 on q's device"):
        bs.flash_attention_blocksparse_fwd(q, k, v, num.cpu(), idx, **kw)
    out, lse = bs.flash_attention_blocksparse_fwd(q, k, v, num, idx, **kw)
    with pytest.raises(ValueError, match="int32 on q's device"):
        bs.flash_attention_blocksparse_bwd(q, q, k, v, out, lse, num,
                                           idx.long(), **kw)


@pytest.mark.usefixtures("cuda_card")
def test_probes_match_plain_versions_on_the_card():
    """The shared-memory probe takes 227 KB and refuses more, and its
    output is the plain one; the overlap probe's chains equal their plain
    versions in every mode."""
    from flash_attn_tpu_torch.probes import mma_exp2_overlap_probe as ov
    from flash_attn_tpu_torch.probes import smem_probe as sm

    rows = {r["kb"]: r for r in sm.run((48, 227, 228))}
    assert rows[48]["accepted"] and rows[227]["accepted"]
    assert not rows[228]["accepted"]
    assert rows[48]["max_abs_err"] == rows[227]["max_abs_err"] == 0.0
    assert rows[227]["blocks_per_sm"] == 1
    for mode in ov.MODES:
        for got, want in zip(ov.overlap_probe(mode, 64),
                             ov.overlap_probe_plain(mode, 64)):
            torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
