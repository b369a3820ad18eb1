"""Package-level checks of the port (flash_attn_tpu_torch): what it
imports, what it refuses, and, on a CUDA card, each kernel against its
plain version (this file imports no JAX, so that these run on the card:
``python3 -m pytest --noconftest tests/test_torch_package.py``)."""

import itertools
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
from flash_attn_tpu_torch.utils.cases import (
    DV_CASES,
    BAND_BWD_CASES,
    BAND_DECODE_CASES,
    BAND_FWD_CASES,
    BAND_VARLEN_CASE,
    HD80_BAND_BWD_CASES,
    HD80_BAND_DECODE_CASES,
    HD80_BAND_FWD_CASES,
    HD80_BWD_CASES,
    HD80_FWD_CASES,
    HD80_KVQUANT_DECODE_CASES,
    HD80_KVQUANT_VARLEN_CASES,
    HD80_SCORE_BWD_CASES,
    HD80_SCORE_DECODE_CASES,
    HD80_SCORE_FWD_CASES,
    HD80_VARLEN_CASES,
    KVQUANT_DECODE_CASES,
    KVQUANT_VARLEN_CASES,
    MISTRAL_WINDOW,
    SCORE_BWD_CASES,
    SCORE_DECODE_CASES,
    SCORE_FWD_CASES,
    SCORE_VARLEN_CASES,
    SINK_FWD_CASES,
    SINK_VARLEN_CASES,
    VARLEN_CASES,
    kv_codes,
    kv_descales,
    case_scale,
    dv_case_scale,
    score_slopes,
    sink_logits,
)

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
    dict(dropout_p=0.1), dict(aux_tensors=(torch.ones(1),)),
    dict(q_descale=torch.ones(1)), dict(mask_mod=lambda *a: True),
    dict(qv=torch.ones(1, 8, 2, 64), k_descale=torch.ones(1, 2)),
    dict(score_mod=lambda s, *a: s)])
def test_flash_attn_func_rejects_unported_options(kwargs):
    """Each raises before the forward runs (the band trains:
    tests/test_torch_band_backward.py; softcap and ALiBi too:
    tests/test_torch_score_backward.py; the learnable sink too:
    tests/test_torch_learnable_sink.py; qv without descales too:
    tests/test_torch_head_dims_192_128.py, so qv stands here with the
    descales of JAX's forward-only fp8 route)."""
    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    with pytest.raises(NotImplementedError):
        flash_attn_func(q, q, q, **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(rotary_seqlens=torch.zeros(1, dtype=torch.int32)),
    dict(cache_batch_idx=torch.zeros(1, dtype=torch.int32)),
    dict(cache_leftpad=torch.zeros(1, dtype=torch.int32)),
    # descales run on the d = dv route; on the MLA route (qv) they are
    # still item 7
    dict(k_descale=torch.ones(1, 2), qv=torch.randn(1, 1, 2, 64))])
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
    """The parallel options are still unported (queue A item 8); quantized
    caches build (tests/test_torch_kvquant.py), but not beside softcap,
    whose first decode step JAX's kernel refuses; ALiBi and softcap serve
    (tests/test_torch_alibi_models.py)."""
    for opt in ("context_parallel", "sequence_parallel"):
        with pytest.raises(NotImplementedError, match=f"{opt}.*item 8"):
            GPTLMHeadModel(GPTConfig(n_positions=0, n_layer=1, **{opt: True}),
                           device="cpu")
    small = dict(vocab_size=64, n_positions=0, n_embd=32, n_layer=1,
                 n_head=2, kv_cache_dtype=torch.float8_e4m3fn)
    model = GPTLMHeadModel(GPTConfig(**small), device="cpu")
    assert model.allocate_cache(2)[0].k.dtype == torch.float8_e4m3fn
    with pytest.raises(ValueError, match="softcap"):
        GPTLMHeadModel(GPTConfig(softcap=30.0, **small), device="cpu")


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


@pytest.mark.parametrize("source", ["flash_bwd.cu", "flash_varlen.cu",
                                    "flash_blocksparse.cu"])
def test_dense_backward_sources_use_wgmma_and_tma(source):
    """The dense backward (csrc/flash_bwd.cu), the packed-varlen backward
    (csrc/flash_varlen.cu) and the block-sparse backward
    (csrc/flash_blocksparse.cu), with the headers they include, run their
    products on wgmma and load their tiles asynchronously by TMA (the shared
    tiles of bwd_sm90.cuh), and none names the retired mma.sync loops of
    bwd_tile.cuh."""
    text = _included_sources(PKG / "csrc" / source)
    assert "wgmma.mma_async" in text
    assert "cp.async.bulk.tensor" in text and "cp.async.bulk.shared" in text
    assert "bwd_sm90.cuh" in re.findall(r'^#include "([^"]+)"', text,
                                        re.MULTILINE)
    assert "bwd_tile.cuh" not in text


def test_decode_source_copies_tiles_by_bulk_copies_under_mbarriers():
    """The d = dv decode route (csrc/flash_decode.cu and flash_decode_kv8.cu
    with their headers) moves its K/V tiles by cp.async.bulk into shared
    memory, each stage completed by an mbarrier (expect_tx, then a wait on
    its phase), not by loads of its threads; the kernel itself is
    csrc/flash_decode.cuh, which both sources instantiate."""
    for src in ("flash_decode.cu", "flash_decode_kv8.cu"):
        text = _included_sources(PKG / "csrc" / src)
        assert "cp.async.bulk" in text
        assert "mbarrier.arrive.expect_tx" in text
        assert "mbarrier.try_wait" in text
    own = (PKG / "csrc" / "flash_decode.cuh").read_text()
    assert "tma_load_4d(" in own and "mbar_wait(" in own
    assert "__ldg(" not in own


def test_only_the_blocksparse_backward_keeps_bwd_tile():
    """The block-sparse backward (B10), the last holder of bwd_tile.cuh's
    mma.sync loops, now includes the wgmma tiles of bwd_sm90.cuh and drives
    both of them (bwd_dkdv, bwd_dq) with its list walk: bwd_tile.cuh is
    gone and nothing keeps it."""
    assert not (PKG / "csrc" / "bwd_tile.cuh").exists()
    text = (PKG / "csrc" / "flash_blocksparse.cu").read_text()
    assert "bwd_sm90.cuh" in re.findall(r'^#include "([^"]+)"', text,
                                        re.MULTILINE)
    assert "bwd_dkdv<" in text and "bwd_dq<" in text
    assert "ListWalk{" in text


@pytest.mark.parametrize("header", ["fwd_tile.cuh", "bwd_tile.cuh"])
def test_mma_sync_tiles_are_retired(header):
    """Neither old mma.sync tile header exists or is included (or named) by
    any source; mma.sync itself is left only in the overlap probe
    (probes.cu) and the common.cuh it includes."""
    csrc = PKG / "csrc"
    assert not (csrc / header).exists()
    sources = sorted(f for f in csrc.iterdir() if f.suffix in (".cu", ".cuh"))
    assert sources
    assert not [f.name for f in sources if header in f.read_text()]
    holders = [f.name for f in sources if "mma.sync" in f.read_text()]
    assert holders == ["common.cuh", "probes.cu"], holders
    assert "common.cuh" in re.findall(r'^#include "([^"]+)"',
                                      (csrc / "probes.cu").read_text(),
                                      re.MULTILINE)


@pytest.mark.parametrize("source", ["flash_fwd.cu", "flash_varlen_fwd.cu",
                                    "flash_paged_prefill.cu",
                                    "flash_decode_mla.cu",
                                    "flash_varlen_paged.cu",
                                    "flash_blocksparse.cu"])
def test_forward_sources_use_wgmma_and_tma(source):
    """B1, B6's forward and B7, B8p, the MLA decode route, B8 and B10 (with
    the headers they include) run both products on wgmma and load their
    tiles by TMA; none includes the retired mma.sync tile loop of
    fwd_tile.cuh."""
    text = _included_sources(PKG / "csrc" / source)
    assert "wgmma.mma_async" in text
    assert "cp.async.bulk.tensor" in text
    assert "fwd_tile.cuh" not in re.findall(r'^#include "([^"]+)"', text,
                                            re.MULTILINE)


@pytest.mark.parametrize("source, header", [
    ("flash_varlen_fwd.cu", "fwd_sm90.cuh"),
    ("flash_varlen_paged.cu", "fwd_sm90.cuh"),
    ("flash_blocksparse.cu", "fwd_sm90.cuh")])
def test_old_forward_tile_still_serves_b7_b8_and_b10(source, header):
    """B7 sits beside B6's forward on the wgmma tile of fwd_sm90.cuh, and so
    do B8 with its paged source and the block-sparse forward (B10), which
    runs the tile's pieces over its list walk: the old mma.sync tile loop of
    fwd_tile.cuh serves none of them any more."""
    text = (PKG / "csrc" / source).read_text()
    assert header in re.findall(r'^#include "([^"]+)"', text, re.MULTILINE)
    if source == "flash_varlen_fwd.cu":
        assert "varlen_fwd_persistent_kernel" in text
        assert "fa_varlen_fwd_persistent" not in (
            PKG / "csrc" / "flash_varlen.cu").read_text()
    if source == "flash_blocksparse.cu":
        assert "fwd_step<" in text and "fwd_epilogue<" in text


def test_paged_prefill_no_longer_includes_the_mla_tile():
    """B8p and the MLA decode route share the wgmma tile of mla_sm90.cuh;
    the mma.sync loop of mla_tile.cuh is gone and no source includes it."""
    sources = sorted((PKG / "csrc").glob("*.cu*"))
    for f in sources:
        assert "mla_tile.cuh" not in re.findall(
            r'^#include "([^"]+)"', f.read_text(), re.MULTILINE), f.name
    assert not (PKG / "csrc" / "mla_tile.cuh").exists()
    for source in ("flash_paged_prefill.cu", "flash_decode_mla.cu"):
        assert "mla_sm90.cuh" in re.findall(
            r'^#include "([^"]+)"', (PKG / "csrc" / source).read_text(),
            re.MULTILINE)


@pytest.mark.parametrize("bq, bk, kind", [
    (128, 128, "causal"), (128, 128, "local"), (128, 64, "random"),
    (64, 256, "random"), (192, 128, "causal")])
def test_blocksparse_dkdv_order_covers_each_pair_once_heaviest_first(
        bq, bk, kind):
    """dkdv_order over the inverse lists (the preprocess kernel's plain
    version): every 128-key block once, so that each (64-key half, q tile
    that lists its caller tile) pair is walked once, the q tiles ascending
    within a half, the blocks by the q tiles they walk, heaviest first (ties
    in index order); the full causal mask's column 0 leads and no block is
    split or repeated."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs

    b, sq, sk = 2, 512, 1024
    nq, nk = -(-sq // bq), sk // bk
    i = torch.arange(nq)[:, None] * bq
    j = torch.arange(nk)[None, :] * bk
    if kind == "causal":
        mask = (j <= i + bq - 1).expand(b, nq, nk)
    elif kind == "local":
        mask = (((j <= i + bq - 1) & (j > i - 4 * bk)) | (j == 0)).expand(
            b, nq, nk)
    else:
        mask = torch.rand(b, nq, nk, generator=torch.Generator().manual_seed(
            bk)) < 0.4
    num, idx = bs.blockmask_to_kv_indices(mask)
    q_num, q_idx = bs.kv_to_q_lists(num, idx, nk)
    order = bs.dkdv_order(q_num, bk, sk)
    blocks = sk // 128
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(b * blocks))
    weights = []
    for blk in order.tolist():
        bb, kb = divmod(blk, blocks)
        cols = sorted({(kb * 128 + 64 * half) // bk for half in (0, 1)})
        walked = 0
        for c in cols:
            listed = q_idx[bb, c, :q_num[bb, c]]
            assert torch.equal(listed, listed.sort().values)
            assert listed.tolist() == mask[bb, :, c].nonzero()[:, 0].tolist()
            walked += len(listed)
        weights.append(walked)
    assert weights == sorted(weights, reverse=True)
    ranked = list(zip(weights, order.tolist()))
    assert all(o1 < o2 for (w1, o1), (w2, o2) in zip(ranked, ranked[1:])
               if w1 == w2)
    if kind == "causal":
        assert order[0] == 0


def test_host_tensor_map_helpers_have_one_copy():
    """The driver's tensor-map encoder is looked up, and a tile map built,
    in csrc/sm90.cuh alone."""
    for needle in ("cudaGetDriverEntryPoint(", "cudaError_t make_tile_map("):
        holders = [f.name for f in sorted((PKG / "csrc").iterdir())
                   if f.suffix in (".cu", ".cuh") and needle in f.read_text()]
        assert holders == ["sm90.cuh"], (needle, holders)


def test_forward_tiles_in_the_config():
    """FWD_TILE is the wgmma tile of B1, B6's forward and B7 (128 rows by 64
    keys), and get_scheduler_metadata builds its schedule for it; the
    backward's lists are on VARLEN_BWD_TILE's 128-row and 128-key tiles (B3's
    wgmma tiles, DENSE_BWD_TILES), the dQ kernel walking the schedule."""
    from flash_attn_tpu_torch import get_scheduler_metadata
    from flash_attn_tpu_torch.dispatch.config import (
        DENSE_BWD_TILES,
        FWD_TILE,
        VARLEN_BWD_TILE,
    )

    assert (FWD_TILE.block_q, FWD_TILE.block_k) == (128, 64)
    assert (VARLEN_BWD_TILE.block_q, VARLEN_BWD_TILE.block_k) == (128, 128)
    assert VARLEN_BWD_TILE.block_q == DENSE_BWD_TILES[1].block_q == FWD_TILE.block_q
    assert VARLEN_BWD_TILE.block_k == DENSE_BWD_TILES[0].block_k
    md = get_scheduler_metadata(3, 200, 200, 4, 2, 64, causal=True,
                                device="cpu")
    assert (md.block_q, md.block_k) == (128, 64)
    assert md.num_q_tiles == 3 * 2 and md.meta.schedule.shape[0] == 6
    assert md.meta.q_tiles.shape[0] == 6 and md.num_k_tiles == 6
    assert md.meta.k_schedule.shape[0] == 6


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


# B1 at the head dims only the forward and decode kernels take (GPT-NeoX-20B's
# 96, GPT-J's 256): the edges of the tiles, MQA and GQA, fp16.
FWD_WIDE_DIM_CASES = [
    (2, 200, 300, 4, 2, 96, True, torch.bfloat16),
    (1, 129, 129, 4, 4, 96, False, torch.float16),
    (2, 63, 65, 4, 1, 256, True, torch.bfloat16),
    (1, 200, 129, 2, 2, 256, True, torch.float16),
    (1, 300, 300, 2, 2, 256, False, torch.bfloat16),
]


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", DENSE_BWD_EDGE_CASES + FWD_WIDE_DIM_CASES)
def test_dense_forward_edge_shapes_on_the_card(case):
    """B1 on the edges of its 128-row and 64-key tiles, at every head dim
    it takes, against the plain fp32 forward under the 2x rule
    (attention_ref in the inputs' type as the low-precision reference),
    lse within 1e-3, and the same bits twice."""
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
    )

    causal = case[6]
    q, k, v, _, out, lse = _dense_bwd_inputs(case)
    ref, ref_lse = flash_fwd.flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), causal=causal)
    ref_lp, _ = attention_ref(*(x.transpose(1, 2) for x in (q, k, v)),
                              causal=causal, upcast=False)
    assert out.dtype == q.dtype and out.shape == ref.shape
    check_against_ref(out.transpose(1, 2), ref.transpose(1, 2), ref_lp,
                      msg=f"flash_fwd {case}")
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-3, rtol=0)
    again = flash_fwd.flash_attention_fwd(q, k, v, causal=causal)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.usefixtures("cuda_card")
def test_dense_forward_refuses_misaligned_views_on_the_card():
    """TMA needs 16-byte aligned starts and strides: a view that breaks
    either raises ValueError, and nothing is copied quietly."""
    from flash_attn_tpu_torch.kernels import flash_fwd

    case = (1, 64, 64, 2, 2, 64, True, torch.bfloat16)
    q, k, v, _, _, _ = _dense_bwd_inputs(case)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:]
    shifted = shifted.view(1, 64, 2, 64).transpose(1, 2)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_fwd.flash_attention_fwd(shifted, k, v, causal=True)
    wide = torch.zeros(1, 64, 2, 68, dtype=q.dtype, device="cuda")
    wide[..., :64] = v.transpose(1, 2)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_fwd.flash_attention_fwd(q, k, wide[..., :64].transpose(1, 2),
                                      causal=True)


# The backward's tiles at 96 (two panels, the second zero-filled past
# column 96) and 256 (64-row blocks whose warpgroups split the columns):
# key counts that are not a multiple of the 64-key tile (a stale panel where
# TMA should fill zeros would show in columns 64-95), sq > sk, sq != sk,
# one row, MQA and GQA, fp16.
BWD_WIDE_DIM_CASES = [
    (2, 200, 300, 4, 2, 96, True, torch.bfloat16),
    (1, 129, 129, 4, 4, 96, False, torch.float16),
    (1, 1, 1, 2, 1, 96, True, torch.bfloat16),
    (2, 63, 65, 4, 1, 256, True, torch.bfloat16),
    (1, 200, 129, 2, 2, 256, True, torch.float16),
    (1, 300, 300, 2, 2, 256, False, torch.bfloat16),
    (2, 129, 200, 8, 2, 256, True, torch.bfloat16),
]


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("case", DENSE_BWD_EDGE_CASES + BWD_WIDE_DIM_CASES)
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
@pytest.mark.parametrize("d", [96, 256])
def test_wide_dense_backward_is_bitwise_deterministic_on_the_card(d):
    """B3 at 96 and 256 gives the same bits twice, and flash_attn_func's
    backward there launches one forward, preprocess, dK/dV and dQ (or, not
    deterministic, one fused pass), with the gradients of B3 itself."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd

    case = (2, 300, 300, 8, 2, d, True, torch.bfloat16)
    q, k, v, do, out, lse = _dense_bwd_inputs(case, seed=d)
    first = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse, causal=True)
    again = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse, causal=True)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, again))
    for det in (True, False):
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        counts = (flash_fwd.launches, flash_bwd.launches_preprocess,
                  flash_bwd.launches_dkdv, flash_bwd.launches_dq,
                  flash_bwd.launches_fused)
        flash_attn_func(*leaves, causal=True,
                        deterministic=det).backward(do.transpose(1, 2))
        after = (flash_fwd.launches, flash_bwd.launches_preprocess,
                 flash_bwd.launches_dkdv, flash_bwd.launches_dq,
                 flash_bwd.launches_fused)
        assert [a - b_ for a, b_ in zip(after, counts)] == \
            [1, 1, int(det), int(det), int(not det)]
        if det:
            for leaf, g in zip(leaves, first):
                assert torch.equal(leaf.grad, g.transpose(1, 2))


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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_varlen_kernels_match_plain_versions_on_the_card(causal, d, dtype):
    """B6 forward, B7 and the B6 backward against their plain versions with
    a zero-length sequence, a sequence with no keys, lengths either side of
    the 128-row tiles, seqused_q/k, GQA 16/4 and a packed tail, with NaN in
    every row outside the sequences (no tile may sum them); B6's forward and
    B7 each give the same bits twice; the backward gives the same bits
    twice and zeros in the rows outside the sequences."""
    import numpy as np

    from flash_attn_tpu_torch.kernels import (
        flash_varlen,
        flash_varlen_persistent,
    )
    from flash_attn_tpu_torch.utils.testing import (
        attention_varlen_ref_grads,
        check_against_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    lens_q = [100, 0, 256, 7, 130, 127, 129]
    lens_k = [300, 40, 256, 519, 0, 129, 127]
    used_q = [100, 0, 200, 7, 130, 127, 129]
    used_k = [300, 40, 256, 500, 0, 129, 127]

    def packed(lens, used, tail, h):
        """Rows of the packed sequences, NaN past each one's used rows and
        in the tail."""
        live = torch.zeros(sum(lens) + tail, dtype=torch.bool, device="cuda")
        for lo, n in zip(np.concatenate([[0], np.cumsum(lens)]), used):
            live[lo:lo + n] = True
        x = torch.randn(live.numel(), h, d, device="cuda", generator=gen)
        return torch.where(live[:, None, None], x, float("nan")).to(dtype), live

    (q, live_q), (do, _) = packed(lens_q, used_q, 9, 16), packed(lens_q, used_q, 9, 16)
    (k, live_k), (v, _) = packed(lens_k, used_k, 3, 4), packed(lens_k, used_k, 3, 4)
    cu_q, cu_k = (torch.tensor(np.concatenate([[0], np.cumsum(x)]),
                               dtype=torch.int32, device="cuda")
                  for x in (lens_q, lens_k))
    args = (cu_q, cu_k, 256, 519,
            torch.tensor(used_q, dtype=torch.int32, device="cuda"),
            torch.tensor(used_k, dtype=torch.int32, device="cuda"))
    ref, ref_lse = flash_varlen.flash_attention_varlen_fwd_plain(
        q, k, v, *args, causal=causal)
    fin = torch.isfinite(ref_lse)
    for fwd in (flash_varlen.flash_attention_varlen_fwd,
                flash_varlen_persistent.flash_attention_varlen_fwd_persistent):
        out, lse = fwd(q, k, v, *args, causal=causal)
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=0)
        assert torch.equal(torch.isfinite(lse), fin)
        torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-4, rtol=0)
        again = fwd(q, k, v, *args, causal=causal)
        assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    got = flash_varlen.flash_attention_varlen_bwd(do, q, k, v, out, lse, *args,
                                                  causal=causal)
    # the 2x rule (utils/testing.py): against the plain fp32 backward, with
    # autograd through the per-sequence reference in the inputs' type as the
    # low-precision one
    want = flash_varlen.flash_attention_varlen_bwd_plain(
        do.float(), q.float(), k.float(), v.float(), out.float(), lse, *args,
        causal=causal)
    lp = attention_varlen_ref_grads(q, k, v, do, cu_q, cu_k, *args[4:],
                                    causal=causal, upcast=False)
    for name, g, w, r in zip("qkv", got, want, lp):
        check_against_ref(g, w, r, atol=1e-4, msg=f"d{name}")
    for g, live in zip(got, (live_q, live_k, live_k)):
        assert not g[~live].any()
    again = flash_varlen.flash_attention_varlen_bwd(do, q, k, v, out, lse,
                                                    *args, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# B6's backward against B3 over the same rows (b, s, h, h_k, d, causal,
# dtype): b equal-length sequences packed run the tiles of bwd_sm90.cuh over
# the same rows as the dense batch, so the bits must agree: lengths either
# side of the 64- and 128-row tiles, GQA, every head dim, fp16.
VARLEN_DENSE_BWD_CASES = [
    (3, 300, 16, 4, 128, True, torch.bfloat16),
    (2, 256, 8, 8, 64, False, torch.float16),
    (4, 129, 4, 2, 128, True, torch.bfloat16),
    (2, 63, 16, 16, 64, True, torch.bfloat16),
    (3, 300, 8, 4, 96, True, torch.bfloat16),
    (2, 129, 4, 4, 96, False, torch.float16),
    (3, 200, 4, 2, 256, True, torch.bfloat16),
    (2, 129, 4, 4, 256, False, torch.float16),
    (3, 300, 8, 4, 80, True, torch.bfloat16),
    (2, 129, 4, 4, 80, False, torch.float16),
]


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", VARLEN_DENSE_BWD_CASES)
def test_varlen_backward_equals_dense_backward_on_the_card(case):
    """B6's backward over b equal-length sequences packed gives B3's dq, dk
    and dv over the same (b, s) rows, bit for bit, and its preprocess the
    dense preprocess's delta and lse2 on every row of the sequences."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_varlen

    b, s, h, h_k, d, causal, dtype = case
    q, k, v, do, out, lse = _dense_bwd_inputs(
        (b, s, s, h, h_k, d, causal, dtype), seed=s)
    dense = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse,
                                          causal=causal, deterministic=True)
    cu = torch.arange(b + 1, dtype=torch.int32, device="cuda") * s
    packed = [x.transpose(1, 2).reshape(b * s, x.shape[1], d)
              for x in (do, q, k, v, out)]
    lse_p = lse.permute(1, 0, 2).reshape(h, b * s)
    varlen = flash_varlen.flash_attention_varlen_bwd(
        *packed, lse_p, cu, cu, s, s, causal=causal)
    for name, g, g6 in zip("qkv", dense, varlen):
        assert torch.equal(g.transpose(1, 2).reshape(g6.shape), g6), name
    meta = flash_varlen.varlen_meta(packed[1], packed[2], cu, cu, s, s, None,
                                    None, causal, None)
    grads = [torch.empty_like(x) for x in packed[1:4]]
    delta, lse2 = flash_varlen.varlen_bwd_preprocess(
        packed[0], packed[4], lse_p.contiguous(), cu, cu, meta, *grads)
    want_delta, want_lse2 = flash_bwd.bwd_preprocess(do, out, lse)
    for i in range(b):
        p0 = flash_varlen.padded_row(i * s, i)
        assert torch.equal(delta[:, p0:p0 + s], want_delta[i, :, :s])
        assert torch.equal(lse2[:, p0:p0 + s], want_lse2[i, :, :s])


@pytest.mark.usefixtures("cuda_card")
def test_varlen_backward_refuses_views_tma_cannot_take_on_the_card():
    """The varlen backward reads by TMA: a view whose start is not 16-byte
    aligned, or whose strides are not multiples of 16 bytes, raises
    ValueError."""
    from flash_attn_tpu_torch.kernels import flash_varlen

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(128, 4, 64, device="cuda", generator=gen).to(
        torch.bfloat16) for _ in range(4))
    cu = torch.tensor([0, 50, 128], dtype=torch.int32, device="cuda")
    out, lse = flash_varlen.flash_attention_varlen_fwd(q, k, v, cu, cu, 78,
                                                       78, causal=True)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:]
    shifted = shifted.view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_varlen.flash_attention_varlen_bwd(do, shifted, k, v, out, lse,
                                                cu, cu, 78, 78, causal=True)
    wide = torch.zeros(128, 4, 68, dtype=q.dtype, device="cuda")
    wide[..., :64] = k
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_varlen.flash_attention_varlen_bwd(do, q, wide[..., :64], v, out,
                                                lse, cu, cu, 78, 78,
                                                causal=True)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
def test_persistent_varlen_forward_equals_b6_on_the_card(causal, d):
    """B7 against B6's forward bit for bit (two Q tiles a block at d = 64,
    one at 128), over a work list of more than 3 x its grid's items (so that blocks walk three
    or more items): lengths 1, 127, 129 and 0, seqused_q/k, GQA 16/4, a
    packed tail; and against its plain version at B6's tolerance, twice
    bitwise."""
    import numpy as np

    from flash_attn_tpu_torch.kernels import (
        flash_varlen,
        flash_varlen_persistent,
    )

    gen = torch.Generator(device="cuda").manual_seed(d + causal)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    lens_q = [1, 127, 129, 0, 700] + [300, 520, 64, 1000] * 3
    lens_k = [1, 129, 127, 40, 700] + [300, 300, 900, 1000] * 3
    used_q = list(lens_q)
    used_q[4] = 650
    used_k = list(lens_k)
    used_k[5] = 250
    cu_q, cu_k = (torch.tensor(np.concatenate([[0], np.cumsum(x)]),
                               dtype=torch.int32, device="cuda")
                  for x in (lens_q, lens_k))
    used_q, used_k = (torch.tensor(x, dtype=torch.int32, device="cuda")
                      for x in (used_q, used_k))
    h, h_k = 16, 4
    q = randn(int(cu_q[-1]) + 5, h, d)
    k, v = randn(int(cu_k[-1]), h_k, d), randn(int(cu_k[-1]), h_k, d)
    args = (cu_q, cu_k, max(lens_q), max(lens_k), used_q, used_k)
    b6 = flash_varlen.flash_attention_varlen_fwd(q, k, v, *args,
                                                 causal=causal)
    b7 = flash_varlen_persistent.flash_attention_varlen_fwd_persistent(
        q, k, v, *args, causal=causal)
    grid = flash_varlen_persistent.last_grid
    live = sum(-(-u // 128) for u in used_q.tolist()) * h
    assert live > 3 * grid, (live, grid)
    assert torch.equal(b7[0], b6[0]) and torch.equal(b7[1], b6[1])
    again = flash_varlen_persistent.flash_attention_varlen_fwd_persistent(
        q, k, v, *args, causal=causal)
    assert torch.equal(again[0], b7[0]) and torch.equal(again[1], b7[1])
    ref, ref_lse = flash_varlen_persistent.flash_attention_varlen_fwd_persistent_plain(
        q, k, v, *args, causal=causal)
    torch.testing.assert_close(b7[0].float(), ref.float(), atol=2e-2, rtol=0)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(b7[1]), fin)
    torch.testing.assert_close(b7[1][fin], ref_lse[fin], atol=1e-4, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
def test_varlen_forwards_equal_dense_forward_on_the_card(causal, d):
    """B6's forward and B7 over b equal-length sequences packed give B1's
    out and lse over the same (b, s) rows, bit for bit (the three run the
    tile of fwd_sm90.cuh over the same rows), at a length that is not a
    multiple of the 64-key tile."""
    from flash_attn_tpu_torch.kernels import (
        flash_fwd,
        flash_varlen,
        flash_varlen_persistent,
    )

    b, s, h, h_k = 3, 300, 8, 4
    q, k, v, _, out, lse = _dense_bwd_inputs(
        (b, s, s, h, h_k, d, causal, torch.bfloat16), seed=d)
    cu = torch.arange(b + 1, dtype=torch.int32, device="cuda") * s
    packed = [x.transpose(1, 2).reshape(b * s, x.shape[1], d)
              for x in (q, k, v)]
    for fwd in (flash_varlen.flash_attention_varlen_fwd,
                flash_varlen_persistent.flash_attention_varlen_fwd_persistent):
        o6, l6 = fwd(*packed, cu, cu, s, s, causal=causal)
        assert torch.equal(o6, out.transpose(1, 2).reshape(b * s, h, d))
        assert torch.equal(l6, lse.transpose(0, 1).reshape(h, b * s))
    assert flash_fwd.launches > 0


# B8p edge cases (h, h_k, d, dv, page, chunk rows, seqused_q, cached keys
# before the chunk, causal, dtype): pages of 16, 64 and 256 (and 4, under a
# box of 4 rows), a one-row chunk, rows past seqused_q, GQA 8/2 whose tiles
# span 16 positions, a chunk that starts mid-page, non-causal.
PAGED_PREFILL_EDGE_CASES = [
    (128, 1, 64, 512, 16, [1, 77, 200], [1, 60, 200], [500, 0, 300], True,
     torch.bfloat16),
    (128, 1, 64, 512, 64, [130, 3], [100, 3], [37, 64], True,
     torch.bfloat16),
    (128, 1, 64, 512, 256, [1, 256], [1, 256], [511, 100], False,
     torch.bfloat16),
    (8, 2, 64, 128, 64, [100, 37, 1], [90, 37, 1], [200, 5, 0], True,
     torch.float16),
    (16, 2, 128, 128, 16, [64, 130], [64, 129], [100, 0], True,
     torch.bfloat16),
    (8, 2, 128, 128, 4, [50, 9], [50, 9], [13, 70], True, torch.bfloat16),
]


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", PAGED_PREFILL_EDGE_CASES)
def test_paged_prefill_edge_cases_on_the_card(case):
    """B8p over packed rows against its plain version: every form, pages of
    4 to 256, a one-row chunk, seqused_q below the chunk, GQA tiles that span
    positions, and NaN in every page slot the sequences do not reference
    (past cache_seqlens, and the pages the table points past), which must
    not reach the output; the kernel gives the same bits twice."""
    from flash_attn_tpu_torch.kernels import flash_paged_prefill as fpp

    h, h_k, d, dv, page, chunk, used, cached, causal, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(len(chunk) + page)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    lens_k = [c + u for c, u in zip(cached, used)]
    width = max(-(-(c + n) // page) for c, n in zip(cached, chunk)) + 2
    num_pages = len(chunk) * width + 1
    table = torch.randperm(num_pages - 1, device="cuda", generator=gen)[
        :len(chunk) * width].reshape(len(chunk), width).to(torch.int32)
    kp, vp = randn(num_pages, h_k, page, d), randn(num_pages, h_k, page, dv)
    valid = torch.zeros(num_pages, page, dtype=torch.bool, device="cuda")
    for s, n in enumerate(lens_k):
        for key in range(n):
            valid[table[s, key // page], key % page] = True
    hole = ~valid[:, None, :, None]
    kp, vp = (torch.where(hole, float("nan"), x) for x in (kp, vp))
    table[:, -1] = num_pages - 1  # a page no sequence's keys reach
    cu = torch.tensor([0] + list(itertools.accumulate(chunk)),
                      dtype=torch.int32, device="cuda")
    q, qv = randn(int(cu[-1]), h, d), randn(int(cu[-1]), h, dv)
    seqused = torch.tensor(used, dtype=torch.int32, device="cuda")
    seqlens_k = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    args = (q, kp, vp, cu, max(chunk), seqlens_k, table)
    kw = dict(seqused_q=seqused, qv=qv, causal=causal)
    out, lse = fpp.flash_attention_paged_prefill_varlen(*args, **kw)
    again = fpp.flash_attention_paged_prefill_varlen(*args, **kw)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert bool(torch.isfinite(out).all())
    kp_f, vp_f = (torch.nan_to_num(x) for x in (kp, vp))
    ref, ref_lse = fpp.flash_attention_paged_prefill_varlen_plain(
        q, kp_f, vp_f, cu, max(chunk), seqlens_k, table, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-3, rtol=0)


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


def _holed_pages(gen, lens_k, h_k, widths, page, dtype):
    """Pages (num_pages, h_k, page, w) for each width in ``widths`` and a
    shuffled block table (one column more than the lengths need, pointing at
    a page no sequence reaches), with NaN in every slot the sequences do not
    reference: a kernel that reads past a sequence's keys shows it."""
    width = max(-(-max(n, 1) // page) for n in lens_k) + 1
    num_pages = len(lens_k) * width + 1
    table = torch.randperm(num_pages - 1, device="cuda", generator=gen)[
        :len(lens_k) * width].reshape(len(lens_k), width).to(torch.int32)
    valid = torch.zeros(num_pages, page, dtype=torch.bool, device="cuda")
    for s, n in enumerate(lens_k):
        for key in range(n):
            valid[table[s, key // page], key % page] = True
    table[:, -1] = num_pages - 1
    pages = [torch.where(valid[:, None, :, None],
                         torch.randn(num_pages, h_k, page, w, device="cuda",
                                     generator=gen).to(dtype), float("nan"))
             for w in widths]
    return pages, table


# The MLA decode route's edge cases (name, h, h_k, d, dv, qv, page (0: a
# linear cache), s_max of a linear cache, sq, dtype): every form of
# MLA_DECODE_DIMS, pages of 16, 64 and 256, linear caches with s_max not a
# multiple of 64, sq = 3 under the causal mask, GQA tiles over several
# positions (16/2) and a group that 64 does not divide (48 heads: tiles of 4
# positions by 16 heads).
MLA_DECODE_EDGE_CASES = [
    ("qv 64 + 512, pages of 16", 128, 1, 64, 512, True, 16, 0, 1,
     torch.bfloat16),
    ("qv 64 + 512, pages of 64, sq=3", 128, 1, 64, 512, True, 64, 0, 3,
     torch.bfloat16),
    ("qv 64 + 512, pages of 256, fp16", 128, 1, 64, 512, True, 256, 0, 1,
     torch.float16),
    ("576/512 latent view, linear s_max 1000", 128, 1, 576, 512, False, 0,
     1000, 1, torch.bfloat16),
    ("576/512 latent view, linear s_max 640, sq=3", 16, 1, 576, 512, False, 0,
     640, 3, torch.bfloat16),
    ("qv 64 + 128, linear s_max 200, GQA 16/2, sq=3, fp16", 16, 2, 64, 128,
     True, 0, 200, 3, torch.float16),
    ("qv 128 + 128, pages of 64, 48 heads, sq=2", 48, 1, 128, 128, True, 64,
     0, 2, torch.bfloat16),
]


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", MLA_DECODE_EDGE_CASES, ids=lambda c: c[0])
def test_mla_decode_route_edge_cases_on_the_card(case):
    """The MLA decode route's split partials against their plain version at
    1, 3 and 8 splits (a row of one key: its later splits are empty, zeros
    and lse -inf), with NaN in every cache slot past cache_seqlens, which
    must not reach the output; the kernel gives the same bits twice."""
    from flash_attn_tpu_torch.kernels import flash_decode

    name, h, h_k, d, dv, has_qv, page, s_max, sq, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(d + dv + page + sq)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    b = 4
    lens = [1, 64, 333, 600] if page else [1, 64, s_max // 3, s_max]
    seqlens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if page:
        (kc, vc), table = _holed_pages(gen, lens, h_k, (d, dv), page, dtype)
        kw = dict(block_table=table)
    else:
        keep = torch.arange(s_max, device="cuda")[None, :] < seqlens[:, None]
        kc = torch.where(keep[:, None, :, None], randn(b, h_k, s_max, d),
                         float("nan")).to(dtype)
        vc = (torch.where(keep[:, None, :, None], randn(b, h_k, s_max, dv),
                          float("nan")).to(dtype) if has_qv else None)
        table, kw = None, {}
    if not has_qv:
        vc = kc[..., :dv]
    q = randn(b, sq, h, d)
    qv = randn(b, sq, h, dv) if has_qv else None
    scale = 1 / math.sqrt(d + dv if has_qv else d)
    kc_f = torch.nan_to_num(kc)
    vc_f = kc_f[..., :dv] if not has_qv else torch.nan_to_num(vc)
    for splits in (1, 3, 8):
        got = flash_decode.flash_attention_decode_partials(
            q, kc, vc, seqlens, splits, scale, True, qv=qv, **kw)
        again = flash_decode.flash_attention_decode_partials(
            q, kc, vc, seqlens, splits, scale, True, qv=qv, **kw)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        assert bool(torch.isfinite(got[0]).all())
        if page:
            want = flash_decode.flash_attention_decode_paged_partials_plain(
                q, kc_f, vc_f, seqlens, table, splits, DECODE_BLOCK_K, scale,
                True, qv=qv)
        else:
            want = flash_decode.flash_attention_decode_partials_plain(
                q, kc_f, vc_f, seqlens, splits, DECODE_BLOCK_K, scale, True,
                qv=qv)
        torch.testing.assert_close(got[0], want[0], atol=2e-2, rtol=0)
        fin = torch.isfinite(want[1])
        assert torch.equal(torch.isfinite(got[1]), fin)
        torch.testing.assert_close(got[1][fin], want[1][fin], atol=1e-3,
                                   rtol=0)
        if splits > 1:  # the row of one key: its later splits are empty
            assert bool(torch.isneginf(got[1][1:, 0]).all())
            assert bool((got[0][1:, 0] == 0).all())


# The d = dv decode route's edge cases (name, h, h_k, d, page (0: a linear
# cache), s_max of a linear cache, sq, dtype): linear caches of s_max 200,
# 640 and 1000, pages of 16, 48, 100 and 256, sq 1-3 under the causal mask,
# GQA 16/4 (up to 12 rows a KV head: two row blocks), both head dims, fp16.
DECODE_EDGE_CASES = [
    ("linear s_max 640", 16, 16, 128, 0, 640, 1, torch.bfloat16),
    ("linear s_max 200, GQA 16/4, sq=3", 16, 4, 128, 0, 200, 3,
     torch.bfloat16),
    ("linear s_max 1000, d=64, sq=2, fp16", 8, 8, 64, 0, 1000, 2,
     torch.float16),
    ("pages of 16, GQA 16/4", 16, 4, 128, 16, 0, 1, torch.bfloat16),
    ("pages of 48, sq=3", 8, 8, 128, 48, 0, 3, torch.bfloat16),
    ("pages of 100, d=64, GQA 16/4, fp16", 16, 4, 64, 100, 0, 2,
     torch.float16),
    ("pages of 256", 16, 16, 128, 256, 0, 1, torch.bfloat16),
    # GPT-NeoX-20B's 96 (staged as 128 columns) and GPT-J's 256
    ("linear s_max 640, d=96", 8, 8, 96, 0, 640, 1, torch.bfloat16),
    ("pages of 48, d=96, GQA 16/4, sq=3, fp16", 16, 4, 96, 48, 0, 3,
     torch.float16),
    ("linear s_max 200, d=256, sq=2", 4, 4, 256, 0, 200, 2, torch.bfloat16),
    ("pages of 256, d=256, GQA 16/4, sq=5", 16, 4, 256, 256, 0, 5,
     torch.bfloat16),
]


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", DECODE_EDGE_CASES, ids=lambda c: c[0])
def test_decode_edge_cases_on_the_card(case):
    """The d = dv decode route's split partials against their plain version
    at 1, 3 and 8 splits (a row of one key: its later splits are empty,
    zeros and lse -inf), at b = 4 (clusters of blocks that share a split,
    on the deep ring) and b = 64 (one block a split, on the shallow ring),
    with NaN in every cache slot past cache_seqlens,
    which must not reach the output; the kernel gives the same bits
    twice."""
    from flash_attn_tpu_torch.kernels import flash_decode

    name, h, h_k, d, page, s_max, sq, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(d + page + sq)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    top = s_max or 600
    for b in (4, 64):
        lens = ([1, 64, top // 3, top] * (b // 4))[:b]
        seqlens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        if page:
            (kc, vc), table = _holed_pages(gen, lens, h_k, (d, d), page, dtype)
            kw = dict(block_table=table)
        else:
            keep = torch.arange(s_max, device="cuda")[None, :] < seqlens[:, None]
            kc, vc = (torch.where(keep[:, None, :, None],
                                  randn(b, h_k, s_max, d), float("nan")).to(dtype)
                      for _ in range(2))
            table, kw = None, {}
        q = randn(b, sq, h, d)
        scale = 1 / math.sqrt(d)
        kc_f, vc_f = torch.nan_to_num(kc), torch.nan_to_num(vc)
        for splits in (1, 3, 8):
            got = flash_decode.flash_attention_decode_partials(
                q, kc, vc, seqlens, splits, scale, True, **kw)
            again = flash_decode.flash_attention_decode_partials(
                q, kc, vc, seqlens, splits, scale, True, **kw)
            assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
            assert bool(torch.isfinite(got[0]).all())
            if page:
                want = flash_decode.flash_attention_decode_paged_partials_plain(
                    q, kc_f, vc_f, seqlens, table, splits, DECODE_BLOCK_K, scale,
                    True)
            else:
                want = flash_decode.flash_attention_decode_partials_plain(
                    q, kc_f, vc_f, seqlens, splits, DECODE_BLOCK_K, scale, True)
            torch.testing.assert_close(got[0], want[0], atol=2e-2, rtol=0)
            fin = torch.isfinite(want[1])
            assert torch.equal(torch.isfinite(got[1]), fin)
            torch.testing.assert_close(got[1][fin], want[1][fin], atol=1e-3,
                                       rtol=0)
            if splits > 1:  # the row of one key: its later splits are empty
                assert bool(torch.isneginf(got[1][1:, 0]).all())
                assert bool((got[0][1:, 0] == 0).all())


@pytest.mark.usefixtures("cuda_card")
def test_decode_refuses_views_tma_cannot_take_on_the_card():
    """The d = dv decode route reads the cache by TMA: a view whose start is
    not 16-byte aligned, or whose strides are not multiples of 16 bytes,
    raises ValueError."""
    from flash_attn_tpu_torch.kernels import flash_decode

    kc = torch.zeros(2, 4, 256, 128, dtype=torch.bfloat16, device="cuda")
    lens = torch.tensor([10, 200], dtype=torch.int32, device="cuda")
    q = torch.zeros(2, 1, 4, 128, dtype=torch.bfloat16, device="cuda")
    wide = torch.zeros(2, 1, 4, 129, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_decode.flash_attention_decode(wide[..., 1:], kc, kc, lens)
    kc_wide = torch.zeros(2, 4, 256, 132, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_decode.flash_attention_decode(q, kc_wide[..., :128], kc, lens)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("form", [(128, 1, 64, 512), (16, 2, 64, 128)])
def test_mla_decode_equals_paged_prefill_on_the_card(form):
    """At one split the MLA decode route runs B8p's tile over the same keys:
    a decode step equals the same step as a one-row chunk through B8p, bit
    for bit (out and lse)."""
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.kernels import flash_paged_prefill as fpp

    h, h_k, d, dv = form
    gen = torch.Generator(device="cuda").manual_seed(h)
    b, page = 4, 64
    lens = [1, 64, 333, 600]
    (kp, vp), table = _holed_pages(gen, lens, h_k, (d, dv), page,
                                   torch.bfloat16)
    q, qv = (torch.randn(b, 1, h, w, device="cuda", generator=gen).to(
        torch.bfloat16) for w in (d, dv))
    seqlens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = 1 / math.sqrt(d + dv)
    out, lse = flash_decode.flash_attention_decode(
        q, kp, vp, seqlens, scale, True, 1, block_table=table, qv=qv)
    one = torch.arange(b + 1, dtype=torch.int32, device="cuda")
    pf, pf_lse = fpp.flash_attention_paged_prefill_varlen(
        q.reshape(b, h, d), kp, vp, one, 1, seqlens, table,
        qv=qv.reshape(b, h, dv), softmax_scale=scale, causal=True)
    assert torch.equal(out.reshape(b, h, dv), pf)
    assert torch.equal(lse.reshape(b, h), pf_lse.T)


@pytest.mark.usefixtures("cuda_card")
def test_mla_decode_refuses_views_tma_cannot_take_on_the_card():
    """A view whose start is not 16-byte aligned, or whose strides are not
    multiples of 16 bytes, raises ValueError: the kernel reads by TMA and
    never falls back."""
    from flash_attn_tpu_torch.kernels import flash_decode

    kp = torch.zeros(9, 1, 64, 64, dtype=torch.bfloat16, device="cuda")
    vp = torch.zeros(9, 1, 64, 512, dtype=torch.bfloat16, device="cuda")
    table = torch.arange(8, dtype=torch.int32, device="cuda").reshape(2, 4)
    lens = torch.tensor([10, 200], dtype=torch.int32, device="cuda")
    q = torch.zeros(2, 1, 128, 64, dtype=torch.bfloat16, device="cuda")
    qv = torch.zeros(2, 1, 128, 512, dtype=torch.bfloat16, device="cuda")
    wide = torch.zeros(2, 1, 128, 65, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_decode.flash_attention_decode(wide[..., 1:], kp, vp, lens,
                                            block_table=table, qv=qv)
    kp_wide = torch.zeros(9, 1, 64, 68, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_decode.flash_attention_decode(q, kp_wide[..., :64], vp, lens,
                                            block_table=table, qv=qv)


def _varlen_paged_inputs(case, seed):
    """q, the holed pages, the table and the lengths of one B8 case in
    VARLEN_CASES' form."""
    import numpy as np

    name, lens_q, lens_k, used, h, h_k, d, page, dtype, causal = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                      dtype=torch.int32, device="cuda")
    q = torch.randn(int(cu[-1]), h, d, device="cuda", generator=gen).to(dtype)
    (kp, vp), table = _holed_pages(gen, lens_k, h_k, (d, d), page, dtype)
    seqlens_k = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    seqused = (None if used is None else
               torch.tensor(used, dtype=torch.int32, device="cuda"))
    return q, kp, vp, cu, max(max(lens_q), 1), seqlens_k, table, seqused


# B8 beyond chip_smoke.py's shapes: a page size that is not a power of two
# (48: boxes of 16 rows), a chunk that starts mid-page over pages of 100
# (boxes of 4), and GQA 16/4 at d = 64 in fp16 with seqused_q padding.
VARLEN_PAGED_EDGE_CASES = [
    ("pages of 48", [100, 37, 129], [300, 37, 129], None, 8, 2, 128, 48,
     torch.bfloat16, True),
    ("pages of 100, mid-page chunks", [70, 1, 130], [170, 99, 333], None, 8,
     8, 128, 100, torch.bfloat16, True),
    ("GQA 16/4, d=64, fp16, seqused_q", [128, 64, 128], [200, 64, 700],
     [100, 0, 128], 16, 4, 64, 64, torch.float16, True),
    ("GQA 16/4, d=64, fp16, not causal", [50, 200], [60, 190], None, 16, 4,
     64, 16, torch.float16, False),
]


# B8 at 96 and 256 (B6, its packed twin, takes 64 and 128 only).
VARLEN_PAGED_WIDE_CASES = [
    ("d=96, pages of 256", [256, 77, 1], [512, 300, 90], None, 8, 8, 96,
     256, torch.bfloat16, True),
    ("d=256, GQA 8/2, pages of 48, fp16", [100, 37, 129], [300, 37, 129],
     [100, 20, 129], 8, 2, 256, 48, torch.float16, True),
    ("d=256, not causal, pages of 16", [50, 200], [60, 190], None, 4, 4,
     256, 16, torch.bfloat16, False),
]


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", VARLEN_CASES + VARLEN_PAGED_EDGE_CASES
                         + VARLEN_PAGED_WIDE_CASES
                         + [c[0] for c in HD80_VARLEN_CASES],
                         ids=lambda c: c[0])
def test_varlen_paged_kernel_cases_on_the_card(case):
    """B8 against its plain version on chip_smoke.py's shapes and the edge
    cases above, with NaN in every page slot past seqlens_k (and in the
    page the table points past), which must not reach the output; rows past
    seqused_q keep zeros and lse -inf; the same bits twice."""
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp

    q, kp, vp, cu, max_q, seqlens_k, table, seqused = _varlen_paged_inputs(
        case, len(case[1]) + case[7])
    causal = case[-1]
    args = (q, kp, vp, cu, max_q, seqlens_k, table)
    out, lse = fvp.flash_attention_varlen_paged_fwd(*args, seqused_q=seqused,
                                                   causal=causal)
    again = fvp.flash_attention_varlen_paged_fwd(*args, seqused_q=seqused,
                                                 causal=causal)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert bool(torch.isfinite(out).all())
    ref, ref_lse = fvp.flash_attention_varlen_paged_fwd_plain(
        q, torch.nan_to_num(kp), torch.nan_to_num(vp), cu, max_q, seqlens_k,
        table, seqused_q=seqused, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-3, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", VARLEN_CASES + VARLEN_PAGED_EDGE_CASES + [
    c for c, cap, window in HD80_VARLEN_CASES if not cap and window[0] < 0],
    ids=lambda c: c[0])
def test_varlen_paged_equals_b6_forward_on_the_card(case):
    """B8 runs B6's forward tile with a paged source: over pages it gives
    B6's forward's bits over the same rows packed (cu_seqlens_k in place of
    the block table)."""
    import numpy as np

    from flash_attn_tpu_torch.kernels import flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.utils.testing import paged_to_linear

    q, kp, vp, cu, max_q, seqlens_k, table, seqused = _varlen_paged_inputs(
        case, len(case[1]) + case[7])
    causal = case[-1]
    lens_k = case[2]
    out, lse = fvp.flash_attention_varlen_paged_fwd(
        q, kp, vp, cu, max_q, seqlens_k, table, seqused_q=seqused,
        causal=causal)
    k, v = (torch.cat([lin[s, :, :n].transpose(0, 1)
                       for s, n in enumerate(lens_k)])
            for lin in (paged_to_linear(x, table, seqlens_k) for x in (kp, vp)))
    cu_k = torch.tensor(np.concatenate([[0], np.cumsum(lens_k)]),
                        dtype=torch.int32, device="cuda")
    b6, b6_lse = flash_varlen.flash_attention_varlen_fwd(
        q, k.contiguous(), v.contiguous(), cu, cu_k, max_q, max(lens_k),
        seqused_q=seqused, causal=causal)
    assert torch.equal(out, b6) and torch.equal(lse, b6_lse)


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
    128 (two 64-key tiles a listed tile), of 64 x 256 in fp16, sq=200 over
    sk=384 (a ragged last q tile, the causal shift) on strided (b, s, h, d)
    views, keys in tiles of 64 (a dK/dV block walks two caller tiles' lists)
    and q tiles of 192 (a block's halves in two caller tiles); the backward
    gives the same bits twice; autograd casts to the inputs' type."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs

    gen = torch.Generator(device="cuda").manual_seed(d)
    for dtype, sq, sk, bq, bk, bshd in (
            (torch.bfloat16, 512, 512, 128, 128, False),
            (torch.float16, 512, 512, 64, 256, False),
            (torch.bfloat16, 200, 384, 64, 128, True),
            # a dK/dV block over two caller key tiles
            (torch.bfloat16, 512, 512, 128, 64, False),
            # a 128-row block over two caller q tiles of 192 rows
            (torch.bfloat16, 512, 512, 192, 128, True)):
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
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_blocksparse_full_mask_equals_the_dense_kernels_on_the_card(causal,
                                                                   d):
    """Over the full block mask (causal: every tile at or below the
    diagonal) at tiles of 128, B10 walks the dense kernels' tiles in their
    order: out and lse equal B1's bitwise, and the gradients rounded to
    bf16 equal B3's."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd

    gen = torch.Generator(device="cuda").manual_seed(d)
    nt = 1024 // 128
    mask = torch.ones(nt, nt, dtype=torch.bool)
    if causal:
        mask = mask.tril()
    q, k, v, do, num, idx = _blocksparse_inputs(gen, 2, 4, 1024, 1024, d,
                                                torch.bfloat16, mask,
                                                bshd=True)
    kw = dict(causal=causal, block_q=128, block_k=128)
    out, lse = bs.flash_attention_blocksparse_fwd(q, k, v, num, idx, **kw)
    out1, lse1 = flash_fwd.flash_attention_fwd(q, k, v, causal=causal)
    assert torch.equal(out, out1) and torch.equal(lse, lse1)
    got = bs.flash_attention_blocksparse_bwd(do, q, k, v, out, lse, num, idx,
                                             **kw)
    want = flash_bwd.flash_attention_bwd(do, q, k, v, out1, lse1,
                                         causal=causal)
    for g, w in zip(got, want):
        assert torch.equal(g.to(w.dtype), w)


@pytest.mark.usefixtures("cuda_card")
def test_blocksparse_local_window_at_8192_on_the_card():
    """A causal window of 4 tiles plus the global tile 0 at 1 x 8192 (tiles
    of 128; column 0's dK/dV block walks every q tile): forward and
    backward against the plain versions, the backward bitwise twice."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs

    gen = torch.Generator(device="cuda").manual_seed(0)
    nt = 8192 // 128
    i = torch.arange(nt)[:, None]
    j = torch.arange(nt)[None, :]
    mask = ((j <= i) & (j > i - 4)) | (j == 0)
    q, k, v, do, num, idx = _blocksparse_inputs(gen, 1, 4, 8192, 8192, 128,
                                                torch.bfloat16, mask)
    kw = dict(causal=True, block_q=128, block_k=128)
    out, lse = bs.flash_attention_blocksparse_fwd(q, k, v, num, idx, **kw)
    ref, ref_lse = bs.flash_attention_blocksparse_fwd_plain(q, k, v, num, idx,
                                                            **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    got = bs.flash_attention_blocksparse_bwd(do, q, k, v, out, lse, num, idx,
                                             **kw)
    want = bs.flash_attention_blocksparse_bwd_plain(do, q, k, v, out, lse,
                                                    num, idx, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=5e-2, rtol=0)
    again = bs.flash_attention_blocksparse_bwd(do, q, k, v, out, lse, num,
                                               idx, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("bq, bk", [(128, 128), (64, 256), (192, 64)])
def test_blocksparse_preprocess_matches_plain_version_on_the_card(bq, bk):
    """The backward's preprocess kernel: delta and lse2 against the plain
    version (padded rows included), and the inverse lists equal to
    kv_to_q_lists's over their first q_num entries, on a random mask with a
    duplicated entry, an empty row and entries past kv_num."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs

    gen = torch.Generator(device="cuda").manual_seed(bq)
    sq, sk = 456, 512
    nq, nk = -(-sq // bq), sk // bk
    mask = torch.rand(2, nq, nk, generator=torch.Generator().manual_seed(bk)) < 0.5
    mask[1, 0] = False
    mask[0, 1, 0], mask[0, 1, -1] = True, False  # room for a second entry
    q, k, v, do, num, idx = _blocksparse_inputs(gen, 2, 4, sq, sk, 64,
                                                torch.bfloat16, mask, True)
    idx[0, 1, num[0, 1]] = idx[0, 1, 0]  # listed twice
    num[0, 1] += 1
    kw = dict(causal=True, block_q=bq, block_k=bk)
    out, lse = bs.flash_attention_blocksparse_fwd(q, k, v, num, idx, **kw)
    got = bs.blocksparse_bwd_preprocess(do, out, lse, num, idx, nk, bq, bk)
    want = bs.blocksparse_bwd_preprocess_plain(do, out, lse, num, idx, nk)
    torch.testing.assert_close(got[0], want[0], atol=1e-3, rtol=0)
    fin = torch.isfinite(want[1])
    assert torch.equal(torch.isfinite(got[1]), fin)
    torch.testing.assert_close(got[1][fin], want[1][fin], atol=1e-5, rtol=0)
    assert torch.equal(got[2], want[2])
    for bb in range(2):
        for c in range(nk):
            n = int(want[2][bb, c])
            assert torch.equal(got[3][bb, c, :n], want[3][bb, c, :n])


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


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_decode_at_speculative_widths_on_the_card(k, paged):
    """B4 at sq = k + 1 (a speculative round's verify step) with GQA 16/4:
    (k + 1) x 4 rows a KV head, more than one 8-row block from k = 3 on,
    causal bottom-right, the appended keys included, against the fp32
    plain version under the 2x rule (a bf16 reference's error)."""
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
        paged_to_linear,
    )

    b, h, h_k, d, sq = 4, 16, 4, 128, k + 1
    gen = torch.Generator(device="cuda").manual_seed(k)
    lens = [sq, 37, 300, 511]
    seqlens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if paged:
        (kc, vc), table = _holed_pages(gen, lens, h_k, (d, d), 64,
                                       torch.bfloat16)
        kc, vc = torch.nan_to_num(kc), torch.nan_to_num(vc)
        k_lin, v_lin = (paged_to_linear(x, table, seqlens) for x in (kc, vc))
    else:
        table = None
        kc, vc = (torch.randn(b, h_k, 512, d, device="cuda", generator=gen)
                  .to(torch.bfloat16) for _ in range(2))
        k_lin, v_lin = kc, vc
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(
        torch.bfloat16)
    for splits in (1, 3):
        out, _ = flash_decode.flash_attention_decode(
            q, kc, vc, seqlens, causal=True, num_splits=splits,
            block_table=table)
        ref, _ = flash_decode.flash_attention_decode(
            q.float().cpu(), k_lin.float().cpu(), v_lin.float().cpu(),
            seqlens.cpu(), causal=True, num_splits=splits)
        keep = (torch.arange(k_lin.shape[2], device="cuda")[None]
                < seqlens[:, None])
        ref_lp, _ = attention_ref(q, k_lin.transpose(1, 2),
                                  v_lin.transpose(1, 2),
                                  key_padding_mask=keep, causal=True,
                                  upcast=False)
        check_against_ref(out, ref, ref_lp, msg=f"B4 sq={sq} paged={paged}")


def _graph_model(paged: bool, seed: int = 0, n_layer: int = 2, **fields):
    """A small GPT on the card with the kernels' widths (GQA 4/2, head dim
    64, bf16), random weights from a seed; paged over 40 pages of 32.
    ``fields`` replace the config's."""
    cfg = GPTConfig(**{**dict(
        vocab_size=512, n_positions=0, n_embd=256, n_layer=n_layer, n_head=4,
        n_head_kv=2, rotary_emb_fraction=1.0, use_rms_norm=True,
        glu_act=True, max_decode_seqlen=128, dtype=torch.bfloat16,
        paged_kv_num_pages=40 if paged else 0, paged_kv_page_size=32),
        **fields})
    model = GPTLMHeadModel(cfg, device="cuda")
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(seed))
    return model.requires_grad_(False)


def _counts():
    from flash_attn_tpu_torch.kernels import launch_counters

    return {f"{mod.__name__}.{attr}": n
            for (mod, attr), n in launch_counters().items()}


def _counted(fn):
    """fn()'s result and the kernel launches it counted."""
    before = _counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {key: n - before[key] for key, n in _counts().items()
                 if n != before[key]}


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("eos, scores, sampled", [
    (False, False, False), (False, True, False), (True, True, False),
    (False, False, True)], ids=["greedy", "scores", "eos+scores", "sampled"])
def test_graphed_static_decode_equals_eager_on_the_card(eos, scores,
                                                        sampled):
    """decode() replaying its captured step gives the eager step's tokens
    and scores bitwise, and counts the same launches (the graph adds what
    capture recorded at each replay); a second call replays the same graph
    over the same static buffers. Sampling draws from a seeded generator,
    registered with the graph, in the same order as eagerly."""
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    model = _graph_model(False)
    ids = torch.randint(0, 512, (3, 20), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    eos_id = None
    if eos:  # a token that row 0 emits early
        probe, _ = decode(ids, model, GenerationConfig(max_length=48))
        eos_id = int(probe[0, 23])
    cfg = GenerationConfig(max_length=48, eos_token_id=eos_id,
                           top_k=8 if sampled else 1, temperature=0.8)

    def run(cg):
        gen = (torch.Generator(device="cuda").manual_seed(5) if sampled
               else None)
        return decode(ids, model, cfg, generator=gen, output_scores=scores,
                      cg=cg)

    want, n_eager = _counted(lambda: run(False))
    got, n_graph = _counted(lambda: run(True))
    again, n_again = _counted(lambda: run(True))
    assert n_eager == n_graph == n_again and n_eager
    for x, y, z in zip(want, got, again):
        assert x == y == z if isinstance(x, int) else (
            torch.equal(x, y) and torch.equal(x, z))
    st = model._decode_state  # the eos probe's was replaced
    assert st.key[1] == cfg and st.graph.captured


@pytest.mark.usefixtures("cuda_card")
def test_graphed_decode_keeps_one_state_on_the_card():
    """Graphed decode at several prompt lengths keeps one state on the
    model and replays one graph (captured once): the allocated memory after
    each later call is what the first left, and a call with another config
    replaces the state instead of adding one. Each call's tokens equal the
    eager decode's."""
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    model = _graph_model(False)
    gen = torch.Generator().manual_seed(1)
    cfg = GenerationConfig(max_length=48)
    base = None
    for plen in (20, 7, 33, 20):
        # the prompts stay on the host, so that only decode's own memory
        # is counted
        ids = torch.randint(0, 512, (3, plen), generator=gen)
        got = decode(ids.cuda(), model, cfg, output_scores=True)
        want = decode(ids.cuda(), model, cfg, output_scores=True, cg=False)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        del got, want
        torch.cuda.synchronize()
        st = model._decode_state
        if base is None:
            base, graph = torch.cuda.memory_allocated(), st.graph.graph
        assert st.graph.graph is graph
        assert torch.cuda.memory_allocated() <= base
    del st, graph  # the replaced state must be free to go
    decode(ids.cuda(), model, GenerationConfig(max_length=48,
                                               eos_token_id=5))
    torch.cuda.synchronize()
    assert model._decode_state.key[1].eos_token_id == 5
    assert torch.cuda.memory_allocated() <= base


def _engine(model, cg, prefix=False, draft=None, k=3):
    from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
    from flash_attn_tpu_torch.serving.generation import GenerationConfig

    cfg = model.config
    pool = (PagePool(cfg.paged_kv_num_pages, cfg.paged_kv_page_size, 4, 4)
            if cfg.paged_kv_num_pages else None)
    return InferenceEngine(model, 4, GenerationConfig(top_k=1), page_pool=pool,
                           decode_block_size=4, prefix_cache=prefix,
                           draft_model=draft, speculative_k=k, cg=cg)


def _engine_jobs(seed, shared=0):
    rng = torch.Generator().manual_seed(seed)
    common = torch.randint(0, 512, (shared,), generator=rng).tolist()
    return [(common + torch.randint(0, 512, (int(n),), generator=rng).tolist(),
             int(m)) for n, m in [(9, 12), (40, 7), (17, 20), (5, 9), (33, 11),
                                  (12, 6)]]


def _serve(eng, jobs, warm=True):
    def run():
        if warm:
            eng.warmup(prefill_shapes=[(4, 64)])
        ids = [eng.submit(p, max_new_tokens=m) for p, m in jobs]
        res = eng.run()
        return [res[i] for i in ids]
    return _counted(run)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("mode", ["linear", "paged", "prefix"])
def test_graphed_engine_blocks_equal_eager_on_the_card(mode):
    """The engine's decode block captured by warmup() and replayed gives the
    eager block's tokens and launch counts, over a linear cache, a paged
    one and a prefix-cached one (whose admissions share a 32-token page
    and run B8), with slot reuse and requests ending mid-block; every page
    returns."""
    model = _graph_model(mode != "linear")
    jobs = _engine_jobs(2, shared=40 if mode == "prefix" else 0)
    runs = []
    for cg in (False, True):
        eng = _engine(model, cg, prefix=mode == "prefix")
        runs.append(_serve(eng, jobs))
        if cg:
            assert set(eng._graphs) == {"decode_block"}
            assert eng._graphs["decode_block"].captured
        if eng.pool is not None:
            pool = eng.pool
            assert not pool.rc and len(pool.free) + len(pool.retained) == 39
    (want, n_eager), (got, n_graph) = runs
    assert got == want and n_graph == n_eager
    assert [len(t) for t in got] == [m for _, m in jobs]


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_graphed_speculative_round_equals_eager_on_the_card(paged):
    """The speculative round (k = 3 draft steps, the first at sq = 2, a
    verify at sq = 4 through B4, the acceptance and both caches' rewinds)
    captured by warmup() and replayed gives the eager round's tokens and
    launches, and the plain greedy engine's tokens."""
    model = _graph_model(paged)
    draft = _graph_model(False, seed=7, n_layer=1)
    jobs = _engine_jobs(3)
    plain, _ = _serve(_engine(model, True), jobs)
    runs = []
    for cg in (False, True):
        eng = _engine(model, cg, draft=draft)
        runs.append(_serve(eng, jobs))
        if cg:
            assert set(eng._graphs) == {"spec_round"}
    (want, n_eager), (got, n_graph) = runs
    assert got == want == plain and n_graph == n_eager


@pytest.mark.usefixtures("cuda_card")
def test_close_then_new_traffic_recaptures_on_the_card():
    """close() drops the caches and the graphs over them: the next traffic
    allocates new caches and captures a new graph (no replay of the old
    one over freed buffers), with the same tokens."""
    model = _graph_model(True)
    eng = _engine(model, True)
    jobs = _engine_jobs(4)
    first, _ = _serve(eng, jobs, warm=False)
    old = eng._graphs["decode_block"]
    eng.close()
    assert eng.cache is None and not eng._graphs
    second, _ = _serve(eng, jobs, warm=False)
    assert eng._graphs["decode_block"] is not old and second == first


@pytest.mark.usefixtures("cuda_card")
def test_capture_failure_raises_on_the_card():
    """A program that reads the device from the host cannot be captured:
    the capture raises (nothing falls back to eager), the caller's stream
    is the current one again, and a later program captures and replays on
    the same capture stream."""
    from flash_attn_tpu_torch.serving.graphs import CapturedProgram

    x = torch.ones(4, device="cuda")
    stream = torch.cuda.current_stream()
    prog = CapturedProgram()
    with pytest.raises(RuntimeError):
        prog(lambda t: t * float(t.sum()), x)
    assert not prog.captured and torch.cuda.current_stream() == stream
    assert float((x * 2).sum()) == 8.0
    again = CapturedProgram()  # the shared capture stream is usable again
    for _ in range(2):  # captured, then replayed
        assert torch.equal(again(lambda t: t * 2, x), x * 2)


# An OPT-shaped block: learned positions, LayerNorm, ReLU, no rotary
LEARNED_POSITIONS = dict(n_positions=128, rotary_emb_fraction=0.0,
                         use_rms_norm=False, glu_act=False, activation="relu")


@pytest.mark.usefixtures("cuda_card")
def test_graphed_decode_with_learned_positions_equals_eager_on_the_card():
    """With learned positions the decode step embeds each token at its
    cache offset, computed on the device, so the captured step replays the
    right positions: graphed tokens and scores equal the eager ones
    bitwise, at two prompt lengths over one graph, and the steps' logits
    stay within bf16 noise of a teacher-forced forward over the decoded
    tokens (a token embedded at position 0, as JAX's decode does, moves
    them by their own scale)."""
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    model = _graph_model(False, **LEARNED_POSITIONS)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cfg = GenerationConfig(max_length=48)
    for plen in (20, 9):
        ids = torch.randint(0, 512, (3, plen), device="cuda", generator=gen)
        want, n_eager = _counted(lambda: decode(ids, model, cfg,
                                                output_scores=True, cg=False))
        got, n_graph = _counted(lambda: decode(ids, model, cfg,
                                               output_scores=True))
        assert n_graph == n_eager and torch.equal(got[0], want[0])
        assert torch.equal(got[2], want[2])
        with torch.inference_mode():
            tf = model(got[0][:, :-1])[:, plen - 1:].transpose(0, 1)
        assert (tf - got[2]).abs().max() < 0.25
        assert (tf.argmax(-1) == got[0][:, plen:].T).float().mean() > 0.9


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("mode", ["paged", "prefix"])
def test_graphed_engine_with_learned_positions_equals_eager_on_the_card(mode):
    """The engine with learned positions: admissions (with prefix caching,
    a suffix at positions after its shared pages) and the captured decode
    block give the eager engine's tokens and launches."""
    model = _graph_model(True, **LEARNED_POSITIONS)
    jobs = _engine_jobs(5, shared=40 if mode == "prefix" else 0)
    runs = [_serve(_engine(model, cg, prefix=mode == "prefix"), jobs)
            for cg in (False, True)]
    (want, n_eager), (got, n_graph) = runs
    assert got == want and n_graph == n_eager
    assert [len(t) for t in got] == [m for _, m in jobs]


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("h, d", [(71, 64), (48, 128)],
                         ids=["falcon_7b", "starcoder"])
def test_decode_at_large_groups_on_the_card(h, d):
    """B4's d = dv route with one KV head for 71 (Falcon-7B) or 48
    (StarCoder) query heads, a KV head's rows spread over blocks of 8, at
    static decode's lengths: out against the plain fp32 version under the
    2x rule (attention_ref in bf16 as the low-precision reference) and lse
    within 1e-3, at 1 and 4 splits."""
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(h)
    b, s_max = 8, 640

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    q, kc, vc = randn(b, 1, h, d), randn(b, 1, s_max, d), randn(b, 1, s_max, d)
    seqlens = torch.linspace(513, 544, b, device="cuda").round().to(
        torch.int32)
    keep = torch.arange(s_max, device="cuda")[None] < seqlens[:, None]
    ref_lp, _ = attention_ref(q, kc.transpose(1, 2), vc.transpose(1, 2),
                              key_padding_mask=keep, upcast=False)
    for splits in (1, 4):
        out, lse = flash_decode.flash_attention_decode(
            q, kc, vc, seqlens, causal=True, num_splits=splits)
        ref, ref_lse = flash_decode.flash_attention_decode(
            q.float().cpu(), kc.float().cpu(), vc.float().cpu(),
            seqlens.cpu(), causal=True, num_splits=splits)
        check_against_ref(out, ref, ref_lp,
                          msg=f"flash_decode h={h} d={d} splits={splits}")
        torch.testing.assert_close(lse.cpu(), ref_lse, atol=1e-3, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("n_embd, n_head", [(512, 2), (192, 2)],
                         ids=["gptj_256", "neox_20b_96"])
def test_unported_head_dims_raise_naming_item_7_on_the_card(n_embd, n_head):
    """GPT-J's head dim 256 and GPT-NeoX-20B's 96 now have backward kernels:
    on the card a model whose weights require grad runs forward and
    backward there (finite gradients). A head dim that no kernel is
    compiled for (192: 384 wide over 2 heads) still raises naming queue A
    item 7 before its forward runs."""
    from types import SimpleNamespace

    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.models.hf_adapters import (
        gptj_config_to_gpt_config,
    )

    def model_of(width, heads):
        hf = SimpleNamespace(vocab_size=512, n_embd=width, n_layer=1,
                             n_head=heads, rotary_dim=32, n_inner=None,
                             layer_norm_epsilon=1e-5,
                             activation_function="gelu_new")
        return GPTLMHeadModel(gptj_config_to_gpt_config(
            hf, dtype=torch.bfloat16, max_decode_seqlen=64))

    ids = torch.zeros((1, 8), dtype=torch.long, device="cuda")
    model = model_of(n_embd, n_head)
    model(ids).float().square().mean().backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    before = flash_fwd.launches
    with pytest.raises(NotImplementedError, match="item 7"):
        model_of(384, 2)(ids)
    assert flash_fwd.launches == before


@pytest.mark.usefixtures("cuda_card")
def test_wide_head_dim_refusals_on_the_card():
    """At 96 and 256 flash_attn_func and the dense flash_attn_varlen_func
    run forward and backward on the card (one forward launch each, then the
    backward's); 192 and d != dv raise before any launch, naming queue A
    item 7."""
    from flash_attn_tpu_torch import flash_attn_varlen_func
    from flash_attn_tpu_torch.kernels import (
        flash_bwd,
        flash_fwd,
        flash_varlen,
        flash_varlen_persistent,
    )

    def randn(*shape, **kw):
        return torch.randn(*shape, device="cuda", dtype=torch.bfloat16, **kw)

    for d in (96, 256):
        q = randn(1, 64, 2, d, requires_grad=True)
        before = (flash_fwd.launches, flash_bwd.launches_dkdv)
        flash_attn_func(q, q, q, causal=True).sum().backward()
        assert (flash_fwd.launches, flash_bwd.launches_dkdv) == \
            (before[0] + 1, before[1] + 1)
        assert bool(torch.isfinite(q.grad).all())
        x = randn(64, 2, d, requires_grad=True)
        cu = torch.tensor([0, 64], dtype=torch.int32, device="cuda")
        before = (flash_varlen_persistent.launches, flash_varlen.launches_dkdv)
        flash_attn_varlen_func(x, x, x, cu, cu, 64, 64,
                               causal=True).sum().backward()
        assert (flash_varlen_persistent.launches,
                flash_varlen.launches_dkdv) == (before[0] + 1, before[1] + 1)
        assert bool(torch.isfinite(x.grad).all())
    before = flash_fwd.launches
    y = randn(1, 64, 2, 192, requires_grad=True)
    with pytest.raises(ValueError, match="queue A, item 7"):
        flash_attn_func(y, y, y)
    q, v = randn(1, 64, 2, 256), randn(1, 64, 2, 128)
    with pytest.raises(ValueError, match="queue A, item 7"):
        flash_attn_func(q, q, v)
    assert flash_fwd.launches == before


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", HD80_FWD_CASES, ids=str)
def test_head_dim_80_forward_matches_plain_version_on_the_card(case):
    """B1 at head dim 80 without the band or the map (the instantiation of
    flash_fwd_80.cu): the 2x rule against the fp32 plain forward with a
    bf16 reference, lse within 1e-3, the same bits twice, one launch a
    call; over a q whose heads of 80 sit in rows of 96 columns, the last 16
    NaN, the same bits (the maps carry 80 columns: TMA fills the tile's
    columns past them with zeros, not with the neighbours')."""
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
    )

    b, sq, sk, h, h_k, d, causal = case
    gen = torch.Generator(device="cuda").manual_seed(sq + h)
    q, k, v = (torch.randn(b, n, heads, d, device="cuda", generator=gen)
               .bfloat16() for n, heads in ((sq, h), (sk, h_k), (sk, h_k)))
    args = [x.transpose(1, 2) for x in (q, k, v)]
    before = flash_fwd.launches
    out, lse = flash_fwd.flash_attention_fwd(*args, causal=causal)
    again = flash_fwd.flash_attention_fwd(*args, causal=causal)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = flash_fwd.flash_attention_fwd_plain(
        *(x.float() for x in args), causal=causal)
    ref_lp, _ = attention_ref(q, k, v, causal=causal, upcast=False)
    check_against_ref(out.transpose(1, 2), ref.transpose(1, 2), ref_lp,
                      msg=str(case))
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    wide = torch.full((b, sq, h, 96), float("nan"), device="cuda",
                      dtype=torch.bfloat16)
    wide[..., :d] = q
    out_w, _ = flash_fwd.flash_attention_fwd(
        wide[..., :d].transpose(1, 2), *args[1:], causal=causal)
    assert torch.equal(out_w, out)


@pytest.mark.usefixtures("cuda_card")
def test_head_dim_80_training_refusals_on_the_card():
    """Head dim 80 trains on the card: a gradient through flash_attn_func
    (and its packed form), the dense flash_attn_varlen_func (B7's forward,
    B6's under ALiBi, B6's backward), MHA in train mode and MHA on packed
    input run the kernels at 80, each launch counted, with finite
    gradients; without a gradient the forward kernels run alone. Head dim
    192 and d != dv still raise before any launch, naming queue A, item
    7."""
    from flash_attn_tpu_torch import (
        flash_attn_qkvpacked_func,
        flash_attn_varlen_func,
    )
    from flash_attn_tpu_torch.modules.mha import MHA, KVCache

    def randn(*shape, **kw):
        return torch.randn(*shape, device="cuda", dtype=torch.bfloat16, **kw)

    q = randn(1, 64, 2, 80, requires_grad=True)
    qkv = randn(1, 64, 3, 2, 80, requires_grad=True)
    x = randn(64, 2, 80, requires_grad=True)
    cu = torch.tensor([0, 64], dtype=torch.int32, device="cuda")
    mha = MHA(160, 2, causal=True, use_alibi=True, dtype=torch.bfloat16,
              max_decode_seqlen=128)
    mod = "flash_attn_tpu_torch.kernels."
    fwd, dec = mod + "flash_fwd.launches", mod + "flash_decode.launches"
    pre, dkdv = mod + "flash_bwd.launches_preprocess", \
        mod + "flash_bwd.launches_dkdv"
    dq = mod + "flash_bwd.launches_dq"
    b3 = {pre: 1, dkdv: 1, dq: 1}
    vpre, vdkdv, vdq = (mod + "flash_varlen.launches_" + n
                        for n in ("preprocess", "dkdv", "dq"))
    b6 = {vpre: 1, vdkdv: 1, vdq: 1}
    b7 = mod + "flash_varlen_persistent.launches"
    score = {n + "_score": 1 for n in (dkdv, dq)}
    for call, want, leaf in (
            (lambda: flash_attn_func(q, q, q, causal=True), {fwd: 1, **b3}, q),
            (lambda: flash_attn_qkvpacked_func(qkv, causal=True),
             {fwd: 1, **b3}, qkv),
            (lambda: flash_attn_varlen_func(x, x, x, cu, cu, 64, 64),
             {b7: 1, **b6}, x)):
        leaf.grad = None
        _, n = _counted(lambda: call().float().square().sum().backward())
        assert n == want and bool(torch.isfinite(leaf.grad).all())
    xi = randn(1, 64, 160, requires_grad=True)
    _, n = _counted(lambda: mha(xi).float().square().sum().backward())
    assert n == {fwd: 1, fwd + "_score": 1, **b3, **score}
    assert bool(torch.isfinite(xi.grad).all())
    xp = randn(64, 160, requires_grad=True)
    _, n = _counted(lambda: mha(xp, cu_seqlens=cu, max_seqlen=64).float()
                    .square().sum().backward())
    assert n == {mod + "flash_varlen.launches_fwd": 1,
                 mod + "flash_varlen.launches_fwd_score": 1, **b6,
                 vdkdv + "_score": 1, vdq + "_score": 1}
    assert bool(torch.isfinite(xp.grad).all())
    with torch.no_grad():
        out, n = _counted(lambda: flash_attn_varlen_func(x, x, x, cu, cu, 64,
                                                         64))
        assert bool(torch.isfinite(out).all()) and n == {b7: 1}
        y, n = _counted(lambda: mha(randn(2, 64, 160)))
        assert bool(torch.isfinite(y).all())
        assert n == {fwd: 1, fwd + "_score": 1}
        cache = KVCache()
        mha(randn(2, 64, 160), mode="prefill", cache=cache)
        y, n = _counted(lambda: mha(randn(2, 1, 160), mode="decode",
                                    cache=cache))
        assert bool(torch.isfinite(y).all())
        assert n == {dec: 1, dec + "_score": 1}
    before = _counts()
    y = randn(1, 64, 2, 192, requires_grad=True)
    z = randn(64, 2, 192, requires_grad=True)
    cu = torch.tensor([0, 64], dtype=torch.int32, device="cuda")
    v = randn(1, 64, 2, 64)
    for call in (lambda: flash_attn_func(y, y, y, causal=True),
                 lambda: flash_attn_varlen_func(z, z, z, cu, cu, 64, 64),
                 lambda: flash_attn_func(q, q, v)):
        with pytest.raises(ValueError, match="queue A, item 7"):
            call()
    with pytest.raises(NotImplementedError, match="item 7"):
        MHA(384, 2, causal=True, dtype=torch.bfloat16)(randn(1, 64, 384))
    assert _counts() == before


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("deterministic", [True, False], ids=["B3", "B2"])
@pytest.mark.parametrize("case", HD80_BWD_CASES, ids=str)
def test_head_dim_80_backward_kernels_match_plain_version_on_the_card(
        case, deterministic):
    """B3 and B2 at head dim 80 without the band or the map (the
    instantiations of flash_bwd_80.cu): dq, dk, dv by the 2x rule against
    the plain fp32 backward with an autograd reference in the inputs'
    type, one launch of each kernel a call; B3 the same bits twice; the
    preprocess's delta within 1e-3 of its plain version's and its lse2
    within 1e-5 (+inf on the same rows)."""
    from flash_attn_tpu_torch.kernels import flash_bwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref_grads,
        check_against_ref,
    )

    b, sq, sk, h, h_k, d, causal, dtype = case
    q, k, v, do, out, lse = _dense_bwd_inputs(case, seed=sq + h)
    grads, n = _counted(lambda: flash_bwd.flash_attention_bwd(
        do, q, k, v, out, lse, causal=causal, deterministic=deterministic))
    mod = "flash_attn_tpu_torch.kernels.flash_bwd.launches_"
    want = {"dkdv": 1, "dq": 1} if deterministic else {"fused": 1}
    assert n == {mod + "preprocess": 1, **{mod + k_: c
                                           for k_, c in want.items()}}
    if deterministic:
        again = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse,
                                              causal=causal)
        assert all(torch.equal(a, c) for a, c in zip(grads, again))
    f32 = [x.float() for x in (do, q, k, v)]
    ref = flash_bwd.flash_attention_bwd_plain(*f32, out.float(), lse,
                                              causal=causal)
    ref_lp = attention_ref_grads(*(x.transpose(1, 2) for x in (q, k, v, do)),
                                 causal=causal, upcast=False)
    for name, got, r, lp in zip("qkv", grads, ref, ref_lp):
        check_against_ref(got.transpose(1, 2), r.transpose(1, 2), lp,
                          atol=1e-4, msg=f"{case} d{name}")
    delta, lse2 = flash_bwd.bwd_preprocess(do, out, lse)
    want_delta, want_lse2 = flash_bwd.bwd_preprocess_plain(
        do, out, lse, delta.shape[-1])
    fin = torch.isfinite(want_lse2)
    assert torch.equal(torch.isfinite(lse2), fin)
    torch.testing.assert_close(lse2[fin], want_lse2[fin], atol=1e-5, rtol=0)
    torch.testing.assert_close(delta, want_delta, atol=1e-3, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("form", ["plain", "band", "score"])
def test_head_dim_80_kernels_keep_to_their_80_columns_on_the_card(form):
    """No kernel at head dim 80 reads or writes past a row's 80 columns
    (utils/testing.py kept_columns_check): over q, k, v, out and dout whose
    heads of 80 sit in rows of 96, the last 16 NaN, B1, B3, B2, B6's and
    B7's forwards and B6's backward give the bits of contiguous inputs;
    with their outputs in rows of 96 whose last 16 columns hold a sentinel,
    and B2's fp32 dQ buffer followed by a sentinel tail, every sentinel
    survives and every output keeps its bits."""
    from flash_attn_tpu_torch.utils.testing import kept_columns_check

    tails, _ = kept_columns_check(form)
    assert tails >= 12


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("mode", ["static", "paged", "prefix"])
@pytest.mark.parametrize("n_embd, n_head", [(384, 4), (512, 2), (320, 4)],
                         ids=["d96", "d256", "d80"])
def test_graphed_decode_at_wide_head_dims_equals_eager_on_the_card(
        n_embd, n_head, mode):
    """A 2-layer GPT at head dim 96, 256 and 80 serves on the card: static
    decode replaying its captured step (B1, then B4 over a linear cache)
    gives the eager step's tokens and scores bitwise, and the engine's
    captured decode block (B4 over pages; admissions through B1, or B8
    under prefix caching) gives the eager block's tokens, with the same
    launches."""
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    model = _graph_model(mode != "static", n_embd=n_embd, n_head=n_head,
                         n_head_kv=n_head)
    if mode == "static":
        ids = torch.randint(0, 512, (3, 20), device="cuda", generator=torch.
                            Generator(device="cuda").manual_seed(1))
        cfg = GenerationConfig(max_length=48)
        want, n_eager = _counted(
            lambda: decode(ids, model, cfg, output_scores=True, cg=False))
        got, n_graph = _counted(
            lambda: decode(ids, model, cfg, output_scores=True, cg=True))
        assert n_eager == n_graph and n_eager
        assert torch.equal(want[0], got[0]) and torch.equal(want[2], got[2])
        return
    jobs = _engine_jobs(2, shared=40 if mode == "prefix" else 0)
    (want, n_eager), (got, n_graph) = (
        _serve(_engine(model, cg, prefix=mode == "prefix"), jobs)
        for cg in (False, True))
    assert got == want and n_graph == n_eager and n_eager
    assert [len(t) for t in got] == [m for _, m in jobs]


@pytest.mark.usefixtures("cuda_card")
def test_remat_losses_equal_across_policies_on_the_card():
    """GPTConfig(remat=True) on the card: a training step under 'full' and
    'dots' gives the loss and every gradient of the step without remat
    bitwise (the recompute runs the same deterministic kernels on the same
    inputs), and the recompute launches B1 once more a layer."""
    import dataclasses

    from flash_attn_tpu_torch.kernels import flash_fwd

    base = dict(vocab_size=512, n_positions=0, n_embd=256, n_layer=2,
                n_head=2, rotary_emb_fraction=1.0, use_rms_norm=True,
                glu_act=True, dtype=torch.bfloat16)
    ids = torch.randint(0, 512, (2, 257), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(3))
    results = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = dataclasses.replace(GPTConfig(**base), remat=remat,
                                  remat_policy=policy)
        model = GPTLMHeadModel(cfg, device="cuda")
        model.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
        before = flash_fwd.launches
        logits = model(ids[:, :-1])
        loss = torch.nn.functional.cross_entropy(logits.flatten(0, 1),
                                                 ids[:, 1:].flatten())
        loss.backward()
        torch.cuda.synchronize()
        results[(remat, policy)] = (
            loss.detach(), [p.grad for p in model.parameters()],
            flash_fwd.launches - before)
    want_loss, want_grads, n_plain = results[(False, "full")]
    assert n_plain == 2
    for key in ((True, "full"), (True, "dots")):
        loss, grads, n = results[key]
        assert torch.equal(loss, want_loss), key
        assert all(torch.equal(g, w) for g, w in zip(grads, want_grads)), key
        assert n == 4, key


def _band_refs(q, k, v, causal, band):
    """The fp32 plain forward (out (b, sq, h, d), lse (b, h, sq)) and the
    bf16 reference (attention_ref, upcast=False) of (b, s, h, d) q, k, v
    under ``band``, a batch row and a KV head at a time (no score matrix
    past one KV head's group)."""
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import attention_ref

    b, sq, h, d = q.shape
    h_k = k.shape[2]
    g = h // h_k
    ref = torch.empty(b, sq, h, d, device=q.device)
    lse = torch.empty(b, h, sq, device=q.device)
    ref_lp = torch.empty_like(q)
    for bi in range(b):
        for kh in range(h_k):
            qs = slice(kh * g, kh * g + g)
            qc, kc, vc = (q[bi:bi + 1, :, qs], k[bi:bi + 1, :, kh:kh + 1],
                          v[bi:bi + 1, :, kh:kh + 1])
            o, l = flash_fwd.flash_attention_fwd_plain(
                *(x.transpose(1, 2).float() for x in (qc, kc, vc)),
                causal=causal, **band)
            ref[bi, :, qs], lse[bi, qs] = o[0].transpose(0, 1), l[0]
            ref_lp[bi, :, qs] = attention_ref(qc, kc, vc, causal=causal,
                                              upcast=False, **band)[0][0]
    return ref, lse, ref_lp


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", BAND_FWD_CASES + HD80_BAND_FWD_CASES,
                         ids=lambda c: c[0])
def test_band_forward_kernel_matches_plain_version_on_the_card(case):
    """B1's band instantiation on every BAND_FWD_CASES case (one batch row
    of it): the 2x rule against the fp32 plain forward with a bf16
    reference, lse within 1e-3 on the rows that see a key and -inf on the
    same rows, the same bits twice, counted as the band's launches."""
    from flash_attn_tpu_torch.dispatch.config import normalize_window
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    name, _, sq, sk, h, h_k, d, causal, window, chunk, sink = case
    band = dict(window_size=normalize_window(window), sink_token_length=sink,
                attention_chunk=chunk)
    gen = torch.Generator(device="cuda").manual_seed(sq + sk)
    q, k, v = (torch.randn(1, n, heads, d, device="cuda", generator=gen)
               .bfloat16() for n, heads in ((sq, h), (sk, h_k), (sk, h_k)))
    args = [x.transpose(1, 2) for x in (q, k, v)]
    before = flash_fwd.launches_band
    out, lse = flash_fwd.flash_attention_fwd(*args, causal=causal, **band)
    again = flash_fwd.flash_attention_fwd(*args, causal=causal, **band)
    torch.cuda.synchronize()
    assert flash_fwd.launches_band == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse, ref_lp = _band_refs(q, k, v, causal, band)
    check_against_ref(out.transpose(1, 2), ref, ref_lp, msg=name)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-3, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", BAND_DECODE_CASES + HD80_BAND_DECODE_CASES,
                         ids=lambda c: c[0])
def test_band_decode_kernel_matches_plain_version_on_the_card(case):
    """B4 under the band on every BAND_DECODE_CASES case, linear and paged:
    the split partials against the plain version's on the CPU (lse -inf
    on the same (split, row)s, lse within 1e-3, out within 1e-3: both
    fp32 over the same bf16 inputs), the same bits twice, the merged
    output by the 2x rule, counted as the band's launches."""
    from flash_attn_tpu_torch.cache.kvcache import _default_num_splits
    from flash_attn_tpu_torch.dispatch.band import band_span
    from flash_attn_tpu_torch.dispatch.config import normalize_window
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
        paged_to_linear,
    )

    name, b, sq, h, h_k, d, page, keys, window, chunk, splits = case
    band = dict(window_size=normalize_window(window), attention_chunk=chunk)
    gen = torch.Generator(device="cuda").manual_seed(keys + sq)
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).bfloat16()
    if page:
        width = -(-keys // page)
        kc, vc = (torch.randn(b * width + 1, h_k, page, d, device="cuda",
                              generator=gen).bfloat16() for _ in range(2))
        table = (1 + torch.randperm(b * width, device="cuda", generator=gen)
                 ).reshape(b, width).int()
    else:
        kc, vc = (torch.randn(b, h_k, -(-keys // 128) * 128, d, device="cuda",
                              generator=gen).bfloat16() for _ in range(2))
        table = None
    lens = torch.full((b,), keys, dtype=torch.int32, device="cuda")
    splits = splits or _default_num_splits(
        q, kc, vc, table, False, band_span(True, band["window_size"], chunk,
                                           sq))
    counter = "launches_paged_band" if page else "launches_band"
    before = getattr(flash_decode, counter)
    out_p, lse_p = flash_decode.flash_attention_decode_partials(
        q, kc, vc, lens, splits, d ** -0.5, True, block_table=table, **band)
    again = flash_decode.flash_attention_decode_partials(
        q, kc, vc, lens, splits, d ** -0.5, True, block_table=table, **band)
    out, _ = flash_decode.flash_attention_decode(
        q, kc, vc, lens, causal=True, num_splits=splits, block_table=table,
        **band)
    torch.cuda.synchronize()
    assert getattr(flash_decode, counter) == before + 3
    assert torch.equal(out_p, again[0]) and torch.equal(lse_p, again[1])
    cpu = [x.float().cpu() for x in (q, kc, vc)]
    ref_p, ref_lse_p = flash_decode.flash_attention_decode_partials(
        *cpu, lens.cpu(), splits, d ** -0.5, True,
        block_table=None if table is None else table.cpu(), **band)
    empty = torch.isneginf(ref_lse_p)
    assert torch.equal(torch.isneginf(lse_p.cpu()), empty)
    torch.testing.assert_close(lse_p.cpu()[~empty], ref_lse_p[~empty],
                               atol=1e-3, rtol=0)
    torch.testing.assert_close(out_p.cpu(), ref_p, atol=1e-3, rtol=0)
    ref, _ = flash_decode.flash_attention_decode(
        *cpu, lens.cpu(), causal=True, num_splits=splits,
        block_table=None if table is None else table.cpu(), **band)
    lin = [x if table is None else paged_to_linear(x, table, lens)
           for x in (kc, vc)]
    keep = torch.arange(lin[0].shape[2], device="cuda")[None] < lens[:, None]
    ref_lp, _ = attention_ref(q, lin[0].transpose(1, 2),
                              lin[1].transpose(1, 2), key_padding_mask=keep,
                              causal=True, upcast=False, **band)
    check_against_ref(out, ref, ref_lp, msg=name)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", [
    BAND_VARLEN_CASE,
    ("ragged, window both ways", [300, 17, 128, 64], [812, 17, 400, 264],
     [300, 10, 128, 64], 16, 4, 128, 64, torch.bfloat16, False),
    ("d=64, pages of 16", [100, 200], [300, 200], None, 8, 8, 64, 16,
     torch.bfloat16, True)], ids=lambda c: c[0])
def test_band_varlen_paged_kernel_matches_plain_version_on_the_card(case):
    """B8's band instantiation (the window) against its plain version:
    Mistral-7B's prefix admission (window (4095, 0)), ragged chunks with
    seqused_q and a window both ways, pages of 16 at d = 64 (window (40,
    0)): the 2x rule, lse within 1e-3 and -inf on the same rows, the same
    bits twice, counted as the band's launches."""
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.utils.testing import (
        attention_varlen_paged_ref,
        check_against_ref,
    )

    name, lens_q, lens_k, used, h, h_k, d, page, dtype, causal = case
    window = {BAND_VARLEN_CASE[0]: MISTRAL_WINDOW,
              "ragged, window both ways": (100, 20)}.get(name, (40, 0))
    b = len(lens_q)
    gen = torch.Generator(device="cuda").manual_seed(b)
    cu = torch.tensor([0] + list(itertools.accumulate(lens_q)),
                      dtype=torch.int32, device="cuda")
    q = torch.randn(int(cu[-1]), h, d, device="cuda", generator=gen).to(dtype)
    width = -(-max(lens_k) // page)
    kp, vp = (torch.randn(b * width + 1, h_k, page, d, device="cuda",
                          generator=gen).to(dtype) for _ in range(2))
    table = (1 + torch.randperm(b * width, device="cuda", generator=gen)
             ).reshape(b, width).int()
    lens_k = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    used = None if used is None else torch.tensor(used, dtype=torch.int32,
                                                  device="cuda")
    args = (q, kp, vp, cu, max(lens_q), lens_k, table)
    kw = dict(seqused_q=used, causal=causal, window_size=window)
    before = fvp.launches_band
    out, lse = fvp.flash_attention_varlen_paged_fwd(*args, **kw)
    again = fvp.flash_attention_varlen_paged_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert fvp.launches_band == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = fvp.flash_attention_varlen_paged_fwd_plain(
        q.float(), kp.float(), vp.float(), *args[3:], **kw)
    ref_lp = attention_varlen_paged_ref(q, kp, vp, cu, lens_k, table,
                                        seqused_q=used, causal=causal,
                                        upcast=False, window_size=window)
    check_against_ref(out, ref, ref_lp, msg=name)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-3, rtol=0)


@pytest.mark.usefixtures("cuda_card")
def test_windows_that_reach_every_key_keep_the_band_free_kernels_on_the_card():
    """A window that reaches every key masks nothing: B1, B8 and B4 run
    their band-free kernels (no band launch counted) and give the bits of
    the call without a window."""
    from flash_attn_tpu_torch.kernels import (
        flash_decode,
        flash_fwd,
        flash_varlen_paged,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(2, 8, 300, 128, device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    kp = torch.randn(10, 8, 64, 128, device="cuda", generator=gen).bfloat16()
    table = torch.arange(10, dtype=torch.int32, device="cuda").reshape(2, 5)
    lens = torch.tensor([300, 250], dtype=torch.int32, device="cuda")
    cu = torch.tensor([0, 64, 128], dtype=torch.int32, device="cuda")
    qv = q.transpose(1, 2)[:, :64].reshape(128, 8, 128)

    def calls(wide):  # keys 300 (B1) and a capacity of 320 (B4, B8)
        return (flash_fwd.flash_attention_fwd(
                    q, k, v, causal=True,
                    window_size=(299, 0) if wide else (None, None)),
                flash_decode.flash_attention_decode(
                    q.transpose(1, 2)[:, -1:], kp, kp, lens, causal=True,
                    num_splits=2, block_table=table,
                    window_size=(319, 0) if wide else (None, None)),
                flash_varlen_paged.flash_attention_varlen_paged_fwd(
                    qv, kp, kp, cu, 64, lens, table, causal=True,
                    window_size=(319, 0) if wide else (None, None)))

    base = calls(False)
    wide, n = _counted(lambda: calls(True))
    assert n and not any("band" in key for key in n), n
    for a, b in zip(base, wide):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("mode", ["static", "paged", "prefix"])
def test_graphed_decode_with_a_window_equals_eager_on_the_card(mode):
    """A windowed model (window (15, 0), prompts and decode past it):
    static decode and the engine's decode block, replayed from their
    graphs, give the eager run's tokens and launches, and every attention
    launch is the band's."""
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    model = _graph_model(mode != "static", window_size=(15, 0))
    if mode == "static":
        ids = torch.randint(0, 512, (3, 40), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(1))
        cfg = GenerationConfig(max_length=80)
        runs = [_counted(lambda: decode(ids, model, cfg, output_scores=True,
                                        cg=cg)) for cg in (False, True)]
        (want, n_eager), (got, n_graph) = runs
        assert all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                   for x, y in zip(want, got))
    else:
        jobs = _engine_jobs(2, shared=40 if mode == "prefix" else 0)
        runs = [_serve(_engine(model, cg, prefix=mode == "prefix"), jobs)
                for cg in (False, True)]
        (want, n_eager), (got, n_graph) = runs
        assert got == want
    assert n_graph == n_eager
    # every decode launch is the band's (the caches hold more than the
    # window); the admissions' too where their padded rows pass it
    pre = "flash_attn_tpu_torch.kernels.flash_decode."
    for kernel, band in (("launches", "launches_band"),
                         ("launches_paged", "launches_paged_band")):
        assert n_eager.get(pre + kernel, 0) == n_eager.get(pre + band, 0)
    assert sum(n for key, n in n_eager.items()
               if "band" in key and "decode" not in key) > 0


def _band_of(case):
    """The flash_attention_fwd / _bwd band arguments of a BAND_*_CASES
    case."""
    from flash_attn_tpu_torch.dispatch.config import normalize_window

    *_, window, chunk, sink = case
    return dict(window_size=normalize_window(window), sink_token_length=sink,
                attention_chunk=chunk)


def _band_bwd_inputs(case, rows: int = 1, seed: int = 0):
    """q, k, v, do as (b, h, s, d) views of (b, s, h, d) bf16 tensors on
    the card for ``rows`` batch rows of a BAND_BWD_CASES case, with B1's
    band forward's out and lse."""
    from flash_attn_tpu_torch.kernels import flash_fwd

    _, _, sq, sk, h, h_k, d, causal, *_ = case
    gen = torch.Generator(device="cuda").manual_seed(seed + sq + sk)
    q, k, v, do = (torch.randn(rows, n, heads, d, device="cuda",
                               generator=gen).bfloat16().transpose(1, 2)
                   for n, heads in ((sq, h), (sk, h_k), (sk, h_k), (sq, h)))
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal,
                                             **_band_of(case))
    return q, k, v, do, out, lse


def _band_bwd_refs(q, k, v, do, causal, band):
    """The 2x rule's references of a band backward, a batch row and a KV
    head's group at a time: the plain fp32 backward from fp32 copies and
    autograd through attention_ref in bf16. Returns (grads32 (b, h, s, d),
    grads_lp (b, s, h, d))."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import attention_ref_grads

    b, h, sq, d = q.shape
    h_k = k.shape[1]
    g = h // h_k
    g32 = [torch.empty(x.shape, device="cuda") for x in (q, k, v)]
    glp = [torch.empty_like(x.transpose(1, 2)) for x in (q, k, v)]
    for bi in range(b):
        for kh in range(h_k):
            qs, ks = slice(kh * g, kh * g + g), slice(kh, kh + 1)
            qc, kc, vc, dc = (x[bi:bi + 1, hs] for x, hs in
                              ((q, qs), (k, ks), (v, ks), (do, qs)))
            f32 = [x.float() for x in (qc, kc, vc)]
            o32, l32 = flash_fwd.flash_attention_fwd_plain(*f32, causal=causal,
                                                           **band)
            r = flash_bwd.flash_attention_bwd_plain(dc.float(), *f32, o32, l32,
                                                    causal=causal, **band)
            lp = attention_ref_grads(*(x.transpose(1, 2)
                                       for x in (qc, kc, vc, dc)),
                                     causal=causal, upcast=False, **band)
            for i, hs in enumerate((qs, ks, ks)):
                g32[i][bi:bi + 1, hs] = r[i]
                glp[i][bi:bi + 1, :, hs] = lp[i]
            del f32, o32, l32, r, lp
    return g32, glp


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("deterministic", [True, False], ids=["B3", "B2"])
@pytest.mark.parametrize("case", BAND_BWD_CASES + HD80_BAND_BWD_CASES,
                         ids=lambda c: c[0])
def test_band_backward_kernels_match_plain_version_on_the_card(case,
                                                              deterministic):
    """B3's (and B2's) band instantiation on every BAND_BWD_CASES case (one
    batch row of it): dq, dk, dv by the 2x rule against the plain fp32 band
    backward with a bf16 autograd reference, counted as the band's
    launches; B3 the same bits twice."""
    from flash_attn_tpu_torch.kernels import flash_bwd
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    causal, band = case[7], _band_of(case)
    q, k, v, do, out, lse = _band_bwd_inputs(case)
    counter = "launches_dkdv_band" if deterministic else "launches_fused_band"
    before = getattr(flash_bwd, counter)
    grads = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse, causal=causal,
                                          deterministic=deterministic, **band)
    torch.cuda.synchronize()
    assert getattr(flash_bwd, counter) == before + 1
    if deterministic:
        again = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse,
                                              causal=causal, **band)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
    ref, ref_lp = _band_bwd_refs(q, k, v, do, causal, band)
    for name, got, r, lp in zip("qkv", grads, ref, ref_lp):
        check_against_ref(got.transpose(1, 2), r.transpose(1, 2), lp,
                          atol=1e-4, msg=f"{case[0]} d{name}")


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", [c for c in BAND_BWD_CASES
                                  + HD80_BAND_BWD_CASES if c[10] == 0],
                         ids=lambda c: c[0])
def test_band_varlen_kernels_equal_dense_ones_on_the_card(case):
    """Two batch rows of a BAND_BWD_CASES case (no sinks: the varlen route
    takes none) packed as two sequences: B6's and B7's band forwards give
    B1's band bits, B6's band backward gives B3's, each counted as its
    band launch."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp

    _, _, sq, sk, h, h_k, d, causal, *_ = case
    band = _band_of(case)
    vband = dict(window_size=band["window_size"],
                 attention_chunk=band["attention_chunk"])
    q, k, v, do, out, lse = _band_bwd_inputs(case, rows=2)
    grads = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse, causal=causal,
                                          **band)
    cu_q, cu_k = (torch.arange(3, dtype=torch.int32, device="cuda") * n
                  for n in (sq, sk))
    pq, pk, pv, pdo, po = (x.transpose(1, 2).reshape(2 * x.shape[2],
                                                     x.shape[1], d)
                           for x in (q, k, v, do, out))
    plse = lse.permute(1, 0, 2).reshape(h, 2 * sq).contiguous()
    args = (cu_q, cu_k, sq, sk)
    before = (flash_varlen.launches_fwd_band, fvp.launches_band,
              flash_varlen.launches_dkdv_band, flash_varlen.launches_dq_band)
    for fwd in (flash_varlen.flash_attention_varlen_fwd,
                fvp.flash_attention_varlen_fwd_persistent):
        o, l = fwd(pq, pk, pv, *args, causal=causal, **vband)
        assert torch.equal(o.reshape(2, sq, h, d), out.transpose(1, 2)), fwd
        assert torch.equal(l.reshape(h, 2, sq).transpose(0, 1), lse), fwd
    pg = flash_varlen.flash_attention_varlen_bwd(pdo, pq, pk, pv, po, plse,
                                                 *args, causal=causal, **vband)
    torch.cuda.synchronize()
    for got, want in zip(pg, grads):
        assert torch.equal(got.reshape(2, -1, *got.shape[1:]),
                           want.transpose(1, 2))
    after = (flash_varlen.launches_fwd_band, fvp.launches_band,
             flash_varlen.launches_dkdv_band, flash_varlen.launches_dq_band)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("window, chunk", [((100, 0), 0), ((60, 30), 0),
                                           ((-1, -1), 64)],
                         ids=["causal window", "window both ways", "chunk"])
def test_band_varlen_ragged_matches_plain_version_on_the_card(window, chunk):
    """The packed band kernels on ragged sequences (zero-length ones, key
    counts off the tiles, seqused, a packed tail, GQA) against their plain
    versions: B6's and B7's band forwards by the 2x rule (bitwise equal to
    each other), B6's band backward by the 2x rule, rows outside the
    sequences zero."""
    from flash_attn_tpu_torch.dispatch.config import normalize_window
    from flash_attn_tpu_torch.kernels import flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    causal = window[1] == 0 or chunk > 0
    lens = [300, 0, 129, 500, 77]
    used = torch.tensor([300, 0, 100, 500, 77], dtype=torch.int32,
                        device="cuda")
    total = sum(lens) + 10  # a packed tail past the last sequence
    cu = torch.tensor([0, *itertools.accumulate(lens)], dtype=torch.int32,
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, do = (torch.randn(total, 8, 128, device="cuda", generator=gen)
             .bfloat16() for _ in range(2))
    k, v = (torch.randn(total, 2, 128, device="cuda", generator=gen)
            .bfloat16() for _ in range(2))
    band = dict(window_size=normalize_window(window), attention_chunk=chunk)
    args = (cu, cu, max(lens), max(lens), used, used)
    out, lse = flash_varlen.flash_attention_varlen_fwd(q, k, v, *args,
                                                       causal=causal, **band)
    out7, lse7 = fvp.flash_attention_varlen_fwd_persistent(
        q, k, v, *args, causal=causal, **band)
    assert torch.equal(out, out7) and torch.equal(lse, lse7)
    f32 = [x.float().cpu() for x in (q, k, v)]
    cpu_args = tuple(x.cpu() if torch.is_tensor(x) else x for x in args)
    ref, ref_lse = flash_varlen.flash_attention_varlen_fwd_plain(
        *f32, *cpu_args, causal=causal, **band)
    ref_p, ref_p_lse = fvp.flash_attention_varlen_fwd_persistent_plain(
        *f32, *cpu_args, causal=causal, **band)
    torch.testing.assert_close(ref_p, ref, atol=1e-5, rtol=1e-5)
    lp = flash_varlen.flash_attention_varlen_fwd_plain(
        *(x.cpu() for x in (q, k, v)), *cpu_args, causal=causal, **band)[0]
    check_against_ref(out.cpu(), ref, lp, msg=f"B6 band {window} {chunk}")
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse.cpu()), fin)
    torch.testing.assert_close(lse.cpu()[fin], ref_lse[fin], atol=1e-3,
                               rtol=0)
    grads = flash_varlen.flash_attention_varlen_bwd(do, q, k, v, out, lse,
                                                    *args, causal=causal,
                                                    **band)
    g32 = flash_varlen.flash_attention_varlen_bwd_plain(
        do.float().cpu(), *f32, ref, ref_lse, *cpu_args, causal=causal,
        **band)
    glp = flash_varlen.flash_attention_varlen_bwd_plain(
        *(x.cpu() for x in (do, q, k, v)), lp, ref_lse, *cpu_args,
        causal=causal, **band)
    for name, got, r, l_ in zip("qkv", grads, g32, glp):
        check_against_ref(got.cpu(), r, l_, atol=1e-4,
                          msg=f"B6 band backward d{name} {window} {chunk}")


@pytest.mark.usefixtures("cuda_card")
def test_band_backward_windows_that_reach_every_key_stay_band_free_on_the_card():
    """A window that reaches every key masks nothing: the dense backward
    (both modes) and the packed forwards and backward run their band-free
    kernels (no band launch counted) and give the bits of the call without
    a window."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp

    case = ("reach", 2, 300, 300, 8, 2, 128, True, (-1, -1), 0, 0)
    q, k, v, do, out, lse = _band_bwd_inputs(case, rows=2)
    cu = torch.tensor([0, 300, 600], dtype=torch.int32, device="cuda")
    pq, pk, pv, pdo, po = (x.transpose(1, 2).reshape(600, x.shape[1], 128)
                           for x in (q, k, v, do, out))
    plse = lse.permute(1, 0, 2).reshape(8, 600).contiguous()

    def calls(window):
        res = [flash_bwd.flash_attention_bwd(do, q, k, v, out, lse,
                                             causal=True, deterministic=det,
                                             window_size=window)
               for det in (True, False)]
        args = (cu, cu, 300, 300)
        res.append(flash_varlen.flash_attention_varlen_fwd(
            pq, pk, pv, *args, causal=True, window_size=window))
        res.append(fvp.flash_attention_varlen_fwd_persistent(
            pq, pk, pv, *args, causal=True, window_size=window))
        res.append(flash_varlen.flash_attention_varlen_bwd(
            pdo, pq, pk, pv, po, plse, *args, causal=True,
            window_size=window))
        return res

    base = calls((None, None))
    wide, n = _counted(lambda: calls((299, 0)))
    assert n and not any("band" in key for key in n), n
    for i, (a, b) in enumerate(zip(base, wide)):
        same = [torch.equal(x, y) for x, y in zip(a, b)]
        # B2's dq sums with atomics: its bits may vary from run to run
        assert all(same if i != 1 else same[1:]), (i, same)


def _score_refs(q, k, v, causal, kw):
    """The fp32 plain forward (out (b, sq, h, d), lse) and the low-precision
    reference of one batch row of a SCORE_FWD_CASES case."""
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import attention_ref

    o, lse = flash_fwd.flash_attention_fwd_plain(
        *(x.transpose(1, 2).float() for x in (q, k, v)), causal=causal, **kw)
    ref_lp, _ = attention_ref(q, k, v, causal=causal, upcast=False, **kw)
    return o.transpose(1, 2), lse, ref_lp


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", SCORE_FWD_CASES + HD80_SCORE_FWD_CASES,
                         ids=lambda c: c[0])
def test_score_forward_kernel_matches_plain_version_on_the_card(case):
    """B1's score instantiation (softcap, ALiBi, both, under a window) on
    every SCORE_FWD_CASES case (two batch rows of it, the (b, h) slopes of
    the case's first two rows): the 2x rule against the fp32 plain forward,
    lse within 1e-3 in JAX's last-key form and -inf on the same rows, the
    same bits twice, counted as the score map's launches."""
    from flash_attn_tpu_torch.dispatch.config import normalize_window
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    name, b, sq, sk, h, h_k, d, causal, cap, kind, window, dtype = case
    b = min(b, 2)
    kw = dict(softcap=cap, window_size=normalize_window(window),
              alibi_slopes=score_slopes(kind, b, h, "cuda"))
    gen = torch.Generator(device="cuda").manual_seed(sq + sk + h)
    q, k, v = (torch.randn(b, n, heads, d, device="cuda", generator=gen)
               .to(dtype) for n, heads in ((sq, h), (sk, h_k), (sk, h_k)))
    args = [x.transpose(1, 2) for x in (q, k, v)]
    before = flash_fwd.launches_score
    out, lse = flash_fwd.flash_attention_fwd(*args, causal=causal, **kw)
    again = flash_fwd.flash_attention_fwd(*args, causal=causal, **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches_score == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse, ref_lp = _score_refs(q, k, v, causal, kw)
    check_against_ref(out.transpose(1, 2), ref, ref_lp, msg=name)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-3, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", SCORE_DECODE_CASES + HD80_SCORE_DECODE_CASES,
                         ids=lambda c: c[0])
def test_score_decode_kernel_matches_plain_version_on_the_card(case):
    """B4 with softcap or ALiBi on every SCORE_DECODE_CASES case, linear and
    paged: the split partials against the plain version's on the CPU (lse
    within 1e-3 in the last-key form, which combine_splits merges, out
    within 1e-3: both fp32 over the same bf16 inputs), the same bits twice,
    the merged output by the 2x rule, counted as the score map's
    launches."""
    from flash_attn_tpu_torch.cache.kvcache import _default_num_splits
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
        paged_to_linear,
    )

    name, b, sq, h, h_k, d, page, keys, cap, kind, splits, causal = case
    kw = dict(softcap=cap, alibi_slopes=score_slopes(kind, b, h, "cuda"))
    gen = torch.Generator(device="cuda").manual_seed(keys + sq + h)
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).bfloat16()
    if page:
        width = -(-keys // page)
        kc, vc = (torch.randn(b * width + 1, h_k, page, d, device="cuda",
                              generator=gen).bfloat16() for _ in range(2))
        table = (1 + torch.randperm(b * width, device="cuda", generator=gen)
                 ).reshape(b, width).int()
    else:
        kc, vc = (torch.randn(b, h_k, -(-keys // 128) * 128, d, device="cuda",
                              generator=gen).bfloat16() for _ in range(2))
        table = None
    lens = (keys - 37 * torch.arange(b, device="cuda")).clamp(min=sq).int()
    splits = splits or _default_num_splits(q, kc, vc, table, False)
    counter = "launches_paged_score" if page else "launches_score"
    before = getattr(flash_decode, counter)
    args = (q, kc, vc, lens, splits, d ** -0.5, causal)
    out_p, lse_p = flash_decode.flash_attention_decode_partials(
        *args, block_table=table, **kw)
    again = flash_decode.flash_attention_decode_partials(
        *args, block_table=table, **kw)
    out, _ = flash_decode.flash_attention_decode(
        q, kc, vc, lens, causal=causal, num_splits=splits, block_table=table,
        **kw)
    torch.cuda.synchronize()
    assert getattr(flash_decode, counter) == before + 3
    assert torch.equal(out_p, again[0]) and torch.equal(lse_p, again[1])
    cpu = [x.float().cpu() for x in (q, kc, vc)]
    kw_cpu = dict(kw, alibi_slopes=None if kw["alibi_slopes"] is None
                  else kw["alibi_slopes"].cpu())
    table_cpu = None if table is None else table.cpu()
    ref_p, ref_lse_p = flash_decode.flash_attention_decode_partials(
        *cpu, lens.cpu(), splits, d ** -0.5, causal, block_table=table_cpu,
        **kw_cpu)
    empty = torch.isneginf(ref_lse_p)
    assert torch.equal(torch.isneginf(lse_p.cpu()), empty)
    torch.testing.assert_close(lse_p.cpu()[~empty], ref_lse_p[~empty],
                               atol=1e-3, rtol=0)
    torch.testing.assert_close(out_p.cpu(), ref_p, atol=1e-3, rtol=0)
    ref, _ = flash_decode.flash_attention_decode(
        *cpu, lens.cpu(), causal=causal, num_splits=splits,
        block_table=table_cpu, **kw_cpu)
    lin = [x if table is None else paged_to_linear(x, table, lens)
           for x in (kc, vc)]
    keep = torch.arange(lin[0].shape[2], device="cuda")[None] < lens[:, None]
    ref_lp, _ = attention_ref(q, lin[0].transpose(1, 2),
                              lin[1].transpose(1, 2), key_padding_mask=keep,
                              causal=causal, upcast=False, **kw)
    check_against_ref(out, ref, ref_lp, msg=name)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", SCORE_VARLEN_CASES
                         + [c for c in HD80_VARLEN_CASES if c[1] > 0],
                         ids=lambda c: c[0][0])
def test_score_varlen_paged_kernel_matches_plain_version_on_the_card(case):
    """B8's score instantiation (the cap, with and without a window) on
    SCORE_VARLEN_CASES: the 2x rule, lse within 1e-3 and -inf on the same
    rows, the same bits twice, counted as the score map's launches."""
    from flash_attn_tpu_torch.dispatch.config import normalize_window
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.utils.testing import (
        attention_varlen_paged_ref,
        check_against_ref,
    )

    (name, lens_q, lens_k, used, h, h_k, d, page, dtype, causal), cap, \
        window = case
    kw = dict(softcap=cap, window_size=normalize_window(window))
    b = len(lens_q)
    gen = torch.Generator(device="cuda").manual_seed(b + h_k)
    cu = torch.tensor([0] + list(itertools.accumulate(lens_q)),
                      dtype=torch.int32, device="cuda")
    q = torch.randn(int(cu[-1]), h, d, device="cuda", generator=gen).to(dtype)
    width = -(-max(lens_k) // page)
    kp, vp = (torch.randn(b * width + 1, h_k, page, d, device="cuda",
                          generator=gen).to(dtype) for _ in range(2))
    table = (1 + torch.randperm(b * width, device="cuda", generator=gen)
             ).reshape(b, width).int()
    lens_k = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    args = (cu, max(lens_q), lens_k, table)
    before = fvp.launches_score
    out, lse = fvp.flash_attention_varlen_paged_fwd(q, kp, vp, *args,
                                                    causal=causal, **kw)
    again = fvp.flash_attention_varlen_paged_fwd(q, kp, vp, *args,
                                                 causal=causal, **kw)
    torch.cuda.synchronize()
    assert fvp.launches_score == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = fvp.flash_attention_varlen_paged_fwd_plain(
        q.float(), kp.float(), vp.float(), *args, causal=causal, **kw)
    ref_lp = attention_varlen_paged_ref(q, kp, vp, cu, lens_k, table,
                                        causal=causal, upcast=False, **kw)
    check_against_ref(out, ref, ref_lp, msg=name)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-3, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("mode", ["static", "engine"])
def test_graphed_decode_equals_eager_with_alibi_on_the_card(mode):
    """An ALiBi model decodes the same tokens (and static decode the same
    scores) bitwise replaying its captured step as eagerly, every attention
    launch the score map's: the slopes are a buffer the graph reads in
    place, and the causal bias takes each row's length from the device at
    every replay. Statically a softcap model too; through the engine over
    a paged cache (B4 paged), with slot reuse."""
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    def score_launches(n):
        score = [key for key in n if key.endswith("_score")]
        return score and all(n[key] == n[key[:-len("_score")]]
                             for key in score)

    if mode == "engine":
        model = _graph_model(True, use_alibi=True)
        jobs = _engine_jobs(4)
        (want, n_eager), (got, n_graph) = (
            _serve(_engine(model, cg), jobs) for cg in (False, True))
        assert got == want and n_graph == n_eager and score_launches(n_eager)
        return
    for fields in (dict(use_alibi=True), dict(softcap=5.0)):
        model = _graph_model(False, **fields)
        ids = torch.randint(
            0, 512, (3, 20), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(1))
        cfg = GenerationConfig(max_length=48)
        want, n_eager = _counted(lambda: decode(ids, model, cfg,
                                                output_scores=True, cg=False))
        got, n_graph = _counted(lambda: decode(ids, model, cfg,
                                               output_scores=True, cg=True))
        assert n_eager == n_graph and score_launches(n_eager)
        for x, y in zip(want, got):
            assert x == y if isinstance(x, int) else torch.equal(x, y)


@pytest.mark.usefixtures("cuda_card")
def test_score_refusals_on_the_card():
    """On the card as on the CPU: the slopes on the paged route and softcap
    on the MLA decode route raise NotImplementedError before any kernel
    runs; a gradient with softcap or ALiBi runs the score instantiations
    (finite gradients, the slopes' exactly zero)."""
    from flash_attn_tpu_torch.interface import flash_attn_varlen_func

    q = torch.randn(1, 128, 4, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    sl = torch.ones(4, device="cuda", requires_grad=True)
    for kw in (dict(softcap=30.0), dict(alibi_slopes=sl)):
        flash_attn_func(q, q, q, causal=True, **kw).float().square().sum(
            ).backward()
        assert torch.isfinite(q.grad).all()
        q.grad = None
    assert torch.equal(sl.grad, torch.zeros_like(sl))
    x = torch.randn(12, 2, 64, device="cuda", dtype=torch.bfloat16)
    kp = torch.zeros(12, 2, 16, 64, device="cuda", dtype=torch.bfloat16)
    cu = torch.tensor([0, 5, 12], dtype=torch.int32, device="cuda")
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="queue C"):
        flash_attn_varlen_func(x, kp, kp, cu, None, 7, 32, block_table=table,
                               seqused_k=torch.tensor([5, 7], device="cuda"),
                               alibi_slopes=torch.ones(2, device="cuda"))
    qd = torch.zeros(1, 1, 2, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 128, 64, device="cuda", dtype=torch.bfloat16)
    v = torch.zeros(1, 1, 128, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="item 7"):
        flash_attn_with_kvcache(qd, k, v, cache_seqlens=4, softcap=5.0,
                                qv=torch.zeros(1, 1, 2, 128, device="cuda",
                                               dtype=torch.bfloat16))


def _score_bwd_inputs(case, rows: int, seed: int = 0):
    """q, k, v, do as (b, h, s, d) views of (b, s, h, d) tensors on the card
    for ``rows`` batch rows of a SCORE_BWD_CASES case, its score and band
    arguments (the (b, h) slopes of its first ``rows`` rows; the softmax
    scale of a case named after BTLM-3B-8K, case_scale), and B1's score
    forward's out and lse."""
    from flash_attn_tpu_torch.dispatch.config import normalize_window
    from flash_attn_tpu_torch.kernels import flash_fwd

    name, _, sq, sk, h, h_k, d, causal, cap, kind, window, dtype, _ = case
    kw = dict(softcap=cap, window_size=normalize_window(window),
              alibi_slopes=score_slopes(kind, rows, h, "cuda"),
              softmax_scale=case_scale(name))
    gen = torch.Generator(device="cuda").manual_seed(seed + sq + sk + h)
    q, k, v, do = (torch.randn(rows, n, heads, d, device="cuda",
                               generator=gen).to(dtype).transpose(1, 2)
                   for n, heads in ((sq, h), (sk, h_k), (sk, h_k), (sq, h)))
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal, **kw)
    return q, k, v, do, out, lse, kw


def _score_bwd_refs(q, k, v, do, causal, kw):
    """The 2x rule's references of a score backward, a batch row and a KV
    head's group at a time (each with its rows' slopes): the plain fp32
    backward from fp32 copies and autograd through attention_ref in the
    inputs' type. Returns (grads32 (b, h, s, d), grads_lp (b, s, h, d))."""
    from flash_attn_tpu_torch.dispatch.score import slopes_bh
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import attention_ref_grads

    b, h, sq, d = q.shape
    h_k = k.shape[1]
    g = h // h_k
    sl = slopes_bh(kw["alibi_slopes"], b, h)
    g32 = [torch.empty(x.shape, device="cuda") for x in (q, k, v)]
    glp = [torch.empty_like(x.transpose(1, 2)) for x in (q, k, v)]
    for bi in range(b):
        for kh in range(h_k):
            qs, ks = slice(kh * g, kh * g + g), slice(kh, kh + 1)
            part = dict(kw, alibi_slopes=None if sl is None
                        else sl[bi:bi + 1, qs])
            qc, kc, vc, dc = (x[bi:bi + 1, hs] for x, hs in
                              ((q, qs), (k, ks), (v, ks), (do, qs)))
            f32 = [x.float() for x in (qc, kc, vc)]
            o32, l32 = flash_fwd.flash_attention_fwd_plain(
                *f32, causal=causal, **part)
            r = flash_bwd.flash_attention_bwd_plain(dc.float(), *f32, o32, l32,
                                                    causal=causal, **part)
            lp = attention_ref_grads(*(x.transpose(1, 2)
                                       for x in (qc, kc, vc, dc)),
                                     causal=causal, upcast=False, **part)
            for i, hs in enumerate((qs, ks, ks)):
                g32[i][bi:bi + 1, hs] = r[i]
                glp[i][bi:bi + 1, :, hs] = lp[i]
            del f32, o32, l32, r, lp
    return g32, glp


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case, deterministic", [
    (c, det) for c in SCORE_BWD_CASES + HD80_SCORE_BWD_CASES
    for det in ((True, False) if c[12] else (True,))],
    ids=lambda x: x[0] if isinstance(x, tuple) else "B3" if x else "B2")
def test_score_backward_kernels_match_plain_version_on_the_card(
        case, deterministic):
    """B3's (and, where the case asks, B2's) score instantiation on every
    SCORE_BWD_CASES case (one batch row of it): dq, dk, dv by the 2x rule
    against the plain fp32 score backward with an autograd reference in
    the inputs' type, counted as the score map's launches; B3 the same bits
    twice."""
    from flash_attn_tpu_torch.kernels import flash_bwd
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    causal = case[7]
    q, k, v, do, out, lse, kw = _score_bwd_inputs(case, rows=1)
    counter = "launches_dkdv_score" if deterministic else \
        "launches_fused_score"
    before = getattr(flash_bwd, counter)
    grads = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse, causal=causal,
                                          deterministic=deterministic, **kw)
    torch.cuda.synchronize()
    assert getattr(flash_bwd, counter) == before + 1
    if deterministic:
        again = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse,
                                              causal=causal, **kw)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
    ref, ref_lp = _score_bwd_refs(q, k, v, do, causal, kw)
    for name, got, r, lp in zip("qkv", grads, ref, ref_lp):
        check_against_ref(got.transpose(1, 2), r.transpose(1, 2), lp,
                          atol=1e-4, msg=f"{case[0]} d{name}")


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", SCORE_BWD_CASES + HD80_SCORE_BWD_CASES,
                         ids=lambda c: c[0])
def test_score_varlen_kernels_equal_dense_ones_on_the_card(case):
    """Two batch rows of a SCORE_BWD_CASES case packed as two sequences,
    each taking its row's slopes: B6's and B7's score forwards give B1's
    score bits, B6's score backward gives B3's, each counted as its score
    launch."""
    from flash_attn_tpu_torch.dispatch.score import slopes_bh
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp

    _, _, sq, sk, h, h_k, d, causal, *_ = case
    q, k, v, do, out, lse, kw = _score_bwd_inputs(case, rows=2)
    grads = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse, causal=causal,
                                          **kw)
    vkw = dict(softcap=kw["softcap"], window_size=kw["window_size"],
               softmax_scale=kw["softmax_scale"],
               alibi_slopes=slopes_bh(kw["alibi_slopes"], 2, h))
    cu_q, cu_k = (torch.arange(3, dtype=torch.int32, device="cuda") * n
                  for n in (sq, sk))
    pq, pk, pv, pdo, po = (x.transpose(1, 2).reshape(2 * x.shape[2],
                                                     x.shape[1], d)
                           for x in (q, k, v, do, out))
    plse = lse.permute(1, 0, 2).reshape(h, 2 * sq).contiguous()
    args = (cu_q, cu_k, sq, sk)
    counters = ((flash_varlen, "launches_fwd_score"), (fvp, "launches_score"),
                (flash_varlen, "launches_dkdv_score"),
                (flash_varlen, "launches_dq_score"))
    before = [getattr(m, n) for m, n in counters]
    for fwd in (flash_varlen.flash_attention_varlen_fwd,
                fvp.flash_attention_varlen_fwd_persistent):
        o, l = fwd(pq, pk, pv, *args, causal=causal, **vkw)
        assert torch.equal(o.reshape(2, sq, h, d), out.transpose(1, 2)), fwd
        assert torch.equal(l.reshape(h, 2, sq).transpose(0, 1), lse), fwd
    pg = flash_varlen.flash_attention_varlen_bwd(pdo, pq, pk, pv, po, plse,
                                                 *args, causal=causal, **vkw)
    torch.cuda.synchronize()
    for got, want in zip(pg, grads):
        assert torch.equal(got.reshape(2, -1, *got.shape[1:]),
                           want.transpose(1, 2))
    after = [getattr(m, n) for m, n in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("cap, kind, window", [
    (0.0, "2d", (-1, -1)), (5.0, None, (-1, -1)), (3.0, "1d", (60, 0))],
    ids=["alibi (b, h)", "cap", "both under a window"])
def test_score_varlen_ragged_matches_plain_version_on_the_card(cap, kind,
                                                               window):
    """The packed score kernels on ragged sequences (zero-length ones, key
    counts off the tiles, seqused, a packed tail, GQA), each sequence with
    its own slopes, against their plain versions: B6's and B7's score
    forwards by the 2x rule (bitwise equal to each other), B6's score
    backward by the 2x rule, rows outside the sequences zero."""
    from flash_attn_tpu_torch.dispatch.config import normalize_window
    from flash_attn_tpu_torch.kernels import flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    lens = [300, 0, 129, 500, 77]
    used = torch.tensor([300, 0, 100, 500, 77], dtype=torch.int32,
                        device="cuda")
    total = sum(lens) + 10  # a packed tail past the last sequence
    cu = torch.tensor([0, *itertools.accumulate(lens)], dtype=torch.int32,
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, do = (torch.randn(total, 8, 128, device="cuda", generator=gen)
             .bfloat16() for _ in range(2))
    k, v = (torch.randn(total, 2, 128, device="cuda", generator=gen)
            .bfloat16() for _ in range(2))
    kw = dict(softcap=cap, window_size=normalize_window(window),
              alibi_slopes=score_slopes(kind, len(lens), 8, "cuda"))
    args = (cu, cu, max(lens), max(lens), used, used)
    out, lse = flash_varlen.flash_attention_varlen_fwd(q, k, v, *args,
                                                       causal=True, **kw)
    out7, lse7 = fvp.flash_attention_varlen_fwd_persistent(
        q, k, v, *args, causal=True, **kw)
    assert torch.equal(out, out7) and torch.equal(lse, lse7)
    ckw = dict(kw, alibi_slopes=None if kw["alibi_slopes"] is None
               else kw["alibi_slopes"].cpu())
    f32 = [x.float().cpu() for x in (q, k, v)]
    cpu_args = tuple(x.cpu() if torch.is_tensor(x) else x for x in args)
    ref, ref_lse = flash_varlen.flash_attention_varlen_fwd_plain(
        *f32, *cpu_args, causal=True, **ckw)
    lp = flash_varlen.flash_attention_varlen_fwd_plain(
        *(x.cpu() for x in (q, k, v)), *cpu_args, causal=True, **ckw)[0]
    check_against_ref(out.cpu(), ref, lp, msg=f"B6 score {cap} {kind}")
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse.cpu()), fin)
    torch.testing.assert_close(lse.cpu()[fin], ref_lse[fin], atol=1e-3,
                               rtol=0)
    grads = flash_varlen.flash_attention_varlen_bwd(do, q, k, v, out, lse,
                                                    *args, causal=True, **kw)
    g32 = flash_varlen.flash_attention_varlen_bwd_plain(
        do.float().cpu(), *f32, ref, ref_lse, *cpu_args, causal=True, **ckw)
    glp = flash_varlen.flash_attention_varlen_bwd_plain(
        *(x.cpu() for x in (do, q, k, v)), lp, ref_lse, *cpu_args,
        causal=True, **ckw)
    for name, got, r, l_ in zip("qkv", grads, g32, glp):
        check_against_ref(got.cpu(), r, l_, atol=1e-4,
                          msg=f"B6 score backward d{name} {cap} {kind}")


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", KVQUANT_DECODE_CASES
                         + HD80_KVQUANT_DECODE_CASES, ids=lambda c: c[0])
def test_kvquant_decode_kernel_matches_plain_version_on_the_card(case):
    """B4 over a 1-byte cache with distinct (b, h_k) descales on every
    KVQUANT_DECODE_CASES case: the split partials against the plain
    version's on the CPU over the same codes (both fp32; out and lse
    within 1e-3), the same bits twice, counted as the 1-byte cache's
    launches."""
    from flash_attn_tpu_torch.cache.kvcache import _default_num_splits
    from flash_attn_tpu_torch.kernels import flash_decode

    name, b, sq, h, h_k, d, page, keys, dt, window, slopes, splits = case
    window = tuple(None if x < 0 else x for x in window)
    gen = torch.Generator(device="cuda").manual_seed(keys + sq + d)
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).bfloat16()
    if page:
        width = -(-keys // page)
        x = torch.randn(2, b * width + 1, h_k, page, d, device="cuda",
                        generator=gen)
        table = (1 + torch.randperm(b * width, device="cuda", generator=gen)
                 ).reshape(b, width).int()
    else:
        x = torch.randn(2, b, h_k, -(-keys // 128) * 128, d, device="cuda",
                        generator=gen)
        table = None
    (kc, vc), unit = kv_codes(x, dt)
    lens = (keys - (37 * torch.arange(b, device="cuda"))
            % max(1, min(keys - sq, 64))).int()
    qd, kd, vd = kv_descales(b, h_k, "cuda")
    kw = dict(qk_descale=(qd * kd * unit).contiguous(),
              v_descale=(vd * unit).contiguous(), window_size=window,
              alibi_slopes=score_slopes(slopes, b, h, "cuda"))
    splits = splits or _default_num_splits(q, kc, vc, table, False)
    counter = "launches_paged_kv8" if page else "launches_kv8"
    before = getattr(flash_decode, counter)
    args = (q, kc, vc, lens, splits, d ** -0.5, True)
    out_p, lse_p = flash_decode.flash_attention_decode_partials(
        *args, block_table=table, **kw)
    again = flash_decode.flash_attention_decode_partials(
        *args, block_table=table, **kw)
    torch.cuda.synchronize()
    assert getattr(flash_decode, counter) == before + 2
    assert torch.equal(out_p, again[0]) and torch.equal(lse_p, again[1])
    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()}
    ref_p, ref_lse_p = flash_decode.flash_attention_decode_partials(
        q.float().cpu(), kc.cpu(), vc.cpu(), lens.cpu(), splits, d ** -0.5,
        True, block_table=None if table is None else table.cpu(), **cpu)
    empty = torch.isneginf(ref_lse_p)
    assert torch.equal(torch.isneginf(lse_p.cpu()), empty)
    torch.testing.assert_close(lse_p.cpu()[~empty], ref_lse_p[~empty],
                               atol=1e-3, rtol=0)
    torch.testing.assert_close(out_p.cpu(), ref_p, atol=1e-3, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", KVQUANT_VARLEN_CASES
                         + HD80_KVQUANT_VARLEN_CASES, ids=lambda c: c[0][0])
def test_kvquant_varlen_paged_matches_plain_version_on_the_card(case):
    """B8 with descales on every KVQUANT_VARLEN_CASES case, over 1-byte
    pages (through kv_dequant's conversion, whose pool equals the plain
    conversion bitwise on every page a row reaches) or a bf16 cache: out
    within 2e-2 and lse within 1e-3 of the plain version's, the same bits
    twice, counted as the descales' launches (and the conversion's)."""
    from flash_attn_tpu_torch.dispatch.kvquant import is_quantized
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.kernels import kv_dequant

    (name, lens_q, lens_k, used, h, h_k, d, page, dtype, causal, cdt), \
        window, cap = case
    window = tuple(None if x < 0 else x for x in window)
    b = len(lens_q)
    gen = torch.Generator(device="cuda").manual_seed(sum(lens_k) + d)
    cu = torch.tensor([0] + list(itertools.accumulate(lens_q)),
                      dtype=torch.int32, device="cuda")
    q = torch.randn(int(cu[-1]), h, d, device="cuda", generator=gen).to(dtype)
    width = -(-max(max(lens_k), 1) // page)
    x = torch.randn(2, b * width + 1, h_k, page, d, device="cuda",
                    generator=gen)
    (kp, vp), unit = kv_codes(x, cdt)
    table = (1 + torch.randperm(b * width, device="cuda", generator=gen)
             ).reshape(b, width).int()
    lens = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    qd, kd, vd = kv_descales(b, h_k, "cuda")
    kw = dict(seqused_q=None if used is None else torch.tensor(
        used, dtype=torch.int32, device="cuda"), causal=causal,
        window_size=window, softcap=cap,
        qk_descale=(qd * kd * unit).contiguous(),
        v_descale=(vd * unit).contiguous())
    args = (cu, max(max(lens_q), 1), lens, table)
    before = fvp.launches_descale, kv_dequant.launches
    out, lse = fvp.flash_attention_varlen_paged_fwd(q, kp, vp, *args, **kw)
    again = fvp.flash_attention_varlen_paged_fwd(q, kp, vp, *args, **kw)
    torch.cuda.synchronize()
    quant = is_quantized(cdt)
    assert fvp.launches_descale == before[0] + 2
    assert kv_dequant.launches == before[1] + 2 * quant
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = fvp.flash_attention_varlen_paged_fwd_plain(
        q.float(), kp, vp, *args, **kw)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=0)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-3, rtol=0)
    if quant:
        pools = kv_dequant.dequant_pages(kp, vp, table, lens, dtype)
        plain = kv_dequant.dequant_pages_plain(kp, vp, table, lens, dtype)
        reached = kv_dequant.pages_reached(lens, page, width).reshape(-1)
        for got, want in zip(pools[:2], plain[:2]):
            assert torch.equal(got[reached].view(torch.int16),
                               want[reached].view(torch.int16))


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("dt", [torch.float8_e4m3fn, torch.int8],
                         ids=["e4m3", "int8"])
def test_kv_conversion_is_exact_on_the_card(dt):
    """B11's conversion: one key at d = 256 whose V row holds every code
    (e4m3's two NaN codes left out) gives, through B4's fp32 partial and
    through B8's bf16 out, each code's value times v_descale 0.5 exactly."""
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp

    c = torch.arange(256, dtype=torch.int32, device="cuda").to(torch.uint8)
    keep = torch.ones(256, dtype=torch.bool, device="cuda")
    if dt == torch.float8_e4m3fn:
        keep = (c != 0x7F) & (c != 0xFF)
    c = torch.where(keep, c, torch.zeros_like(c))
    want = c.view(dt).float() * 0.5 + 0.0
    vs = torch.full((1, 1), 0.5, device="cuda")
    q = torch.randn(1, 1, 1, 256, device="cuda").bfloat16()
    kc = torch.zeros(1, 1, 128, 256, dtype=torch.uint8, device="cuda")
    vc = kc.clone()
    vc[0, 0, 0] = c
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    out_p, _ = flash_decode.flash_attention_decode_partials(
        q, kc.view(dt), vc.view(dt), one, 1, 1 / 16, True, v_descale=vs)
    assert torch.equal(out_p[0, 0, 0, 0].view(torch.int32),
                       want.view(torch.int32))
    kp = torch.zeros(2, 1, 16, 256, dtype=torch.uint8, device="cuda")
    vp = kp.clone()
    vp[1, 0, 0] = c
    out, _ = fvp.flash_attention_varlen_paged_fwd(
        q[0], kp.view(dt), vp.view(dt), torch.tensor(
            [0, 1], dtype=torch.int32, device="cuda"), 1, one,
        one[:, None], causal=True, v_descale=vs)
    assert torch.equal(out[0, 0].view(torch.int16),
                       want.bfloat16().view(torch.int16))


@pytest.mark.usefixtures("cuda_card")
def test_quantized_cache_refusals_on_the_card():
    """On the card the kernels read a cache of q's type or of 1-byte codes
    with a bf16 q: other cache types raise naming queue A item 7, in MHA
    and in flash_attn_with_kvcache."""
    from flash_attn_tpu_torch.modules.mha import MHA

    with pytest.raises(NotImplementedError, match="item 7"):
        MHA(128, 2, kv_cache_dtype=torch.float8_e5m2, device="cuda")
    with pytest.raises(NotImplementedError, match="item 7"):
        MHA(128, 2, kv_cache_dtype=torch.float16, device="cuda")
    q = torch.randn(1, 1, 2, 64, device="cuda").bfloat16()
    for dt in (torch.float8_e5m2, torch.float16):
        kc = torch.zeros(1, 2, 128, 64, device="cuda").to(dt)
        with pytest.raises(NotImplementedError, match="item 7"):
            flash_attn_with_kvcache(q, kc, kc.clone(), cache_seqlens=1)
    kc = torch.zeros(1, 2, 128, 64, device="cuda").to(torch.float8_e4m3fn)
    from flash_attn_tpu_torch.kernels import flash_decode

    with pytest.raises(ValueError, match="bf16 q"):
        flash_decode.flash_attention_decode(
            q.half(), kc, kc.clone(), one_len(), num_splits=1)


def one_len():
    return torch.ones(1, dtype=torch.int32, device="cuda")


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("dt", [torch.float8_e4m3fn, torch.int8],
                         ids=["e4m3", "int8"])
def test_quantized_cache_model_graphed_equals_eager_on_the_card(dt):
    """A small GPT over a 1-byte cache (kv_cache_scale 2): graphed decode
    gives the eager tokens and logits, every decode launch over the 1-byte
    cache, and the prefix-cached engine admits through B8 with descales
    after the conversion."""
    from flash_attn_tpu_torch.kernels import flash_decode, kv_dequant
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    cfg = GPTConfig(vocab_size=512, n_positions=0, n_embd=256, n_layer=2,
                    n_head=4, n_head_kv=2, rotary_emb_fraction=1.0,
                    use_rms_norm=True, glu_act=True, max_decode_seqlen=192,
                    kv_cache_dtype=dt, kv_cache_scale=2.0)
    model = GPTLMHeadModel(cfg, device="cuda")
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
    model.requires_grad_(False)
    ids = torch.randint(0, 512, (3, 40), device="cuda")
    gc = GenerationConfig(max_length=60)
    before = flash_decode.launches_kv8
    seqs, _, scores = decode(ids, model, gc, output_scores=True, cg=True)
    eager, _, eager_scores = decode(ids, model, gc, output_scores=True,
                                    cg=False)
    torch.cuda.synchronize()
    assert torch.equal(seqs, eager) and torch.equal(scores, eager_scores)
    assert flash_decode.launches_kv8 - before == 2 * 2 * 19
    import dataclasses

    paged = GPTLMHeadModel(dataclasses.replace(
        cfg, paged_kv_num_pages=13, paged_kv_page_size=64), device="cuda")
    paged.load_state_dict(model.state_dict())
    paged.requires_grad_(False)
    eng = InferenceEngine(paged, 2, GenerationConfig(top_k=1),
                          page_pool=PagePool(13, 64, 3, 2),
                          prefix_cache=True)
    before = fvp.launches_descale, kv_dequant.launches
    shared = list(range(64))
    for tail in (list(range(100, 110)), list(range(200, 220))):
        eng.submit(shared + tail, max_new_tokens=8)
    out = eng.run()
    eng.close()
    assert all(len(t) == 8 for t in out.values())
    assert fvp.launches_descale > before[0]
    assert kv_dequant.launches - before[1] == fvp.launches_descale - before[0]


# ---- the learnable sink on the card ---------------------------------------


def _sink_fwd_inputs(case, seed):
    """q, k, v as (b, h, s, d) views of (b, s, h, d) tensors on the card,
    the case's slopes and sinks, and its keyword arguments."""
    name, b, sq, sk, h, h_k, d, causal, window, cap, slopes, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, n, d, device="cuda", generator=gen).to(
        dtype).transpose(1, 2) for s, n in ((sq, h), (sk, h_k), (sk, h_k)))
    sink = sink_logits(h, sk, "cuda", gen)
    kw = dict(causal=causal, softcap=cap,
              window_size=tuple(None if x < 0 else x for x in window),
              alibi_slopes=score_slopes(slopes, b, h, "cuda"))
    return q, k, v, sink, kw


def _rows_without_keys(sq, sk, causal, window):
    """(sq,) bool on the card: the rows that see no key."""
    from flash_attn_tpu_torch.dispatch.band import band_valid

    rows = torch.arange(sq, device="cuda")[:, None]
    cols = torch.arange(sk, device="cuda")[None, :]
    return ~band_valid(rows, cols, sk - sq, causal, window).any(1)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", SINK_FWD_CASES, ids=lambda c: c[0])
def test_sink_forward_kernels_match_plain_version_on_the_card(case):
    """B1 with a learnable sink against the plain fp32 forward (out within
    2e-2, lse within 1e-3), the same bits twice, lse = sink exactly and out
    0 on the rows that see no key; B6's forward and B7 over the same rows
    packed give B1's bits; every launch counted among the sink's."""
    from flash_attn_tpu_torch.kernels import flash_fwd, flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp

    q, k, v, sink, kw = _sink_fwd_inputs(case, 24)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    before = (flash_fwd.launches_sink, flash_varlen.launches_fwd_sink,
              fvp.launches_sink)
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, learnable_sink=sink,
                                             **kw)
    again = flash_fwd.flash_attention_fwd(q, k, v, learnable_sink=sink, **kw)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = flash_fwd.flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), learnable_sink=sink, **kw)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    empty = _rows_without_keys(sq, sk, kw["causal"], kw["window_size"])
    assert torch.equal(lse[:, :, empty],
                       sink[None, :, None].expand(b, h, int(empty.sum())))
    assert not out[:, :, empty].any()
    cu_q, cu_k = (torch.arange(b + 1, dtype=torch.int32, device="cuda") * n
                  for n in (sq, sk))
    packed = [x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
              for x in (q, k, v)]
    band = dict(window_size=kw["window_size"], softcap=kw["softcap"],
                alibi_slopes=kw["alibi_slopes"])
    for fwd in (flash_varlen.flash_attention_varlen_fwd,
                fvp.flash_attention_varlen_fwd_persistent):
        o, l = fwd(*packed, cu_q, cu_k, sq, sk, causal=kw["causal"],
                   learnable_sink=sink, **band)
        assert torch.equal(o, out.transpose(1, 2).reshape(b * sq, h, d))
        assert torch.equal(l, lse.transpose(0, 1).reshape(h, b * sq))
    assert (flash_fwd.launches_sink, flash_varlen.launches_fwd_sink,
            fvp.launches_sink) == (before[0] + 2, before[1] + 1,
                                   before[2] + 1)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", SINK_VARLEN_CASES,
                         ids=lambda c: c[0][0])
def test_sink_varlen_paged_matches_plain_version_on_the_card(case):
    """B8 with a learnable sink (under the case's window and cap) against
    its plain version (out within 2e-2, lse within 1e-3), the same bits
    twice, the sink on every row no tile writes; over the same rows packed
    B6's forward gives its bits where B6 takes the form (no cap); and with
    descales over an fp8 pool against its plain version."""
    import numpy as np

    from flash_attn_tpu_torch.dispatch.kvquant import quantize_kv
    from flash_attn_tpu_torch.kernels import flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.utils.testing import paged_to_linear

    shape, cap, window = case
    window = tuple(None if x < 0 else x for x in window)
    q, kp, vp, cu, max_q, seqlens_k, table, seqused = _varlen_paged_inputs(
        shape, 24 + len(shape[1]))
    causal, lens_k, h = shape[-1], shape[2], shape[4]
    sink = sink_logits(h, max(lens_k), "cuda")
    kw = dict(seqused_q=seqused, causal=causal, window_size=window,
              softcap=cap, learnable_sink=sink)
    args = (cu, max_q, seqlens_k, table)
    before = fvp.launches_sink
    out, lse = fvp.flash_attention_varlen_paged_fwd(q, kp, vp, *args, **kw)
    again = fvp.flash_attention_varlen_paged_fwd(q, kp, vp, *args, **kw)
    assert fvp.launches_sink == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = fvp.flash_attention_varlen_paged_fwd_plain(
        q.float(), *(torch.nan_to_num(x.float()) for x in (kp, vp)), *args,
        **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    used = seqused.tolist() if seqused is not None else \
        [b - a for a, b in zip(cu.tolist()[:-1], cu.tolist()[1:])]
    dead = torch.ones(q.shape[0], dtype=torch.bool, device="cuda")
    for a, n in zip(cu.tolist(), used):
        dead[a:a + n] = False
    assert torch.equal(lse[:, dead], sink[:, None].expand(h, int(dead.sum())))
    if cap == 0.0:
        k, v = (torch.cat([lin[s, :, :n].transpose(0, 1)
                           for s, n in enumerate(lens_k)])
                for lin in (paged_to_linear(x, table, seqlens_k)
                            for x in (kp, vp)))
        cu_k = torch.tensor(np.concatenate([[0], np.cumsum(lens_k)]),
                            dtype=torch.int32, device="cuda")
        b6, b6_lse = flash_varlen.flash_attention_varlen_fwd(
            q, k.contiguous(), v.contiguous(), cu, cu_k, max_q,
            max(max(lens_k), 1), seqused_q=seqused, causal=causal,
            window_size=window, learnable_sink=sink)
        assert torch.equal(out, b6) and torch.equal(lse, b6_lse)
    h_k = kp.shape[1]
    b = len(lens_k)
    gen = torch.Generator(device="cuda").manual_seed(3)
    qk_d, v_d = (0.5 + torch.rand(b, h_k, device="cuda", generator=gen)
                 for _ in range(2))
    kq, vq = (quantize_kv(torch.nan_to_num(x), torch.float8_e4m3fn)
              for x in (kp, vp))
    kw.update(qk_descale=qk_d, v_descale=v_d)
    out, lse = fvp.flash_attention_varlen_paged_fwd(q, kq, vq, *args, **kw)
    ref, ref_lse = fvp.flash_attention_varlen_paged_fwd_plain(
        q.float(), kq, vq, *args, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", PAGED_PREFILL_EDGE_CASES[:4])
def test_sink_paged_prefill_matches_plain_version_on_the_card(case):
    """B8p with a learnable sink, each packed row its own head's, against
    its plain version (out within 2e-2, lse within 1e-3), the same bits
    twice, the sink on rows past seqused_q."""
    import numpy as np

    from flash_attn_tpu_torch.kernels import flash_paged_prefill as fpp

    h, h_k, d, dv, page, lens_q, used, cached, causal, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(h + d + page)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                      dtype=torch.int32, device="cuda")
    q, qv = (torch.randn(int(cu[-1]), h, w, device="cuda", generator=gen)
             .to(dtype) for w in (d, dv))
    lens_k = [c + n for c, n in zip(cached, used)]
    (kp, vp), table = _holed_pages(gen, lens_k, h_k, (d, dv), page, dtype)
    seqlens = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    seqused = torch.tensor(used, dtype=torch.int32, device="cuda")
    sink = sink_logits(h, max(lens_k), "cuda", gen)
    args = (q, kp, vp, cu, max(lens_q), seqlens, table)
    kw = dict(seqused_q=seqused, qv=qv, causal=causal, learnable_sink=sink)
    before = fpp.launches_sink
    out, lse = fpp.flash_attention_paged_prefill_varlen(*args, **kw)
    again = fpp.flash_attention_paged_prefill_varlen(*args, **kw)
    assert fpp.launches_sink == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = fpp.flash_attention_paged_prefill_varlen_plain(
        q.float(), *(torch.nan_to_num(x.float()) for x in (kp, vp)),
        *args[3:], seqused_q=seqused,
        qv=qv.float(), causal=causal, learnable_sink=sink)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    for a, n, u in zip(cu.tolist(), lens_q, used):
        assert torch.equal(lse[:, a + u:a + n],
                           sink[:, None].expand(h, n - u))


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", SINK_FWD_CASES[1:4], ids=lambda c: c[0])
def test_sink_gradients_match_plain_version_on_the_card(case):
    """flash_attn_func with a trained sink, both deterministic modes: dq,
    dk, dv and dsink by the 2x rule against the plain fp32 backward's, with
    attention_ref_grads in the inputs' type as the low-precision reference
    (+1e-4; dsink, an fp32 sum over every row, +1e-3); B3 the same bits
    twice; the dense flash_attn_varlen_func over the same rows packed gives
    B3's dq, dk, dv bits and dsink within 1e-5 relative (another summation
    order)."""
    from flash_attn_tpu_torch import flash_attn_varlen_func
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref_grads,
        check_against_ref,
    )

    q, k, v, sink, kw = _sink_fwd_inputs(case, 25)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    gen = torch.Generator(device="cuda").manual_seed(26)
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(q.dtype)
    ref_o, ref_l = flash_fwd.flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), learnable_sink=sink, **kw)
    ref = flash_bwd.flash_attention_bwd_plain(
        do.transpose(1, 2).float(), q.float(), k.float(), v.float(), ref_o,
        ref_l, learnable_sink=sink, **kw)
    del ref_o, ref_l
    ref_lp = attention_ref_grads(*(x.transpose(1, 2) for x in (q, k, v)), do,
                                 upcast=False, learnable_sink=sink, **kw)
    runs = []
    for deterministic in (True, True, False):
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)] + [sink.clone().requires_grad_()]
        out = flash_attn_func(*leaves[:3], learnable_sink=leaves[3],
                              deterministic=deterministic, **kw)
        out.backward(do)
        runs.append([x.grad for x in leaves])
    assert all(torch.equal(a, c) for a, c in zip(runs[0], runs[1]))
    for grads in (runs[0], runs[2]):
        for name, g, r, lp in zip(("dq", "dk", "dv"), grads, ref, ref_lp):
            check_against_ref(g, r.transpose(1, 2), lp, atol=1e-4,
                              msg=f"{case[0]} {name}")
        check_against_ref(grads[3], ref[3], ref_lp[3], atol=1e-3,
                          msg=f"{case[0]} dsink")
    cu_q, cu_k = (torch.arange(b + 1, dtype=torch.int32, device="cuda") * n
                  for n in (sq, sk))
    leaves = [x.transpose(1, 2).reshape(-1, x.shape[1], d).detach()
              .requires_grad_() for x in (q, k, v)] + [
        sink.clone().requires_grad_()]
    out = flash_attn_varlen_func(
        *leaves[:3], cu_q, cu_k, sq, sk, learnable_sink=leaves[3],
        causal=kw["causal"], window_size=kw["window_size"],
        softcap=kw["softcap"], alibi_slopes=kw["alibi_slopes"])
    out.backward(do.reshape(b * sq, h, d))
    for g, want in zip(leaves[:3], runs[0][:3]):
        assert torch.equal(g.grad, want.reshape(g.grad.shape))
    torch.testing.assert_close(leaves[3].grad, runs[0][3], atol=1e-4,
                               rtol=1e-5)


@pytest.mark.usefixtures("cuda_card")
def test_sink_free_outputs_match_a_parent_build_on_the_card():
    """With no sink, B1, B6, B7, B8, B8p, B10 and the MLA decode route give
    the bits of a parent tree's build (tools/fwd_ab.py, paged_ab.py and
    mla_ab.py --digests PARENT .: exit 0 when every digest agrees). The
    parent is an unpacked archive of the commit before the sink, named by
    FA_PARENT_TREE."""
    import os

    parent = os.environ.get("FA_PARENT_TREE")
    if not parent:
        pytest.skip("set FA_PARENT_TREE to an unpacked archive of the parent "
                    "commit to compare the sink-free kernels' bits with it")
    for tool in ("fwd_ab.py", "paged_ab.py", "mla_ab.py"):
        res = subprocess.run(
            [sys.executable, str(REPO / "tools" / tool), "--digests", parent,
             str(REPO)], cwd=REPO, capture_output=True, text=True,
            timeout=900)
        assert res.returncode == 0, (tool, res.stdout[-3000:],
                                     res.stderr[-3000:])


def _dv_inputs(case):
    """Seeded q, k (192 columns), v, dout (128) on the card and the call's
    keywords of a DV_CASES case."""
    name, b, sq, sk, h, h_k, causal, dtype, with_sink = case
    gen = torch.Generator(device="cuda").manual_seed(sq + 3 * sk + h)
    q, k, v, do = (torch.randn(b, s, n, w, device="cuda", generator=gen)
                   .to(dtype) for s, n, w in ((sq, h, 192), (sk, h_k, 192),
                                              (sk, h_k, 128), (sq, h, 128)))
    sink = sink_logits(h, sk, "cuda", gen) if with_sink else None
    return q, k, v, do, dict(causal=causal, softmax_scale=dv_case_scale(name),
                             learnable_sink=sink)


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("case", DV_CASES[1:], ids=lambda c: c[0])
def test_head_dims_192_128_kernels_match_plain_version_on_the_card(case):
    """B1, B3 and B2 at q/k head dim 192 beside v head dim 128
    (csrc/flash_fwd_192.cu, csrc/flash_bwd_192.cu) on a DV_CASES case: out
    and dq, dk, dv (and dsink) by the 2x rule against the plain fp32
    versions with an autograd reference in the inputs' type, lse within
    1e-3 (-inf where a row sees no key), B3 the same bits twice, every
    launch counted as the 192 / 128 form."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        attention_ref_grads,
        check_against_ref,
    )

    q, k, v, do, kw = _dv_inputs(case)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))

    def run():
        out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, **kw)
        return out, lse, [flash_bwd.flash_attention_bwd(
            dot, qt, kt, vt, out, lse, deterministic=det, **kw)
            for det in (True, True, False)]
    (out, lse, (b3, again, b2)), n = _counted(run)
    mod = "flash_attn_tpu_torch.kernels."
    assert {key: n.get(mod + key, 0) for key in (
        "flash_fwd.launches_dv", "flash_bwd.launches_preprocess_dv",
        "flash_bwd.launches_dkdv_dv", "flash_bwd.launches_dq_dv",
        "flash_bwd.launches_fused_dv")} == {
        "flash_fwd.launches_dv": 1, "flash_bwd.launches_preprocess_dv": 3,
        "flash_bwd.launches_dkdv_dv": 2, "flash_bwd.launches_dq_dv": 2,
        "flash_bwd.launches_fused_dv": 1}
    assert all(torch.equal(x, y) for x, y in zip(b3, again))
    f32 = [x.float() for x in (qt, kt, vt)]
    out32, lse32 = flash_fwd.flash_attention_fwd_plain(*f32, **kw)
    ref = flash_bwd.flash_attention_bwd_plain(dot.float(), *f32, out32,
                                              lse32, **kw)
    out_lp, _ = attention_ref(q, k, v, upcast=False, **kw)
    ref_lp = attention_ref_grads(q, k, v, do, upcast=False, **kw)
    check_against_ref(out.transpose(1, 2), out32.transpose(1, 2), out_lp,
                      msg=f"B1 {case[0]}")
    fin = torch.isfinite(lse32)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], lse32[fin], atol=1e-3, rtol=0)
    for label, grads in (("B3", b3), ("B2", b2)):
        for i, name in enumerate("qkv"):
            check_against_ref(grads[i].transpose(1, 2),
                              ref[i].transpose(1, 2), ref_lp[i], atol=1e-4,
                              msg=f"{label} d{name} {case[0]}")
        if kw["learnable_sink"] is not None:
            check_against_ref(grads[3], ref[3], ref_lp[3], atol=1e-3,
                              msg=f"{label} dsink {case[0]}")


@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("form", [
    dict(window_size=(100, 0)), dict(attention_chunk=64),
    dict(window_size=(100, 0), sink_token_length=4), dict(softcap=30.0),
    dict(alibi_slopes="slopes")],
    ids=["window", "chunk", "sink tokens", "softcap", "alibi"])
def test_band_and_score_at_192_128_refused_before_any_launch_on_the_card(
        form):
    """The band and the score map at 192 / 128 (not compiled: each a
    template flag) raise NotImplementedError naming queue A item 7 from
    flash_attn_func and from the backward's wrapper, before any launch; a
    window that reaches every key runs the band-free kernel."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd

    q, k, v, do, _ = _dv_inputs(("form", 1, 256, 256, 2, 2, True,
                                 torch.bfloat16, False))
    if form.get("alibi_slopes") == "slopes":
        form = dict(alibi_slopes=torch.tensor([0.25, 0.5], device="cuda"))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=True)
    before = _counts()
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_attn_func(q, k, v, causal=True, **form)
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse, causal=True,
                                      **form)
    assert _counts() == before
    _, n = _counted(lambda: flash_attn_func(q, k, v, causal=True,
                                            window_size=(255, 0)))
    assert n == {"flash_attn_tpu_torch.kernels.flash_fwd.launches": 1,
                 "flash_attn_tpu_torch.kernels.flash_fwd.launches_dv": 1}


@pytest.mark.usefixtures("cuda_card")
def test_qv_equals_the_concatenated_call_on_the_card():
    """flash_attn_func(q, k, v, qv=qv) at (64, 128) runs B1, B3 and the
    preprocess at 192 / 128 and gives the bits of the explicit call on q ||
    qv, k || v: out, dq, dqv, dk, and dv (the P V side plus the score
    side)."""
    gen = torch.Generator(device="cuda").manual_seed(64)
    q, k = (torch.randn(2, 300, 4, 64, device="cuda", generator=gen)
            .bfloat16() for _ in range(2))
    v, qv, do = (torch.randn(2, 300, 4, 128, device="cuda", generator=gen)
                 .bfloat16() for _ in range(3))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, qv)]

    def call():
        out = flash_attn_func(*leaves[:3], qv=leaves[3], causal=True)
        out.backward(do)
        return out
    out, n = _counted(call)
    mod = "flash_attn_tpu_torch.kernels."
    assert n == {mod + key: 1 for key in (
        "flash_fwd.launches", "flash_fwd.launches_dv",
        "flash_bwd.launches_preprocess", "flash_bwd.launches_preprocess_dv",
        "flash_bwd.launches_dkdv", "flash_bwd.launches_dkdv_dv",
        "flash_bwd.launches_dq", "flash_bwd.launches_dq_dv")}
    qc = torch.cat([q, qv], -1).requires_grad_()
    kc = torch.cat([k, v], -1).requires_grad_()
    vc = v.clone().requires_grad_()
    out2 = flash_attn_func(qc, kc, vc, causal=True)
    out2.backward(do)
    assert torch.equal(out, out2)
    assert torch.equal(leaves[0].grad, qc.grad[..., :64])
    assert torch.equal(leaves[3].grad, qc.grad[..., 64:])
    assert torch.equal(leaves[1].grad, kc.grad[..., :64])
    assert torch.equal(leaves[2].grad, vc.grad + kc.grad[..., 64:])


@pytest.mark.usefixtures("cuda_card")
def test_d_eq_dv_kernels_match_a_parent_build_on_the_card():
    """Beside the 192 / 128 forms, the d = dv kernels keep their bits: B1,
    B6, B7, B8, B8p, B10 and the MLA decode route give a parent tree's
    (tools/fwd_ab.py, paged_ab.py and mla_ab.py --digests PARENT .), and
    B3 and B2 on every BWD_CASES shape too (tools/dense_bwd_ab.py PARENT
    ., which exits 1 when a digest differs). The parent is an unpacked
    archive of the commit before the 192 / 128 forms, named by
    FA_PARENT_TREE."""
    import os

    parent = os.environ.get("FA_PARENT_TREE")
    if not parent:
        pytest.skip("set FA_PARENT_TREE to an unpacked archive of the parent "
                    "commit to compare the d = dv kernels' bits with it")
    for tool, args in (("fwd_ab.py", ["--digests"]),
                       ("paged_ab.py", ["--digests"]),
                       ("mla_ab.py", ["--digests"]), ("dense_bwd_ab.py", [])):
        res = subprocess.run(
            [sys.executable, str(REPO / "tools" / tool), *args, parent,
             str(REPO)], cwd=REPO, capture_output=True, text=True,
            timeout=900)
        assert res.returncode == 0, (tool, res.stdout[-3000:],
                                     res.stderr[-3000:])
