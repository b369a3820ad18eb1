"""Smoke run of the PyTorch + CUDA port (flash_attn_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. builds the CUDA kernels from flash_attn_tpu_torch/csrc with nvcc
   (sm_90a, one process per source, all at once) and prints the build time;
2. holds each kernel against its plain PyTorch version at the shapes of the
   serving, engine and training paths (the repo's 2x rule against an fp32
   reference for out and for dq/dk/dv, an absolute bound for lse and the
   backward's preprocess), checks that the deterministic backward gives the
   same bits twice on every case, and times kernels, plain versions and,
   where one PyTorch call computes the same function, that call
   (scaled_dot_product_attention, a yardstick the port never calls) with
   CUDA events, beside each kernel's bound (the larger of its bytes over
   3.35 TB/s and its flops over 989 TFLOP/s, 67 TFLOP/s for fp32 outside the
   tensor cores); at the training shape it splits each backward path into
   its kernels and the torch ops around them (torch.profiler) and times the
   previous design of the dense backward in the same run (B6's dK/dV + dQ of
   bwd_tile.cuh over the same rows packed as 4 sequences);
3. calls flash_attn_func(...).backward() at the training shape, once with
   deterministic=True and once with False, and checks each run's launch
   counts (1 preprocess, then 1 dK/dV + 1 dQ, or 1 fused) and gradients;
4. serves 8 seeded 512-token prompts with the flagship 913M GPT (random
   weights from a seed, bf16) through serving.generation.decode for 32 new
   tokens, checks that the kernels carried it (launch counts), that the
   logits are finite and that the decode steps agree with one teacher-forced
   forward; then times the first token and the decode rate;
5. trains the same model (random weights from a seed, bf16 weights with
   fp32 masters, bf16 Adam moments, fused CE) at b=4 x 2048 for 10 steps
   with Trainer.fit over an LMDataLoader of a seeded token file, checks
   the launch counts (per step 16 forward, 16 preprocess, 16 dK/dV, 16 dQ),
   a finite and falling loss, and the first step's
   fused-CE loss against torch's cross-entropy over full fp32 logits; then
   prints the step time, tokens/s, TFLOP/s, peak memory and a split of one
   training step's device time (torch.profiler and CUDA events);
6. serves the same model through the continuous-batching InferenceEngine
   over a paged cache at the shape of bench.py's engine trace (64 slots,
   256-token pages, 96 seeded 512-token prompts arriving 8 at a time, 32
   new tokens each, decode blocks of 8), then again with prefix caching (64
   prompts sharing one 256-token page); checks the launch counts per
   admission and decode block, that every request finishes and every page
   returns, and that the engine's tokens agree with a teacher-forced static
   decode of the same prompts; prints tokens/s, TTFT p50/p99 and the device
   idle share of a decode block.

7. holds the four packed-varlen kernels (B6 forward, the persistent B7,
   the B6 dK/dV and dQ backward) against their plain versions on four
   shapes (BERT-large's packing, bench.py's mixed lengths, ragged GQA fp16
   with seqused and a packed tail, GQA at d=64), requires B7's bits to equal
   B6 forward's and the backward to repeat bitwise, and times kernels,
   plain versions and an SDPA yardstick at the first two;
8. runs bench.py's varlen section (bench.py:203-245): 4 x 8192 and 16
   mixed-length causal sequences through flash_attn_varlen_func, the
   backward from B6 residuals, and flash_attn_varlen_func(...).backward(),
   with counted launches, and prints TFLOP/s of useful work;
9. runs BERT-large (bert-large-uncased widths, 24 layers, random bf16
   weights from a seed) on 32 rows padded to 512: a BertForMaskedLM forward
   (24 B7 launches, none of B1), four rows alone through the dense path as
   the oracle, and a BertForPreTraining MLM + NSP step (24 B7, 24 dK/dV, 24
   dQ launches); prints forward and step times, valid tokens/s and peak
   memory;
10. holds the two absorbed-MLA kernels against their plain versions: the
   paged chunked prefill with qv (B8p) on 6 shapes (the serving phase's
   8 x 512-row chunk over 2,048 keys, DeepSeek-V3's widths at 4 x 256,
   ragged chunks over pages of 16 and 256, GQA 8/2 at 64 + 128 in fp16,
   GQA 16/2 at 128 + 128) and the MLA decode route on 6 (qv over a paged
   cache with lengths 1..2080 at 1 and the default splits, the 576/512
   latent view over a linear cache, qv at 64 + 128 over a linear cache in
   fp16, qv at 128 + 128 over pages of 16, b=32 x 8192): every form each
   kernel is compiled for. The serving chunk and two decode shapes are
   timed beside their bounds and an SDPA yardstick over a pre-gathered
   linear cache (q || qv against k || v, the gather untimed);
11. serves DeepSeek-V3's 61-layer absorbed attention stack at full width
   (128 heads, 64-wide rope key + 512-wide latent, one KV head, pages of
   64, seeded bf16 tensors, no weights): 8 sequences of 2048-token prompts
   prefilled in 4 chunks of 512 through kv_cache_update +
   flash_attn_varlen_func(block_table=, qv=), then 32 decode steps through
   flash_attn_with_kvcache(k=, v=, qv=, block_table=); requires 244 B8p
   and 1,952 MLA decode launches and nothing else, finite outputs, and one
   layer's last decode step run again as a 1-token chunk through B8p in
   agreement with it; prints prefill ms per layer-chunk, decode step ms,
   tokens/s, peak memory and a profiler split of one layer-chunk and of
   one decode step;
12. drives block-sparse attention (B10), which no model path calls,
   through its public functions at the 913M GPT's attention widths (16
   heads of 128, bf16): the full causal block mask, a causal local window
   of 4 tiles plus tile 0 (also at b=1 x 8192) and a seeded 50% random mask
   with an empty row (tiles of 128, 128 and 512; b=4 x 2048). Each runs
   flash_attention_blocksparse(...).backward() once as the counted path
   (1 forward, 1 dK/dV, 1 dQ launch), then holds the forward and backward
   kernels to the 2x rule against their plain versions, the backward
   bitwise over two runs, the full causal mask's out and lse bitwise
   against B1 and its gradients against B6's backward over the same rows
   packed as 4 sequences (bitwise, or else the 2x rule, reported), and
   times them beside their bounds and SDPA with the expanded boolean mask;
13. runs the two H100 probes (B13): the dynamic shared memory a block can
   opt into (48 KB to 256 KB, the kernel's output against the plain
   version at each accepted size) and whether an mma.sync chain and an
   exp2 chain overlap in one block (us a step by trip-count slope).

It prints the card's name and power limit, one JSON line with the kernels'
launches, errors and times, and as its last line
{"ok": true, "device": {...}}. It needs a CUDA card and exits non-zero
without one, and when run outside a checkout of the repo.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

FWD_CASES = [  # (b, sq, sk, h, h_k, d, causal); the first is the prefill's
    (8, 512, 512, 16, 16, 128, True),
    (8, 512, 512, 16, 4, 128, True),
    (8, 512, 512, 16, 16, 128, False),
    (8, 256, 512, 16, 16, 128, True),
    (4, 2048, 2048, 16, 16, 128, True),  # the training shape
]
BWD_CASES = [  # (b, sq, sk, h, h_k, d, causal, dtype); the first is the
    # training's
    (4, 2048, 2048, 16, 16, 128, True, torch.bfloat16),
    (2, 1024, 1024, 16, 4, 128, True, torch.bfloat16),
    (2, 1024, 1024, 16, 16, 64, True, torch.bfloat16),
    (2, 1024, 1024, 16, 16, 128, False, torch.bfloat16),
    (2, 1024, 2048, 16, 16, 128, True, torch.bfloat16),
    (2, 1000, 1000, 16, 16, 128, True, torch.bfloat16),
    # sq > sk: the first rows see no key
    (2, 300, 200, 8, 2, 64, True, torch.bfloat16),
    (2, 1024, 1024, 16, 4, 128, True, torch.float16),
    (2, 700, 900, 8, 8, 64, False, torch.float16),
]
# Absolute floor of the 2x rule for gradients (as the JAX package's
# backward tests use): a gradient near zero has a low-precision reference error near
# zero too.
BWD_ATOL = 1e-4
DEC_CASES = [  # (b, h, h_k, d, s_max, num_splits); the first is the decode's
    (8, 16, 16, 128, 640, 1),
    (8, 16, 16, 128, 640, 4),
    (8, 16, 4, 128, 640, 1),
]
PAGED_DEC_CASES = [  # (b, h, h_k, d, page_size, max_len, num_splits); the
    # first is the engine's decode: 64 slots, pages of 256, lengths 1..560
    (64, 16, 16, 128, 256, 560, 1),
    (16, 16, 4, 128, 16, 560, 1),
    (16, 16, 4, 128, 64, 560, 3),
]
VARLEN_CASES = [  # (name, lens_q, lens_k, seqused_q, h, h_k, d, page, dtype,
    # causal); the first is the prefix-cached admission's: 8 chunks of 256
    # query tokens over 512 keys
    ("prefix admission", [256] * 8, [512] * 8, None, 16, 16, 128, 256,
     torch.bfloat16, True),
    ("ragged", [300, 17, 128, 64], [812, 17, 400, 264], None, 16, 16, 128,
     64, torch.bfloat16, True),
    ("zero-length", [0, 50, 0, 200], [10, 50, 0, 700], None, 16, 16, 128,
     256, torch.bfloat16, True),
    ("seqused_q padding", [128] * 4, [384, 77, 0, 517], [128, 77, 0, 5], 16,
     16, 128, 256, torch.bfloat16, True),
    ("GQA 16/4", [256] * 4, [512] * 4, None, 16, 4, 128, 16, torch.bfloat16,
     True),
    ("d=64", [100, 200], [300, 200], None, 8, 8, 64, 64, torch.bfloat16,
     False),
    ("fp16", [256, 256], [600, 256], None, 16, 4, 128, 256, torch.float16,
     True),
]
# lse is fp32 in the kernel and in the plain version, from the same bf16
# inputs; they differ only in summation order (|scores| <~ 20 here).
LSE_ATOL = 1e-3
# The card's published peaks (H100 SXM, dense, at the 700 W limit): what a
# kernel's bound divides by.
PEAK_FLOPS = 989e12   # bf16 / fp16 tensor cores
PEAK_BYTES = 3.35e12  # HBM3
PEAK_FP32 = 67e12     # fp32 outside the tensor cores
# The engine phases: bench.py bench_engine's trace (bench.py:493-541) with
# max_decode_seqlen cut to what 512 + 32 tokens need.
ENGINE_SLOTS, ENGINE_PAGE, ENGINE_MAX_LEN = 64, 256, 560
ENGINE_PROMPT, ENGINE_NEW, ENGINE_REQUESTS, ENGINE_ARRIVAL = 512, 32, 96, 8
ENGINE_BLOCK = 8
PREFIX_REQUESTS, PREFIX_SHARED = 64, 256
# Share of the engine's tokens that must be the argmax of a teacher-forced
# static decode's logits over the same tokens (bf16 through other kernels
# and matmul shapes; teacher forcing keeps one near-tie from cascading,
# while a wrong page, offset or rotary position breaks agreement
# everywhere). Where they differ, the engine's token must be within
# LOGIT_BOUND of the top logit.
MIN_ENGINE_AGREEMENT = 0.95
PROMPT, NEW_TOKENS, BATCH = 512, 32, 8
# Decode step logits against the teacher-forced forward over the same
# tokens: both are bf16 all the way, through different kernels and matmul
# shapes, so they differ by bf16 rounding carried through 16 layers. With
# logits of unit scale and 2^-8 relative rounding per bf16 step, a few
# tenths at the extreme of ~13M logits is that noise; a wrong cache offset
# or rotary position would move logits by their own scale (~1).
LOGIT_BOUND = 0.5
MIN_ARGMAX_AGREEMENT = 0.9
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARM = 4, 2048, 10, 2
# The token file: a seeded 4096-token sequence repeated, so that the loss
# can fall within a few steps (towards ln 4096 = 8.3 by learning which
# tokens occur, lower by learning the sequence).
DATA_PERIOD, DATA_WINDOWS = 4096, 64
# Random weights (flax's scales) give logits of about unit variance, so the
# first loss is ln(vocab) + ~0.5; a broken loss or head is off by far more.
FIRST_LOSS_BAND = 1.0
# Mean loss of the last 3 steps at least this far below the first step's.
MIN_LOSS_DROP = 0.5
# The first step's fused-CE loss against torch's cross-entropy over the
# full fp32 logits of a no-grad forward of the same weights and batch:
# the same bf16 trunk and lm_head matmul, summed in other orders.
CE_LOSS_ATOL = 2e-3

# Packed varlen attention (B6 forward, B7, B6 backward). BERT-large's packing
# in the BERT phase: 32 rows padded to 512, lengths seeded uniform in [256,
# 512]; bench.py's mixed shape (bench.py:225-226): 16 sequences uniform in
# [2048, 4096].
BERT_BATCH, BERT_SEQ, BERT_MASKED = 32, 512, 76  # MLPerf phase 2's
# max_predictions_per_seq
BERT_LENS = [int(x) for x in np.random.default_rng(5).integers(
    256, 513, BERT_BATCH)]
BENCH_MIXED_LENS = [int(x) for x in np.random.default_rng(0).integers(
    2048, 4097, size=16)]
VARLEN_DENSE_CASES = [  # (name, lens_q, lens_k, seqused_q, seqused_k, packed
    # tail rows, h, h_k, d, dtype, causal); the first two are timed
    ("BERT-large packing", BERT_LENS, None, None, None,
     BERT_BATCH * BERT_SEQ - sum(BERT_LENS), 16, 16, 64, torch.bfloat16,
     False),
    ("bench.py mixed", BENCH_MIXED_LENS, None, None, None, 0, 16, 16, 128,
     torch.bfloat16, True),
    ("ragged GQA 16/4 fp16", [300, 0, 17, 128, 513], [812, 40, 17, 0, 600],
     [300, 0, 10, 128, 500], [700, 40, 17, 0, 600], 37, 16, 4, 128,
     torch.float16, True),
    ("GQA 16/4 d=64", [256, 100, 700], None, None, None, 0, 16, 4, 64,
     torch.bfloat16, True),
]
# BERT-large's valid-token hidden states from the packed path (B7) against
# each row run alone without a mask (B1): both bf16, through the same
# attention tiles but matmuls of other shapes (cuBLAS may sum in other
# orders), so they differ by bf16 rounding carried through 24 layers. The
# LayerNorm outputs are of unit scale (|x| up to ~5, where a bf16 step is
# 2^-5); 16 such steps at the extreme, and a mean far below one step, is
# that noise. A wrong sequence origin, mask or tile would move states by
# their own scale.
BERT_HIDDEN_MAX, BERT_HIDDEN_MEAN = 0.5, 0.02

# Absorbed MLA at DeepSeek-V3's attention widths (Hugging Face
# deepseek-ai/DeepSeek-V3 config.json: 61 layers, 128 heads, kv_lora_rank
# 512, qk_rope_head_dim 64, qk_nope_head_dim 128, yarn factor 40 with
# mscale_all_dim 1). Each layer caches a 512-wide latent (V) and a 64-wide
# rope key (K) per token on one KV head; the absorbed q_nope . W_UK is qv.
# The scale is 1/sqrt(128 + 64) times mscale^2, mscale = 0.1 ln 40 + 1.
MLA_LAYERS, MLA_HEADS, MLA_ROPE, MLA_LATENT = 61, 128, 64, 512
MLA_SCALE = (0.1 * math.log(40.0) + 1.0) ** 2 / math.sqrt(128 + 64)
MLA_BATCH, MLA_PROMPT, MLA_CHUNK, MLA_NEW, MLA_PAGE = 8, 2048, 512, 32, 64
MLA_PREFILL_CASES = [  # (name, lens_q, cached keys before the chunk, h, h_k,
    # d, dv, page, dtype, causal); every form of PAGED_PREFILL_DIMS. The
    # first, the timed one, is the serving phase's last and heaviest chunk:
    # 8 x 512 rows over 2,048 keys.
    ("serving chunk", [MLA_CHUNK] * MLA_BATCH,
     [MLA_PROMPT - MLA_CHUNK] * MLA_BATCH, MLA_HEADS, 1, MLA_ROPE,
     MLA_LATENT, MLA_PAGE, torch.bfloat16, True),
    ("DeepSeek widths", [256] * 4, [1024] * 4, 128, 1, 64, 512, 64,
     torch.bfloat16, True),
    ("ragged, pages of 16", [1, 77, 256], [500, 0, 300], 128, 1, 64, 512,
     16, torch.bfloat16, True),
    ("ragged, pages of 256", [1, 77, 256], [500, 0, 300], 128, 1, 64, 512,
     256, torch.bfloat16, True),
    ("GQA 8/2, 64 + 128, fp16", [100, 200], [200, 50], 8, 2, 64, 128, 64,
     torch.float16, False),
    ("GQA 16/2, 128 + 128 (JAX's kv_concat_dim shape)", [64, 130], [100, 0],
     16, 2, 128, 128, 16, torch.bfloat16, True),
]
MLA_DECODE_CASES = [  # (name, b, h, keys, d, dv, qv, page (0: linear),
    # num_splits (0: the default), dtype, the key its timing is kept under
    # (None: not timed)); every form of MLA_DECODE_DIMS. The first is the
    # serving phase's step.
    ("qv, paged, lengths 1..2080, default splits", 8, 128,
     np.linspace(1, 2080, 8).round().astype(int).tolist(), 64, 512, True,
     64, 0, torch.bfloat16, "flash_decode_mla"),
    ("qv, paged, lengths 1..2080, 1 split", 8, 128,
     np.linspace(1, 2080, 8).round().astype(int).tolist(), 64, 512, True,
     64, 1, torch.bfloat16, None),
    ("576/512 latent view, linear cache (s_max 1024)", 2, 128, [1000, 333],
     576, 512, False, 0, 0, torch.bfloat16, None),
    ("qv 64 + 128, linear cache, fp16", 4, 16, [300, 1, 64, 129], 64, 128,
     True, 0, 3, torch.float16, None),
    ("qv 128 + 128, pages of 16", 3, 16, [200, 17, 64], 128, 128, True, 16,
     0, torch.bfloat16, None),
    ("b=32 x 8192", 32, 128, [8192] * 32, 64, 512, True, 64, 0,
     torch.bfloat16, "b=32 x 8192"),
]

# Block-sparse attention (B10), which no model path of the JAX package
# calls: driven through its own public functions at the 913M GPT's
# attention widths (bench.py:334: 16 heads of 128, bf16) and its training
# shape b=4 x 2048. Masks: (a) every tile at or below the diagonal, causal
# (the dense causal band: the oracle against B1 and B3); (b) a causal
# window of 4 tiles plus tile 0 (Longformer/BigBird's local + global
# pattern), also at b=1 x 8192; (c) a seeded 50% random mask per batch
# entry at JAX's default tile of 512, not causal, with one empty row. The
# first (b) case is the one timed into the kernels line.
BS_HEADS, BS_DIM, BS_WINDOW = 16, 128, 4
BS_CASES = [  # (name, b, s, block, mask, causal)
    ("full causal", 4, 2048, 128, "causal", True),
    ("local 4 + global", 4, 2048, 128, "local", True),
    ("local 4 + global, 8192", 1, 8192, 128, "local", True),
    ("random 50%, one empty row", 4, 2048, 512, "random", False),
]
BS_TIMED = "local 4 + global"
# The H100 probes (B13): dynamic shared memory sizes a block asks for, and
# the largest the card should take (227 KB).
SMEM_LIMIT_KB = 227


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS) -> dict:
    """The least time the card could take for work of ``flops`` operations
    (at ``peak_flops``, the tensor cores' bf16 rate unless given) over
    ``nbytes`` of device memory traffic, and which of the two binds."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attended_pairs(lens_q, lens_k, causal: bool) -> int:
    """(query row, key) pairs that attention computes for these lengths,
    bottom-right causal when ``causal``."""
    total = 0
    for lq, lk in zip(lens_q, lens_k):
        if causal:
            total += int(np.clip(np.arange(lq) + lk - lq + 1, 0, lk).sum())
        else:
            total += lq * lk
    return total


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, runs: int = 25, batch: int = 5) -> float:
    """Device time of fn(): the median over `runs` CUDA-event pairs, after
    two warm-ups. A sleep kernel holds the stream while a batch of runs is
    enqueued, so the runs execute back to back and the events time the
    device, not the host's launch overhead. Batches are small because the
    launch queue is finite: a full queue blocks the host until the sleep
    ends, and the device would then wait for the host again. A batch whose
    enqueueing outlasted the sleep (a call heavy on the host, such as
    autograd over nested tensors, on a busy host) is thrown away and taken
    again under a sleep twice as long."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times, sleep_cycles = [], 100_000_000
    while len(times) < runs:
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(batch)]
        torch.cuda._sleep(sleep_cycles)
        for start, end in events:
            start.record()
            fn()
            end.record()
        caught_up = events[0][0].query()
        torch.cuda.synchronize()
        if caught_up:
            require(sleep_cycles < 6_400_000_000,
                    "time_ms: the device caught up with the host while runs "
                    "were enqueued, under a sleep of 6.4e9 cycles")
            sleep_cycles *= 2
            continue
        times += [s.elapsed_time(e) for s, e in events]
    return statistics.median(times)


def check_fwd(gen):
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
    )

    worst, timing = 0.0, None
    for b, sq, sk, h, h_k, d, causal in FWD_CASES:
        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(
                torch.bfloat16)

        # bshd tensors seen as (b, h, s, d) views, as the model passes them
        q, k, v = randn(b, sq, h, d), randn(b, sk, h_k, d), randn(b, sk, h_k, d)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal)
        ref, ref_lse = flash_fwd.flash_attention_fwd_plain(
            qt.float(), kt.float(), vt.float(), causal=causal)
        ref_lp, _ = attention_ref(q, k, v, causal=causal, upcast=False)
        torch.cuda.synchronize()
        err, err_lp = check_against_ref(
            out.transpose(1, 2), ref.transpose(1, 2), ref_lp,
            msg=f"flash_fwd {b, sq, sk, h, h_k, d, causal}")
        lse_err = (lse - ref_lse).abs().max().item()
        require(lse_err <= LSE_ATOL, f"lse error {lse_err}")
        worst = max(worst, err)
        print(f"flash_fwd b={b} sq={sq} sk={sk} h={h} h_k={h_k} d={d} "
              f"causal={causal}: out max abs err {err:.3e} (bf16 reference "
              f"{err_lp:.3e}), lse max abs err {lse_err:.3e}")
        if timing is None:
            ms = time_ms(lambda: flash_fwd.flash_attention_fwd(
                qt, kt, vt, causal=causal))
            plain_ms = time_ms(lambda: flash_fwd.flash_attention_fwd_plain(
                qt, kt, vt, causal=causal))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            pairs = b * attended_pairs([sq], [sk], causal)
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "library_call": "scaled_dot_product_attention(is_causal"
                                      "=True)",
                      **bound(4 * h * d * pairs,
                              2 * (2 * b * sq * h * d + 2 * b * sk * h_k * d)
                              + 4 * b * h * sq)}
            print(f"flash_fwd time at the prefill shape: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
                  f"{lib_ms:.4f} ms (median of 25); bound "
                  f"{timing['bound_ms']:.4f} ms ({timing['bound_by']})")
    return worst, timing


def check_decode(gen):
    from flash_attn_tpu_torch.dispatch.config import DECODE_BLOCK_K
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
    )

    worst, timing = 0.0, None
    for b, h, h_k, d, s_max, splits in DEC_CASES:
        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(
                torch.bfloat16)

        q = randn(b, 1, h, d)
        kc, vc = randn(b, h_k, s_max, d), randn(b, h_k, s_max, d)
        seqlens = torch.linspace(1, 600, b, device="cuda").round().to(torch.int32)
        out, lse = flash_decode.flash_attention_decode(
            q, kc, vc, seqlens, causal=True, num_splits=splits)
        ref, ref_lse = flash_decode.flash_attention_decode(
            q.float().cpu(), kc.float().cpu(), vc.float().cpu(),
            seqlens.cpu(), causal=True, num_splits=splits)
        keep = torch.arange(s_max, device="cuda")[None] < seqlens[:, None]
        ref_lp, _ = attention_ref(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                  key_padding_mask=keep, upcast=False)
        torch.cuda.synchronize()
        err, err_lp = check_against_ref(
            out, ref, ref_lp, msg=f"flash_decode {b, h, h_k, d, s_max, splits}")
        lse_err = (lse.cpu() - ref_lse).abs().max().item()
        require(lse_err <= LSE_ATOL, f"lse error {lse_err}")
        worst = max(worst, err)
        print(f"flash_decode b={b} h={h} h_k={h_k} d={d} s_max={s_max} "
              f"num_splits={splits} seqlens 1..600: out max abs err {err:.3e} "
              f"(bf16 reference {err_lp:.3e}), lse max abs err {lse_err:.3e}")
        if timing is None:
            scale = d ** -0.5
            ms = time_ms(lambda: flash_decode.flash_attention_decode_partials(
                q, kc, vc, seqlens, splits, scale, True))
            plain_ms = time_ms(
                lambda: flash_decode.flash_attention_decode_partials_plain(
                    q, kc, vc, seqlens, splits, DECODE_BLOCK_K, scale, True))
            qh, mask = q.transpose(1, 2), keep[:, None, None, :]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kc, vc, attn_mask=mask))
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "library_call": "scaled_dot_product_attention with a "
                                      "boolean length mask over the linear "
                                      "cache",
                      **decode_bound(seqlens, b, h, h_k, d, splits, 0)}
            print(f"flash_decode time at the decode shape: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
                  f"{lib_ms:.4f} ms (median of 25); bound "
                  f"{timing['bound_ms']:.4f} ms ({timing['bound_by']})")
    return worst, timing


def decode_bound(seqlens, b, h, h_k, d, splits, table_entries):
    """Bound of one decode call (sq = 1, bf16): every cached K and V row
    read once, q read, the fp32 split partials and the lengths (and the
    block table) read or written once."""
    keys = int(seqlens.sum())
    return bound(4 * h * d * keys,
                 2 * 2 * keys * h_k * d + 2 * b * h * d
                 + 4 * splits * b * h * (d + 1) + 4 * (b + table_entries))


def paged_cache(gen, b, h_k, d, page_size, max_len, dtype, dv=None):
    """Random K and V pages (V dv wide, d by default) for b sequences of up
    to max_len positions, in a shuffled block table (page 0, the null page,
    owned by none)."""
    width = -(-max_len // page_size)
    kp, vp = (torch.randn(b * width + 1, h_k, page_size, w, device="cuda",
                          generator=gen).to(dtype) for w in (d, dv or d))
    table = (1 + torch.randperm(b * width, device="cuda", generator=gen)
             ).reshape(b, width).to(torch.int32)
    return kp, vp, table


def check_decode_paged(gen):
    """The paged decode kernel against its plain version at the engine's
    decode shape and at pages of 16 and 64 with GQA 16/4."""
    from flash_attn_tpu_torch.dispatch.config import DECODE_BLOCK_K
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
        paged_to_linear,
    )

    worst, timing = 0.0, None
    for b, h, h_k, d, page, max_len, splits in PAGED_DEC_CASES:
        kp, vp, table = paged_cache(gen, b, h_k, d, page, max_len,
                                    torch.bfloat16)
        q = torch.randn(b, 1, h, d, device="cuda", generator=gen).to(
            torch.bfloat16)
        seqlens = torch.linspace(1, max_len, b, device="cuda").round().to(
            torch.int32)
        out, lse = flash_decode.flash_attention_decode(
            q, kp, vp, seqlens, causal=True, num_splits=splits,
            block_table=table)
        ref, ref_lse = flash_decode.flash_attention_decode(
            q.float().cpu(), kp.float().cpu(), vp.float().cpu(),
            seqlens.cpu(), causal=True, num_splits=splits,
            block_table=table.cpu())
        k_lin, v_lin = (paged_to_linear(x, table, seqlens).transpose(1, 2)
                        for x in (kp, vp))
        keep = torch.arange(k_lin.shape[1], device="cuda")[None] \
            < seqlens[:, None]
        ref_lp, _ = attention_ref(q, k_lin, v_lin, key_padding_mask=keep,
                                  upcast=False)
        torch.cuda.synchronize()
        case = (f"b={b} h={h} h_k={h_k} d={d} page={page} lengths "
                f"1..{max_len} num_splits={splits}")
        err, err_lp = check_against_ref(out, ref, ref_lp,
                                        msg=f"flash_decode_paged {case}")
        lse_err = (lse.cpu() - ref_lse).abs().max().item()
        require(lse_err <= LSE_ATOL, f"paged decode lse error {lse_err}")
        worst = max(worst, err)
        print(f"flash_decode_paged {case}: out max abs err {err:.3e} (bf16 "
              f"reference {err_lp:.3e}), lse max abs err {lse_err:.3e}")
        if timing is None:
            scale = d ** -0.5
            ms = time_ms(lambda: flash_decode.flash_attention_decode_partials(
                q, kp, vp, seqlens, splits, scale, True, block_table=table))
            plain_ms = time_ms(
                lambda: flash_decode.flash_attention_decode_paged_partials_plain(
                    q, kp, vp, seqlens, table, splits, DECODE_BLOCK_K, scale,
                    True))
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      "library_call": "none: no single PyTorch call reads K/V "
                                      "through a block table (a gather first)",
                      **decode_bound(seqlens, b, h, h_k, d, splits,
                                     table.numel())}
            print(f"flash_decode_paged time at the engine's decode shape: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of "
                  f"25); bound {timing['bound_ms']:.4f} ms "
                  f"({timing['bound_by']})")
    return worst, timing


def check_varlen_paged(gen):
    """The packed-varlen prefill kernel over the paged cache against its
    plain version on the cases of VARLEN_CASES."""
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.utils.testing import (
        attention_varlen_paged_ref,
        check_against_ref,
    )

    worst, timing = 0.0, None
    for name, lens_q, lens_k, used, h, h_k, d, page, dtype, causal in \
            VARLEN_CASES:
        b = len(lens_q)
        cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                          dtype=torch.int32, device="cuda")
        q = torch.randn(int(cu[-1]), h, d, device="cuda", generator=gen).to(
            dtype)
        kp, vp, table = paged_cache(gen, b, h_k, d, page, max(max(lens_k), 1),
                                    dtype)
        seqlens_k = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
        seqused = (None if used is None else
                   torch.tensor(used, dtype=torch.int32, device="cuda"))
        max_q = max(max(lens_q), 1)
        args = (cu, max_q, seqlens_k, table)
        out, lse = fvp.flash_attention_varlen_paged_fwd(
            q, kp, vp, *args, seqused_q=seqused, causal=causal)
        ref, ref_lse = fvp.flash_attention_varlen_paged_fwd_plain(
            q.float(), kp.float(), vp.float(), *args, seqused_q=seqused,
            causal=causal)
        ref_lp = attention_varlen_paged_ref(
            q, kp, vp, cu, seqlens_k, table, seqused_q=seqused,
            causal=causal, upcast=False)
        torch.cuda.synchronize()
        case = (f"{name}: lens_q {lens_q} lens_k {lens_k} seqused_q {used} "
                f"h={h} h_k={h_k} d={d} page={page} {str(dtype)[6:]} "
                f"causal={causal}")
        err, err_lp = check_against_ref(out, ref, ref_lp,
                                        msg=f"flash_varlen_paged {case}")
        fin = torch.isfinite(ref_lse)
        require(torch.equal(torch.isfinite(lse), fin),
                f"flash_varlen_paged {case}: rows without keys differ")
        lse_err = (lse[fin] - ref_lse[fin]).abs().max().item() \
            if fin.any() else 0.0
        require(lse_err <= LSE_ATOL, f"varlen paged lse error {lse_err}")
        worst = max(worst, err)
        print(f"flash_varlen_paged {case}: out max abs err {err:.3e} "
              f"(low-precision reference {err_lp:.3e}), lse max abs err "
              f"{lse_err:.3e}")
        if timing is None:
            ms = time_ms(lambda: fvp.flash_attention_varlen_paged_fwd(
                q, kp, vp, *args, seqused_q=seqused, causal=causal))
            plain_ms = time_ms(lambda: fvp.flash_attention_varlen_paged_fwd_plain(
                q, kp, vp, *args, seqused_q=seqused, causal=causal))
            total_q = int(cu[-1])
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      "library_call": "none: no single PyTorch call reads K/V "
                                      "through a block table (a gather first)",
                      **bound(4 * h * d * attended_pairs(
                          used or lens_q, lens_k, causal),
                          2 * 2 * total_q * h * d
                          + 2 * 2 * sum(lens_k) * h_k * d + 4 * h * total_q)}
            print(f"flash_varlen_paged time at the prefix-admission shape: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of "
                  f"25); bound {timing['bound_ms']:.4f} ms "
                  f"({timing['bound_by']})")
    return worst, timing


def check_bwd(gen):
    """Both backward paths against the plain fp32 backward on every case
    (the 2x rule, with autograd through attention_ref in the inputs' type
    as the low-precision reference), and the preprocess kernel against its
    plain version; deterministic grads bitwise equal over two runs. At the
    training shape: kernel, plain and library times beside the bounds, a
    profiler split of each path into its kernels and the torch ops around
    them, and the previous design in the same run (B6's dK/dV + dQ of
    bwd_tile.cuh over the same rows packed as b sequences, its two kernels'
    device time)."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd, flash_varlen
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref_grads,
        check_against_ref,
    )

    worst = {"flash_bwd": 0.0, "flash_bwd_fused": 0.0,
             "flash_bwd_preprocess": 0.0}
    timing = None
    for b, sq, sk, h, h_k, d, causal, dtype in BWD_CASES:
        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

        q, k, v = randn(b, sq, h, d), randn(b, sk, h_k, d), randn(b, sk, h_k, d)
        dout = randn(b, sq, h, d)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, dout))
        out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal)
        f32 = [x.float() for x in (qt, kt, vt)]
        out32, lse32 = flash_fwd.flash_attention_fwd_plain(*f32, causal=causal)
        ref = flash_bwd.flash_attention_bwd_plain(dot.float(), *f32, out32,
                                                  lse32, causal=causal)
        ref_lp = attention_ref_grads(q, k, v, dout, causal=causal,
                                     upcast=False)
        case = (f"b={b} sq={sq} sk={sk} h={h} h_k={h_k} d={d} "
                f"causal={causal} {str(dtype)[6:]}")
        for name, det in (("flash_bwd", True), ("flash_bwd_fused", False)):
            grads = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                                  causal=causal,
                                                  deterministic=det)
            torch.cuda.synchronize()
            errs = []
            for gname, got, r, lp in zip("qkv", grads, ref, ref_lp):
                err, err_lp = check_against_ref(
                    got.transpose(1, 2), r.transpose(1, 2), lp, atol=BWD_ATOL,
                    msg=f"{name} d{gname} {case}")
                errs.append(f"d{gname} {err:.3e} (low-precision reference "
                            f"{err_lp:.3e})")
                worst[name] = max(worst[name], err)
            print(f"{name} {case}: max abs err {', '.join(errs)}")
            if det:
                again = flash_bwd.flash_attention_bwd(
                    dot, qt, kt, vt, out, lse, causal=causal)
                same = all(torch.equal(a, b_) for a, b_ in zip(grads, again))
                require(same, f"deterministic backward differs between runs: "
                              f"{case}")
        delta, lse2 = flash_bwd.bwd_preprocess(dot, out, lse)
        want_delta, want_lse2 = flash_bwd.bwd_preprocess_plain(
            dot, out, lse, delta.shape[-1])
        fin = torch.isfinite(want_lse2)
        require(torch.equal(torch.isfinite(lse2), fin)
                and float((lse2[fin] - want_lse2[fin]).abs().max()) <= 1e-5,
                f"preprocess lse2: {case}")
        err = float((delta - want_delta).abs().max())
        require(err <= 1e-3, f"preprocess delta err {err}: {case}")
        worst["flash_bwd_preprocess"] = max(worst["flash_bwd_preprocess"], err)
        print(f"{case}: deterministic backward bitwise equal over two runs; "
              f"preprocess delta max abs err {err:.3e}, lse2 within 1e-5")
        if timing is None:
            timing = time_bwd(qt, kt, vt, dot, out, lse, causal, case)
        del grads, again, ref, ref_lp, f32, out32, lse32
    return worst, timing


def time_bwd(qt, kt, vt, dot, out, lse, causal, case):
    """Times at the training shape: the preprocess, B3 and B2 beside their
    bounds, plain versions and one library call each; a profiler split of
    each path; the previous design (B6's two bwd_tile.cuh kernels over the
    same rows packed as b sequences) by its kernels' device time."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_varlen

    b, h, sq, d = qt.shape
    h_k, sk = kt.shape[1], kt.shape[2]

    def bwd(det):
        return lambda: flash_bwd.flash_attention_bwd(
            dot, qt, kt, vt, out, lse, causal=causal, deterministic=det)
    ms = time_ms(bwd(True), runs=10)
    fused_ms = time_ms(bwd(False), runs=10)
    plain_ms = time_ms(lambda: flash_bwd.flash_attention_bwd_plain(
        dot, qt, kt, vt, out, lse, causal=causal), runs=10)
    pre_ms = time_ms(lambda: flash_bwd.bwd_preprocess(dot, out, lse), runs=10)
    pre_plain_ms = time_ms(lambda: flash_bwd.bwd_preprocess_plain(
        dot, out, lse, 128), runs=10)
    pre_lib_ms = time_ms(lambda: torch.linalg.vecdot(dot, out), runs=10)
    # the yardstick: the backward of scaled_dot_product_attention, its
    # forward (and graph) made outside the timed window
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, dot, retain_graph=True), runs=10)
    del sdpa_out, leaves
    split = {"flash_bwd": kernel_split_ms(
                 bwd(True), ["preprocess_kernel", "dkdv_kernel", "dq_kernel"]),
             "flash_bwd_fused": kernel_split_ms(
                 bwd(False), ["preprocess_kernel", "dkdv_kernel"])}
    # the previous design: the same rows as b packed sequences through
    # B6's backward, which walks bwd_tile.cuh's dense band
    cu_q, cu_k = (torch.arange(b + 1, dtype=torch.int32, device="cuda") * n
                  for n in (sq, sk))
    packed = [x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
              for x in (dot, qt, kt, vt, out)]
    lse_p = lse.permute(1, 0, 2).reshape(h, b * sq)
    old = kernel_split_ms(lambda: flash_varlen.flash_attention_varlen_bwd(
        *packed, lse_p, cu_q, cu_k, sq, sk, causal=causal),
        ["varlen_dkdv_kernel", "varlen_dq_kernel"])
    old_ms = old["varlen_dkdv_kernel"] + old["varlen_dq_kernel"]
    # 5 products (S, dV, dP, dQ, dK) over the attended pairs; q, k, v,
    # out, dout read and dq, dk, dv written once, lse read
    common = {"plain_ms": plain_ms, "library_ms": lib_ms,
              "library_call": "scaled_dot_product_attention(is_causal"
                              "=True) backward (torch.autograd.grad)",
              "previous_design_ms": old_ms,
              "previous_design": "fa_varlen_bwd_dkdv + fa_varlen_bwd_dq "
                                 "(bwd_tile.cuh) over the same rows packed, "
                                 "profiler device time",
              **bound(10 * b * h * d * attended_pairs([sq], [sk], causal),
                      2 * (4 * b * sq * h * d + 4 * b * sk * h_k * d)
                      + 4 * b * h * sq)}
    timing = {"flash_bwd": {"ms": ms, **common},
              "flash_bwd_fused": {"ms": fused_ms, **common}}
    for name in timing:
        t = timing[name]
        t["kernel_split_ms"] = split[name]
        t["kernels_device_ms"] = sum(v for n, v in split[name].items()
                                     if n != "other")
        t["to_previous_design"] = t["kernels_device_ms"] / old_ms
        t["to_library"] = t["ms"] / lib_ms
        t["to_bound"] = t["bound_ms"] / t["ms"]
    # dO and O read once in bf16, lse read, delta and lse2 written in fp32;
    # a multiply-add a head-dim element at the fp32 rate
    sq_pad = -(-sq // 128) * 128
    timing["flash_bwd_preprocess"] = {
        "ms": pre_ms, "plain_ms": pre_plain_ms, "library_ms": pre_lib_ms,
        "library_call": "torch.linalg.vecdot(dO, O) (in bf16)",
        **bound(2 * b * h * sq * d, 2 * 2 * b * h * sq * d + 4 * b * h * sq
                + 2 * 4 * b * h * sq_pad, PEAK_FP32)}
    for name in ("flash_bwd", "flash_bwd_fused"):
        t = timing[name]
        print(f"{name} at the training shape ({case}): {t['ms']:.4f} ms "
              f"(median of 10), {t['to_library']:.2f}x the "
              f"scaled_dot_product_attention backward ({lib_ms:.4f} ms), "
              f"{100 * t['to_bound']:.1f}% of the bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}); plain "
              f"{plain_ms:.4f} ms; profiler split (ms a call) "
              + ", ".join(f"{n} {v:.4f}" for n, v in t["kernel_split_ms"]
                          .items())
              + f"; its kernels {t['kernels_device_ms']:.4f} ms against the "
              f"previous design's {old_ms:.4f} ms ({old}): "
              f"{t['to_previous_design']:.3f}x")
    tp = timing["flash_bwd_preprocess"]
    print(f"flash_bwd_preprocess at the training shape: {pre_ms:.4f} ms, "
          f"bound {tp['bound_ms']:.4f} ms ({tp['bound_by']}), plain "
          f"{pre_plain_ms:.4f} ms, torch.linalg.vecdot {pre_lib_ms:.4f} ms")
    return timing


def run_api_backward(gen):
    """The training slice's public attention entry point at the training
    shape: flash_attn_func(...).backward() with deterministic True (the
    trainer's path) and False (the fused kernel, which no model path
    selects), each with the counts set to 0 just before and read just
    after; the gradients held to the 2x rule against the plain fp32
    backward. Returns the launch counts of the two runs."""
    from flash_attn_tpu_torch import flash_attn_func
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref_grads,
        check_against_ref,
    )

    b, sq, sk, h, h_k, d, causal, dtype = BWD_CASES[0]
    q, k, v, dout = (torch.randn(b, s, n, d, device="cuda", generator=gen)
                     .to(dtype) for s, n in ((sq, h), (sk, h_k), (sk, h_k),
                                             (sq, h)))
    f32 = [x.transpose(1, 2).float() for x in (q, k, v)]
    out32, lse32 = flash_fwd.flash_attention_fwd_plain(*f32, causal=causal)
    ref = [g.transpose(1, 2) for g in flash_bwd.flash_attention_bwd_plain(
        dout.transpose(1, 2).float(), *f32, out32, lse32, causal=causal)]
    del f32, out32, lse32
    ref_lp = attention_ref_grads(q, k, v, dout, causal=causal, upcast=False)
    launches = {}
    for det in (True, False):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        torch.cuda.synchronize()
        flash_fwd.launches = flash_bwd.launches_preprocess = 0
        flash_bwd.launches_dkdv = flash_bwd.launches_dq = 0
        flash_bwd.launches_fused = 0
        flash_attn_func(*leaves, causal=causal,
                        deterministic=det).backward(dout)
        torch.cuda.synchronize()
        got = {"flash_fwd": flash_fwd.launches,
               "flash_bwd_preprocess": flash_bwd.launches_preprocess,
               "fa_bwd_dkdv": flash_bwd.launches_dkdv,
               "fa_bwd_dq": flash_bwd.launches_dq,
               "flash_bwd_fused": flash_bwd.launches_fused}
        want = {"flash_fwd": 1, "flash_bwd_preprocess": 1,
                "fa_bwd_dkdv": int(det), "fa_bwd_dq": int(det),
                "flash_bwd_fused": int(not det)}
        require(got == want, f"flash_attn_func backward (deterministic={det}) "
                             f"launch counts {got}")
        launches[det] = got
        errs = []
        for name, leaf, r, lp in zip("qkv", leaves, ref, ref_lp):
            err, _ = check_against_ref(
                leaf.grad, r, lp, atol=BWD_ATOL,
                msg=f"flash_attn_func d{name} deterministic={det}")
            errs.append(f"d{name} {err:.3e}")
        print(f"flash_attn_func(deterministic={det}).backward() b={b} sq={sq} "
              f"h={h} d={d} causal={causal}: launches {got}; max abs err "
              f"{', '.join(errs)}")
    return launches


def run_slice(gen):
    from flash_attn_tpu_torch.kernels import flash_decode, flash_fwd
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel, gpt_913m
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    cfg = gpt_913m(max_decode_seqlen=PROMPT + NEW_TOKENS + 8)
    model = GPTLMHeadModel(cfg, device="cuda")
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(1))
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda",
                        generator=gen)
    gen_cfg = GenerationConfig(max_length=PROMPT + NEW_TOKENS)
    torch.cuda.synchronize()

    flash_fwd.launches = 0
    flash_decode.launches = 0
    seqs, length, scores = decode(ids, model, gen_cfg, output_scores=True)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.launches,
                "flash_decode": flash_decode.launches}
    steps = NEW_TOKENS - 1
    print(f"slice: {n_params / 1e6:.1f}M parameters, {cfg.n_layer} layers; "
          f"served {BATCH} x {PROMPT}-token prompts to length {length}; "
          f"launches {launches}")
    require(launches == {"flash_fwd": cfg.n_layer,
                         "flash_decode": cfg.n_layer * steps},
            f"launch counts {launches}")
    require(length == PROMPT + NEW_TOKENS and seqs.shape == (BATCH, length)
            and torch.equal(seqs[:, :PROMPT], ids), "sequences")
    require(bool(torch.isfinite(scores).all()), "non-finite decode logits")

    with torch.inference_mode():
        tf = model(seqs[:, :-1])  # teacher-forced forward, same kernels
    tf = tf[:, PROMPT - 1:].transpose(0, 1)  # (NEW_TOKENS, b, vocab)
    require(bool(torch.isfinite(tf).all()), "non-finite forward logits")
    diff = (tf - scores).abs().max().item()
    agree = (tf.argmax(-1) == seqs[:, PROMPT:].T).float().mean().item()
    print(f"decode vs teacher-forced logits: max abs diff {diff:.4f} "
          f"(bound {LOGIT_BOUND}), argmax agreement {agree:.4f} "
          f"(logit std {scores.std().item():.3f})")
    require(diff <= LOGIT_BOUND and agree >= MIN_ARGMAX_AGREEMENT,
            "decode steps disagree with the teacher-forced forward")
    del tf, scores

    def served(max_length):
        def fn():
            out = decode(ids, model, GenerationConfig(max_length=max_length))
            torch.cuda.synchronize()
            return out
        return fn

    prefill_only = served(PROMPT + 1)   # the prefill token, no decode step
    full = served(PROMPT + NEW_TOKENS)
    ttft = wall_ms(prefill_only, 5) / 1e3
    t_full = wall_ms(full, 3) / 1e3
    tok_s = BATCH * steps / (t_full - ttft)
    return launches, ttft, tok_s


def engine_model():
    """The 913M GPT over the engine's page pool (64 slots x 3 pages of 256
    + the null page), random weights from a seed, bf16."""
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel, gpt_913m

    width = -(-ENGINE_MAX_LEN // ENGINE_PAGE)
    cfg = dataclasses.replace(
        gpt_913m(max_decode_seqlen=ENGINE_MAX_LEN),
        paged_kv_num_pages=ENGINE_SLOTS * width + 1,
        paged_kv_page_size=ENGINE_PAGE)
    model = GPTLMHeadModel(cfg, device="cuda")
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(2))
    model.requires_grad_(False)
    return model


def kernel_counts():
    """Launches of the forward, decode, paged, varlen, MLA and block-sparse
    kernels since the last reset_kernel_counts()."""
    from flash_attn_tpu_torch.kernels import (
        flash_blocksparse,
        flash_decode,
        flash_fwd,
        flash_paged_prefill,
        flash_varlen,
        flash_varlen_paged,
        flash_varlen_persistent,
    )

    return {"flash_fwd": flash_fwd.launches,
            "flash_decode": flash_decode.launches,
            "flash_decode_paged": flash_decode.launches_paged,
            "flash_decode_mla": flash_decode.launches_mla,
            "flash_paged_prefill": flash_paged_prefill.launches,
            "flash_varlen_paged": flash_varlen_paged.launches,
            "flash_varlen_fwd": flash_varlen.launches_fwd,
            "flash_varlen_fwd_persistent": flash_varlen_persistent.launches,
            "fa_varlen_bwd_dkdv": flash_varlen.launches_dkdv,
            "fa_varlen_bwd_dq": flash_varlen.launches_dq,
            "flash_blocksparse_fwd": flash_blocksparse.launches_fwd,
            "fa_blocksparse_bwd_dkdv": flash_blocksparse.launches_dkdv,
            "fa_blocksparse_bwd_dq": flash_blocksparse.launches_dq}


def reset_kernel_counts():
    from flash_attn_tpu_torch.kernels import (
        flash_blocksparse,
        flash_decode,
        flash_fwd,
        flash_paged_prefill,
        flash_varlen,
        flash_varlen_paged,
        flash_varlen_persistent,
    )

    flash_decode.launches_mla = flash_paged_prefill.launches = 0
    flash_fwd.launches = flash_decode.launches = 0
    flash_decode.launches_paged = flash_varlen_paged.launches = 0
    flash_varlen_persistent.launches = flash_varlen.launches_fwd = 0
    flash_varlen.launches_dkdv = flash_varlen.launches_dq = 0
    flash_blocksparse.launches_fwd = flash_blocksparse.launches_dkdv = 0
    flash_blocksparse.launches_dq = 0


def want_counts(**nonzero):
    """kernel_counts() as a run should leave them: ``nonzero`` and 0 for
    every other kernel."""
    return {**dict.fromkeys(kernel_counts(), 0), **nonzero}


def run_engine(model, prompts, prefix_cache: bool, card: str):
    """Serve ``prompts`` through an InferenceEngine over the paged cache,
    submitted ENGINE_ARRIVAL at a time whenever the queue is empty (the
    closed-loop trace of bench.py:516-541). The kernel counts are set to 0
    just before the trace and read just after; returns them with the
    generated tokens and the measurements."""
    from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
    from flash_attn_tpu_torch.serving.generation import GenerationConfig

    cfg = model.config
    width = -(-ENGINE_MAX_LEN // ENGINE_PAGE)
    pool = PagePool(cfg.paged_kv_num_pages, ENGINE_PAGE, width, ENGINE_SLOTS)
    eng = InferenceEngine(model, ENGINE_SLOTS, GenerationConfig(top_k=1),
                          page_pool=pool,
                          max_admit_tokens=ENGINE_ARRIVAL * ENGINE_PROMPT,
                          decode_block_size=ENGINE_BLOCK,
                          prefix_cache=prefix_cache)
    t0 = time.perf_counter()
    if not prefix_cache:
        eng.warmup(prefill_shapes=[(ENGINE_ARRIVAL, ENGINE_PROMPT)])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    calls = {"prefill": 0, "decode_block": 0}

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    eng._prefill = counted("prefill", eng._prefill)
    eng._decode_block_fn = counted("decode_block", eng._decode_block_fn)

    submit_t, first_t, ids = {}, {}, []
    total_tokens, nxt = 0, 0
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    while True:
        if nxt < len(prompts) and not eng.queue:
            for p in prompts[nxt:nxt + ENGINE_ARRIVAL]:
                rid = eng.submit(p, max_new_tokens=ENGINE_NEW)
                submit_t[rid] = time.perf_counter()
                ids.append(rid)
            nxt += ENGINE_ARRIVAL
        if nxt >= len(prompts) and not eng.queue and eng._pending is None \
                and all(r is None for r in eng.slots):
            break
        emitted = eng.step()
        now = time.perf_counter()
        total_tokens += len(emitted)
        for rid, _tok in emitted:
            first_t.setdefault(rid, now)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = kernel_counts()
    # back to the class's methods: the counting closures would hold the
    # engine (and the model) in a reference cycle past close()
    del eng._prefill, eng._decode_block_fn
    tokens = [eng.requests[r].generated for r in ids]
    ttfts = sorted(first_t[r] - submit_t[r] for r in ids)
    name = "prefix-cache engine" if prefix_cache else "paged engine"
    print(f"{name}: {len(prompts)} requests, {calls['prefill']} admission "
          f"prefills, {calls['decode_block']} decode blocks of "
          f"{ENGINE_BLOCK}; launches {launches}; stats {eng.stats()}")
    n = cfg.n_layer
    want = want_counts(
        flash_fwd=0 if prefix_cache else n * calls["prefill"],
        flash_decode_paged=n * ENGINE_BLOCK * calls["decode_block"],
        flash_varlen_paged=n * calls["prefill"] if prefix_cache else 0)
    require(launches == want, f"{name} launch counts {launches}, want {want}")
    require(all(len(t) == ENGINE_NEW for t in tokens),
            f"{name}: a request did not finish with {ENGINE_NEW} tokens")
    require(len(pool.free) + len(pool.retained)
            == cfg.paged_kv_num_pages - 1 and not pool.rc,
            f"{name}: pages did not return to the pool")
    if prefix_cache:
        require(eng.prefix_hit_pages >= len(prompts) - ENGINE_ARRIVAL,
                f"prefix hits {eng.prefix_hit_pages}")
    else:
        require(len(pool.free) == cfg.paged_kv_num_pages - 1,
                f"{name}: free pages {len(pool.free)}")
    result = {"tokens_per_s": total_tokens / elapsed,
              "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
              "ttft_p99_ms": ttfts[int(len(ttfts) * 0.99)] * 1e3,
              "trace_s": elapsed, "warmup_s": warm_s}
    print(f"{name}: {total_tokens} tokens in {elapsed:.3f} s, "
          f"{result['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{result['ttft_p50_ms']:.1f} ms p99 {result['ttft_p99_ms']:.1f} ms "
          f"(warm-up {warm_s:.1f} s) on {card}")
    if not prefix_cache:
        result.update(decode_block_idle(eng, prompts, card))
    eng.close()
    return launches, tokens, result


def decode_block_idle(eng, prompts, card):
    """Wall time and device time of one decode block with all slots busy
    (contexts of 512 + a few tokens): the device's idle share of a block."""
    from torch.profiler import ProfilerActivity, profile

    eng.reset()
    eng.max_admit_tokens = None  # one admission of every slot
    for p in prompts[:ENGINE_SLOTS]:
        eng.submit(p, max_new_tokens=ENGINE_NEW)
    eng.step()
    require(all(r is not None for r in eng.slots), "slots left idle")
    toks = eng._upload(eng.slot_tok).long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._decode_block_fn(toks)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._decode_block_fn(toks)
        torch.cuda.synchronize()
    dev_ms = sum(evt.device_time_total for evt in prof.key_averages()
                 if evt.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    attn_ms = sum(evt.device_time_total for evt in prof.key_averages()
                  if evt.device_type == torch.autograd.DeviceType.CUDA
                  and "decode_kernel" in evt.key) / 1e3
    idle = 1.0 - dev_ms / wall_ms
    print(f"decode block of {ENGINE_BLOCK} steps at {ENGINE_SLOTS} busy slots: "
          f"wall {wall_ms:.2f} ms, device {dev_ms:.2f} ms (paged decode "
          f"kernel {attn_ms:.2f} ms), device idle share {idle:.3f} on {card}")
    return {"block_wall_ms": wall_ms, "block_device_ms": dev_ms,
            "block_attention_ms": attn_ms, "block_idle_share": idle}


def engine_agreement(model, prompts, tokens, name):
    """Hold the engine's tokens against a teacher-forced static decode of
    the same prompts on the linear cache, in batches of 8: each token the
    argmax of the static decode's logits at >= MIN_ENGINE_AGREEMENT of the
    positions, and within LOGIT_BOUND of the top logit everywhere."""
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    lin = GPTLMHeadModel(dataclasses.replace(model.config,
                                             paged_kv_num_pages=0),
                         device="cuda")
    lin.load_state_dict(model.state_dict(), assign=True)
    agree = total = 0
    gap = 0.0
    for i in range(0, len(prompts), BATCH):
        ids = torch.as_tensor(np.stack(prompts[i:i + BATCH]), device="cuda",
                              dtype=torch.long)
        gen = torch.as_tensor(tokens[i:i + BATCH], device="cuda",
                              dtype=torch.long)
        seqs = torch.cat([ids, gen], 1)
        _, _, scores = decode(ids, lin, GenerationConfig(
            max_length=seqs.shape[1]), output_scores=True,
            teacher_outputs=seqs)                # (new tokens, b, vocab)
        require(bool(torch.isfinite(scores).all()),
                f"{name}: non-finite teacher-forced logits")
        want = gen.T
        agree += int((scores.argmax(-1) == want).sum())
        total += want.numel()
        tok_logit = scores.gather(-1, want[..., None])[..., 0]
        gap = max(gap, float((scores.max(-1).values - tok_logit).max()))
    share = agree / total
    print(f"{name} vs teacher-forced static decode: argmax agreement "
          f"{share:.4f} over {total} tokens (bound {MIN_ENGINE_AGREEMENT}); "
          f"largest top-logit gap of an engine token {gap:.4f} (bound "
          f"{LOGIT_BOUND})")
    require(share >= MIN_ENGINE_AGREEMENT and gap <= LOGIT_BOUND,
            f"{name}: tokens disagree with the teacher-forced decode")
    return share, gap


def run_engines(card):
    """The paged engine on bench.py's trace, then the prefix-cached engine
    over shared-prefix prompts; returns the launch counts of each run and
    their measurements."""
    model = engine_model()
    vocab = model.config.vocab_size
    rng = np.random.default_rng(0)
    prompts = list(rng.integers(0, vocab, (ENGINE_REQUESTS, ENGINE_PROMPT),
                                dtype=np.int64))
    t0 = time.perf_counter()
    launches, tokens, paged = run_engine(model, prompts, False, card)
    paged["agreement"], paged["logit_gap"] = engine_agreement(
        model, prompts, tokens, "paged engine")
    print(f"paged engine phase wall time {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    shared = rng.integers(0, vocab, PREFIX_SHARED, dtype=np.int64)
    px_prompts = [np.concatenate([shared, rng.integers(
        0, vocab, ENGINE_PROMPT - PREFIX_SHARED, dtype=np.int64)])
        for _ in range(PREFIX_REQUESTS)]
    t0 = time.perf_counter()
    px_launches, px_tokens, prefix = run_engine(model, px_prompts, True, card)
    prefix["agreement"], prefix["logit_gap"] = engine_agreement(
        model, px_prompts, px_tokens, "prefix-cache engine")
    print(f"prefix-cache engine phase wall time {time.perf_counter() - t0:.1f}"
          f" s")
    del model
    torch.cuda.empty_cache()
    return launches, paged, px_launches, prefix


def write_token_file(path: str, vocab: int) -> None:
    import numpy as np

    period = np.random.default_rng(1).integers(0, vocab, DATA_PERIOD,
                                               dtype=np.uint16)
    n = DATA_WINDOWS * TRAIN_SEQ + 1
    np.resize(period, n).tofile(path)


def make_trainer(**overrides):
    from flash_attn_tpu_torch.models.gpt import gpt_913m
    from flash_attn_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = TrainConfig(
        model=gpt_913m(), batch_size=TRAIN_BATCH, seqlen=TRAIN_SEQ, lr=1e-3,
        warmup_steps=TRAIN_WARM, total_steps=100, opt_state_dtype="bfloat16",
        zero1=False, fused_ce=True, log_every=1, **overrides)
    return Trainer(cfg, device="cuda")


def make_loader(path: str):
    from flash_attn_tpu_torch.training.data import (
        FaultTolerantSampler,
        LMDataLoader,
        TokenDataset,
    )

    ds = TokenDataset(path, seqlen=TRAIN_SEQ)
    return LMDataLoader(ds, TRAIN_BATCH, FaultTolerantSampler(len(ds), seed=0))


def run_training():
    """Trainer.fit of the 913M GPT at the repo's training shape; returns
    the launch counts of the run and its measurements."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.training.trainer import model_flops_per_token

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens.bin")
        trainer = make_trainer()
        mcfg = trainer.cfg.model
        write_token_file(path, mcfg.vocab_size)
        n_params = sum(p.numel() for p in trainer.model.parameters())

        # The first batch of the run, through torch's cross-entropy over the
        # full fp32 logits of a no-grad forward.
        inp, lab = next(iter(make_loader(path)))
        with torch.no_grad():
            logits = trainer.model(trainer._batch(inp))
            ce_ref = F.cross_entropy(logits.flatten(0, 1),
                                     trainer._batch(lab).flatten()).item()
        del logits

        def counts():
            return {"flash_fwd": flash_fwd.launches,
                    "flash_bwd_preprocess": flash_bwd.launches_preprocess,
                    "fa_bwd_dkdv": flash_bwd.launches_dkdv,
                    "fa_bwd_dq": flash_bwd.launches_dq,
                    "flash_bwd_fused": flash_bwd.launches_fused}

        logs, per_step = [], []

        def log(metrics):  # called after every step (log_every=1)
            logs.append(metrics)
            per_step.append(counts())

        loader = make_loader(path)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_fwd.launches = flash_bwd.launches_preprocess = 0
        flash_bwd.launches_dkdv = flash_bwd.launches_dq = 0
        flash_bwd.launches_fused = 0
        trainer.fit(loader, steps=TRAIN_STEPS, log_fn=log)
        torch.cuda.synchronize()
        launches = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"training: {n_params / 1e6:.1f}M parameters, {mcfg.n_layer} "
              f"layers, b={TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps of "
              f"Trainer.fit; launches {launches}")
        n = mcfg.n_layer
        for i, c in enumerate(per_step):
            require(c == {"flash_fwd": n * (i + 1),
                          "flash_bwd_preprocess": n * (i + 1),
                          "fa_bwd_dkdv": n * (i + 1),
                          "fa_bwd_dq": n * (i + 1), "flash_bwd_fused": 0},
                    f"launch counts after training step {i + 1}: {c}")
        require(len(per_step) == TRAIN_STEPS and launches == per_step[-1],
                f"training launch counts {launches}")
        losses = [m["loss"] for m in logs]
        norms = [m["grad_norm"] for m in logs]
        print("training losses " + " ".join(f"{x:.4f}" for x in losses))
        print("training grad norms " + " ".join(f"{x:.4f}" for x in norms))
        require(len(losses) == TRAIN_STEPS and all(
            math.isfinite(x) for x in losses + norms), "non-finite loss")
        ln_v = math.log(mcfg.vocab_size)
        require(abs(losses[0] - ln_v) <= FIRST_LOSS_BAND,
                f"first loss {losses[0]} not within {FIRST_LOSS_BAND} of "
                f"ln(vocab) {ln_v:.4f}")
        tail = statistics.mean(losses[-3:])
        require(tail <= losses[0] - MIN_LOSS_DROP,
                f"loss did not fall: first {losses[0]}, last 3 {tail}")
        print(f"first-step loss {losses[0]:.4f} (ln vocab {ln_v:.4f}); mean of "
              f"the last 3 {tail:.4f}; torch cross-entropy over full fp32 "
              f"logits {ce_ref:.4f}")
        require(abs(losses[0] - ce_ref) <= CE_LOSS_ATOL,
                f"fused CE {losses[0]} vs full-logits CE {ce_ref}")
        step_s = statistics.median(TRAIN_BATCH * TRAIN_SEQ / m["tokens_per_s"]
                                   for m in logs[TRAIN_WARM:])
        tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
        tflops = tok_s * model_flops_per_token(mcfg, TRAIN_SEQ) / 1e12
        profile_step(trainer, loader)
        del trainer, loader

        # Two short runs from one seed: identical losses is a finding, not a
        # requirement (the bf16 moments are deterministic; a torch op
        # underneath may not be).
        runs = []
        for _ in range(2):
            torch.cuda.empty_cache()
            tr, ld = make_trainer(), make_loader(path)
            it = iter(ld)
            runs.append([tr.train_step(*map(tr._batch, next(it)))[0].item()
                         for _ in range(3)])
            del tr, ld
        same = runs[0] == runs[1]
        print(f"two 3-step runs from one seed: losses {runs[0]} and {runs[1]}"
              f" ({'identical' if same else 'different'})")
    return launches, {"step_ms": step_s * 1e3, "tokens_per_s": tok_s,
                      "tflops_per_s": tflops, "peak_gb": peak_gb,
                      "same_losses": same}


def device_events(fn, runs: int = 1, tries: int = 3):
    """The CUDA events (torch.profiler key averages with device time) of
    ``runs`` calls of fn(), after one warm-up call. A trace that recorded
    no device activity at all (the profiler's CUDA tracing lost the window,
    seen once in a long run on the card) is taken again, up to ``tries``
    times, then the run fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and getattr(e, "device_time_total", 0.0) > 0
                  and not e.key.startswith("ProfilerStep")]
        if events:
            return events
    raise RuntimeError(f"chip_smoke: {tries} profiler traces recorded no "
                       f"device activity")


def device_families(fn, families, what: str) -> float:
    """Device time of fn() by kernel family (torch.profiler): prints each
    family's share and the 12 costliest kernels; returns the total ms."""
    totals = dict.fromkeys(list(families) + ["elementwise, reductions, other"], 0.0)
    kernels = []
    for evt in device_events(fn):
        dev = evt.device_time_total
        fam = next((f for f, keys in families.items()
                    if any(k.lower() in evt.key.lower() for k in keys)),
                   "elementwise, reductions, other")
        totals[fam] += dev
        kernels.append((dev, evt.count, evt.key))
    total = sum(totals.values())
    print(f"profile: {what}, {total / 1e3:.2f} ms of device time")
    for fam, us in totals.items():
        print(f"profile:   {fam}: {us / 1e3:.2f} ms ({100 * us / total:.1f}%)")
    for dev, count, key in sorted(kernels, reverse=True)[:12]:
        print(f"profile:   {dev / 1e3:8.2f} ms  x{count:<5d} {key[:90]}")
    return total / 1e3


MATMULS = ("gemm", "nvjet", "cutlass", "xmma")
COPIES = ("copy", "Memcpy", "Memset", "cast")


def profile_step(trainer, loader):
    """Device time of one training step by kernel family (torch.profiler),
    and the phases of a step timed with CUDA events."""
    from flash_attn_tpu_torch.models.gpt import lm_head_weights
    from flash_attn_tpu_torch.ops.cross_entropy import (
        fused_linear_cross_entropy,
    )

    it = iter(loader)
    ids, labels = map(trainer._batch, next(it))
    device_families(
        lambda: trainer.train_step(ids, labels),
        {"attention forward (flash_fwd)": ("fwd_kernel",),
         "attention backward (preprocess + dkdv + dq)": (
             "preprocess_kernel", "dkdv_kernel", "dq_kernel"),
         "matmuls (cuBLAS)": MATMULS, "copies and casts": COPIES},
        "one training step")

    def phase(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    mcfg = trainer.cfg.model
    hidden, t_trunk = phase(lambda: trainer.model.forward_hidden(ids))
    kernel, tr = lm_head_weights(trainer.model)
    loss, t_ce = phase(lambda: fused_linear_cross_entropy(
        hidden, kernel, labels, transpose_kernel=tr,
        chunk_size=trainer.cfg.fused_ce_chunk))
    _, t_bwd = phase(loss.backward)
    h2 = hidden.detach().requires_grad_()
    loss2 = fused_linear_cross_entropy(h2, kernel.detach().requires_grad_(),
                                       labels, transpose_kernel=tr,
                                       chunk_size=trainer.cfg.fused_ce_chunk)
    _, t_ce_bwd = phase(loss2.backward)
    grads = {n: p.grad.float() for n, p in trainer.params.items()}
    for p in trainer.params.values():
        p.grad = None
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))

    def opt():
        trainer._update(grads, gnorm)
        trainer._write_weights(trainer.masters)
    _, t_opt = phase(opt)
    print(f"profile: phases (CUDA events, synchronised): trunk forward "
          f"{t_trunk:.2f} ms, fused CE forward {t_ce:.2f} ms, backward "
          f"{t_bwd:.2f} ms (of which fused CE backward {t_ce_bwd:.2f} ms), "
          f"optimizer + weight write-back {t_opt:.2f} ms "
          f"({mcfg.n_layer} layers, b={TRAIN_BATCH} x {TRAIN_SEQ})")


def wall_ms(fn, runs: int = 3) -> float:
    """Median host-clock time of fn() between synchronisations: for code
    that reads the device back itself (the plain versions' per-sequence
    loops), which time_ms's held stream would deadlock on."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sdpa_varlen(q, k, v, cu_q, cu_k, lens_q, lens_k, causal, dout):
    """The library yardstick for packed attention, timed only:
    scaled_dot_product_attention over nested jagged tensors when this
    torch runs it (forward and backward), else over the batch padded to
    its longest sequence with a boolean mask. Returns (forward fn,
    backward fn, what was timed)."""
    # one offsets tensor per ragged structure: nested tensors built on the
    # same offsets share their ragged dimension
    offsets = {"q": cu_q.long()}
    offsets["k"] = offsets["q"] if torch.equal(cu_q, cu_k) else cu_k.long()

    def njt(x, cu, lens):
        side = "q" if cu is cu_q else "k"
        return torch.nested.nested_tensor_from_jagged(
            x[:sum(lens)], offsets=offsets[side]).transpose(1, 2)

    def padded(x, cu, lens):
        out = x.new_zeros((len(lens), max(lens)) + x.shape[1:])
        for i, (lo, n) in enumerate(zip(cu.tolist()[:-1], lens)):
            out[i, :n] = x[lo:lo + n]
        return out.transpose(1, 2)

    rows = torch.arange(max(lens_q), device=q.device)[:, None]
    cols = torch.arange(max(lens_k), device=q.device)[None, :]
    lq = torch.tensor(lens_q, device=q.device)[:, None, None, None]
    lk = torch.tensor(lens_k, device=q.device)[:, None, None, None]
    mask = cols < lk
    if causal:
        mask = mask & (cols <= rows + lk - lq)
    for label, view, kw in (
            ("scaled_dot_product_attention over nested jagged tensors",
             njt, {"is_causal": causal}),
            ("scaled_dot_product_attention over the padded batch with a "
             "boolean mask", padded, {"attn_mask": mask})):
        try:
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            args = [view(x, cu, n) for x, cu, n in zip(
                leaves, (cu_q, cu_k, cu_k), (lens_q, lens_k, lens_k))]
            out = F.scaled_dot_product_attention(*args, **kw)
            grad = view(dout, cu_q, lens_q)
            torch.autograd.grad(out, leaves, grad, retain_graph=True)
        except (RuntimeError, NotImplementedError, TypeError) as exc:
            print(f"library yardstick: {label} does not run here "
                  f"({type(exc).__name__}: {str(exc)[:120]})")
            continue
        with torch.no_grad():
            fargs = [a.detach() for a in args]

        def fwd():
            return F.scaled_dot_product_attention(*fargs, **kw)

        def bwd():
            return torch.autograd.grad(out, leaves, grad, retain_graph=True)
        return fwd, bwd, label
    raise RuntimeError("no library yardstick for packed attention ran")


def kernel_split_ms(fn, names, runs: int = 5):
    """Device ms per call of each kernel whose name contains one of
    ``names`` (the first that matches), and under "other" of every other
    device activity (torch's own kernels, copies), from torch.profiler over
    ``runs`` calls."""
    total = dict.fromkeys(list(names) + ["other"], 0.0)
    for evt in device_events(fn, runs):
        name = next((n for n in names if n in evt.key), "other")
        total[name] += evt.device_time_total
    return {name: us / runs / 1e3 for name, us in total.items()}


def check_varlen(gen):
    """The four packed-varlen kernels against their plain versions on
    VARLEN_DENSE_CASES (the 2x rule against the fp32 plain versions, with
    the per-sequence reference in the inputs' type as the low-precision
    one; lse within LSE_ATOL); B7's bits against B6 forward's; the backward
    twice, bitwise. Times kernels, plain versions and the library yardstick
    at the first two cases. Returns the worst errors and the timings."""
    from flash_attn_tpu_torch.dispatch.varlen_meta import compute_varlen_meta
    from flash_attn_tpu_torch.kernels import flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp
    from flash_attn_tpu_torch.utils.testing import (
        attention_varlen_ref,
        attention_varlen_ref_grads,
        check_against_ref,
    )

    worst = dict.fromkeys(("flash_varlen_fwd", "flash_varlen_fwd_persistent",
                           "fa_varlen_bwd_dkdv", "fa_varlen_bwd_dq"), 0.0)
    timings = {}
    for ci, (name, lens_q, lens_k, used_q, used_k, tail, h, h_k, d, dtype,
             causal) in enumerate(VARLEN_DENSE_CASES):
        lens_k = lens_k or lens_q
        cu_q, cu_k = (torch.tensor(np.concatenate([[0], np.cumsum(x)]),
                                   dtype=torch.int32, device="cuda")
                      for x in (lens_q, lens_k))
        tq, tk = sum(lens_q) + tail, sum(lens_k) + tail

        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

        q, k, v, dout = randn(tq, h, d), randn(tk, h_k, d), randn(tk, h_k, d), \
            randn(tq, h, d)
        sq = (None if used_q is None else
              torch.tensor(used_q, dtype=torch.int32, device="cuda"))
        sk = (None if used_k is None else
              torch.tensor(used_k, dtype=torch.int32, device="cuda"))
        args = (cu_q, cu_k, max(lens_q), max(lens_k), sq, sk)
        meta = compute_varlen_meta(cu_q, cu_k, max(lens_q), max(lens_k), tq,
                                   tk, causal=causal, seqused_q=sq,
                                   seqused_k=sk)
        kw = dict(causal=causal, meta=meta)
        out, lse = flash_varlen.flash_attention_varlen_fwd(q, k, v, *args, **kw)
        out_p, lse_p = fvp.flash_attention_varlen_fwd_persistent(q, k, v, *args,
                                                                 **kw)
        grads = flash_varlen.flash_attention_varlen_bwd(dout, q, k, v, out, lse,
                                                        *args, **kw)
        again = flash_varlen.flash_attention_varlen_bwd(dout, q, k, v, out, lse,
                                                        *args, **kw)
        f32 = [x.float() for x in (q, k, v)]
        ref, ref_lse = flash_varlen.flash_attention_varlen_fwd_plain(
            *f32, *args, causal=causal)
        ref_p, ref_p_lse = fvp.flash_attention_varlen_fwd_persistent_plain(
            *f32, *args, **kw)
        ref_lp = attention_varlen_ref(q, k, v, cu_q, cu_k, sq, sk,
                                      causal=causal, upcast=False)
        torch.cuda.synchronize()
        case = (f"{name}: {len(lens_q)} sequences, rows {min(lens_q)}.."
                f"{max(lens_q)}, keys {min(lens_k)}..{max(lens_k)}, seqused_q "
                f"{used_q is not None}, seqused_k {used_k is not None}, tail "
                f"{tail}, h={h} h_k={h_k} d={d} {str(dtype)[6:]} "
                f"causal={causal}")
        errs = []
        for kname, got, got_lse, r, r_lse in (
                ("flash_varlen_fwd", out, lse, ref, ref_lse),
                ("flash_varlen_fwd_persistent", out_p, lse_p, ref_p, ref_p_lse)):
            err, err_lp = check_against_ref(got, r, ref_lp,
                                            msg=f"{kname} {case}")
            fin = torch.isfinite(r_lse)
            require(torch.equal(torch.isfinite(got_lse), fin),
                    f"{kname} {case}: rows without keys differ")
            lse_err = (got_lse[fin] - r_lse[fin]).abs().max().item() \
                if fin.any() else 0.0
            require(lse_err <= LSE_ATOL, f"{kname} lse error {lse_err}")
            worst[kname] = max(worst[kname], err)
            errs.append(f"{kname} out {err:.3e} (low-precision reference "
                        f"{err_lp:.3e}), lse {lse_err:.3e}")
        same = torch.equal(out_p, out) and torch.equal(lse_p, lse)
        require(same, f"{case}: B7 and B6 forward differ")
        require(all(torch.equal(a, b) for a, b in zip(grads, again)),
                f"{case}: the backward differs between runs")
        ref_g = flash_varlen.flash_attention_varlen_bwd_plain(
            dout.float(), *f32, ref, ref_lse, *args, causal=causal)
        del f32, ref_p, ref_p_lse
        lp_g = attention_varlen_ref_grads(q, k, v, dout, cu_q, cu_k, sq, sk,
                                          causal=causal, upcast=False)
        torch.cuda.synchronize()
        for gname, got, r, lp in zip("qkv", grads, ref_g, lp_g):
            kname = "fa_varlen_bwd_dq" if gname == "q" else "fa_varlen_bwd_dkdv"
            err, err_lp = check_against_ref(got, r, lp, atol=BWD_ATOL,
                                            msg=f"{kname} d{gname} {case}")
            worst[kname] = max(worst[kname], err)
            errs.append(f"d{gname} {err:.3e} (low-precision reference "
                        f"{err_lp:.3e})")
        del ref_g, lp_g, ref_lp
        print(f"varlen {case}: {'; '.join(errs)}; B7 bitwise equal to B6 "
              f"forward: {same}; backward bitwise equal over two runs: True")
        if ci >= 2:
            continue
        # times at this shape
        pairs = attended_pairs(used_q or lens_q, used_k or lens_k, causal)
        rows_q, rows_k = sum(used_q or lens_q), sum(used_k or lens_k)
        b6 = lambda: flash_varlen.flash_attention_varlen_fwd(q, k, v, *args, **kw)
        b7 = lambda: fvp.flash_attention_varlen_fwd_persistent(q, k, v, *args,
                                                              **kw)
        bwd = lambda: flash_varlen.flash_attention_varlen_bwd(
            dout, q, k, v, out, lse, *args, **kw)
        lib_fwd, lib_bwd, lib_label = sdpa_varlen(
            q, k, v, cu_q, cu_k, lens_q, lens_k, causal, dout)
        t = {"flash_varlen_fwd": time_ms(b6), "flash_varlen_fwd_persistent":
             time_ms(b7), "bwd": time_ms(bwd, runs=10)}
        t.update(kernel_split_ms(bwd, ("varlen_dkdv_kernel",
                                       "varlen_dq_kernel")))
        plain_fwd = wall_ms(lambda: flash_varlen.flash_attention_varlen_fwd_plain(
            q, k, v, *args, causal=causal))
        plain_p = wall_ms(lambda: fvp.flash_attention_varlen_fwd_persistent_plain(
            q, k, v, *args, **kw))
        plain_bwd = wall_ms(lambda: flash_varlen.flash_attention_varlen_bwd_plain(
            dout, q, k, v, out, lse, *args, causal=causal))
        lib_f, lib_b = time_ms(lib_fwd), time_ms(lib_bwd, runs=10)
        esz = q.element_size()
        # forward: q, k, v read once, out and lse written (the packed tail's
        # zeros included); 2 products over the attended pairs
        fwd_bound = bound(4 * h * d * pairs,
                          esz * (rows_q * h * d + 2 * rows_k * h_k * d
                                 + tq * h * d) + 4 * h * tq)
        # dK/dV: S, dP, dV and dK over the pairs; q, do, k, v, lse, delta
        # read, dk and dv written. dQ: S, dP and dQ; q, do, k, v, lse,
        # delta read, dq written.
        qdo = esz * 2 * rows_q * h * d + 8 * h * rows_q
        kv = esz * 2 * rows_k * h_k * d
        dkdv_bound = bound(8 * h * d * pairs, qdo + kv + esz * 2 * tk * h_k * d)
        dq_bound = bound(6 * h * d * pairs, qdo + kv + esz * tq * h * d)
        lib_fwd_call = {"library_ms": lib_f, "library_call": lib_label}
        lib_bwd_call = {"library_ms": lib_b,
                        "library_call": f"{lib_label}, backward (the dK/dV "
                                        f"and dQ kernels' pair)"}
        timings[name] = {
            "flash_varlen_fwd": {"ms": t["flash_varlen_fwd"],
                                 "plain_ms": plain_fwd, **lib_fwd_call,
                                 **fwd_bound},
            "flash_varlen_fwd_persistent": {
                "ms": t["flash_varlen_fwd_persistent"], "plain_ms": plain_p,
                **lib_fwd_call, **fwd_bound},
            "fa_varlen_bwd_dkdv": {"ms": t["varlen_dkdv_kernel"],
                                   "plain_ms": plain_bwd, **lib_bwd_call,
                                   **dkdv_bound},
            "fa_varlen_bwd_dq": {"ms": t["varlen_dq_kernel"],
                                 "plain_ms": plain_bwd, **lib_bwd_call,
                                 **dq_bound},
            "bwd_wrapper_ms": t["bwd"]}
        print(f"varlen times at {name} ({pairs / 1e6:.1f}M attended pairs): "
              f"B6 forward {t['flash_varlen_fwd']:.4f} ms, B7 "
              f"{t['flash_varlen_fwd_persistent']:.4f} ms (grid "
              f"{fvp.last_grid} blocks), bound {fwd_bound['bound_ms']:.4f} ms "
              f"({fwd_bound['bound_by']}); backward {t['bwd']:.4f} ms (dK/dV "
              f"kernel {t['varlen_dkdv_kernel']:.4f} ms, bound "
              f"{dkdv_bound['bound_ms']:.4f}; dQ kernel "
              f"{t['varlen_dq_kernel']:.4f} ms, bound "
              f"{dq_bound['bound_ms']:.4f}); plain forward {plain_fwd:.2f} ms, "
              f"persistent plain {plain_p:.2f} ms, plain backward "
              f"{plain_bwd:.2f} ms (host clock, median of 3); {lib_label}: "
              f"forward {lib_f:.4f} ms, backward {lib_b:.4f} ms")
        del lib_fwd, lib_bwd
    return worst, timings


def run_bench_varlen(gen, card):
    """bench.py's varlen section (bench.py:203-245) through the port: 4 x
    8192 non-causal and 16 mixed-length causal sequences through
    flash_attn_varlen_func (B7), the backward alone from residuals of
    flash_attention_varlen_fwd (B6 forward), then
    flash_attn_varlen_func(...).backward(). Each counted; returns the
    launches of the first counted run and the rates."""
    from flash_attn_tpu_torch import flash_attn_varlen_func
    from flash_attn_tpu_torch.kernels import flash_varlen

    h, d = 16, 128

    def setup(lengths):
        cu = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]),
                          dtype=torch.int32, device="cuda")
        q, k, v = (torch.randn(sum(lengths), h, d, device="cuda",
                               generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        return q, k, v, cu

    const = [8192] * 4
    qc, kc, vc, cuc = setup(const)
    qm, km, vm, cum = setup(BENCH_MIXED_LENS)
    mx = max(BENCH_MIXED_LENS)
    args_c = (cuc, cuc, 8192, 8192)
    args_m = (cum, cum, mx, mx)
    torch.cuda.synchronize()
    reset_kernel_counts()
    out_c = flash_attn_varlen_func(qc, kc, vc, *args_c, causal=False)
    out_m = flash_attn_varlen_func(qm, km, vm, *args_m, causal=True)
    out_r, lse_r = flash_varlen.flash_attention_varlen_fwd(qm, km, vm, *args_m,
                                                           causal=True)
    ones = torch.ones_like(out_r)
    grads_r = flash_varlen.flash_attention_varlen_bwd(ones, qm, km, vm, out_r,
                                                      lse_r, *args_m,
                                                      causal=True)
    torch.cuda.synchronize()
    launches = kernel_counts()
    want = want_counts(flash_varlen_fwd=1, flash_varlen_fwd_persistent=2,
                       fa_varlen_bwd_dkdv=1, fa_varlen_bwd_dq=1)
    require(launches == want, f"bench varlen launches {launches}, want {want}")
    require(bool(torch.isfinite(out_c.float()).all()), "non-finite out (4 x 8192)")
    require(torch.equal(out_m, out_r), "B7 and B6 forward differ (mixed)")

    leaves = [x.detach().requires_grad_() for x in (qm, km, vm)]
    torch.cuda.synchronize()
    reset_kernel_counts()
    flash_attn_varlen_func(*leaves, *args_m, causal=True).backward(ones)
    torch.cuda.synchronize()
    api = kernel_counts()
    want = want_counts(flash_varlen_fwd_persistent=1, fa_varlen_bwd_dkdv=1,
                       fa_varlen_bwd_dq=1)
    require(api == want, f"flash_attn_varlen_func backward launches {api}, "
                         f"want {want}")
    require(all(torch.equal(leaf.grad, g) for leaf, g in zip(leaves, grads_r)),
            "flash_attn_varlen_func gradients differ from the B6 backward's "
            "on the same residuals")
    print(f"bench varlen: launches {launches}; flash_attn_varlen_func(...)"
          f".backward() launches {api}, gradients bitwise equal to the "
          f"backward from B6 residuals")

    t_const = time_ms(lambda: flash_attn_varlen_func(qc, kc, vc, *args_c,
                                                     causal=False), runs=10)
    t_mixed = time_ms(lambda: flash_attn_varlen_func(qm, km, vm, *args_m,
                                                     causal=True), runs=10)
    t_bwd = time_ms(lambda: flash_varlen.flash_attention_varlen_bwd(
        ones, qm, km, vm, out_r, lse_r, *args_m, causal=True), runs=10)
    useful = sum(4.0 * h * d * n * n / 2 for n in BENCH_MIXED_LENS)
    rates = {"const_ms": t_const, "mixed_ms": t_mixed, "mixed_bwd_ms": t_bwd,
             "const_tflops": sum(4.0 * h * d * n * n for n in const)
             / t_const / 1e9,
             "mixed_tflops": useful / t_mixed / 1e9,
             "mixed_bwd_tflops": 2.5 * useful / t_bwd / 1e9}
    print(f"bench varlen (bench.py:203-245) on {card}: 4 x 8192 non-causal "
          f"{t_const:.4f} ms, {rates['const_tflops']:.1f} TFLOP/s; 16 x "
          f"U[2048, 4096] causal {t_mixed:.4f} ms, {rates['mixed_tflops']:.1f}"
          f" TFLOP/s of useful work; backward alone {t_bwd:.4f} ms, "
          f"{rates['mixed_bwd_tflops']:.1f} TFLOP/s (2.5x convention); "
          f"median of 10")
    return launches, rates


def bert_inputs(vocab: int):
    """BERT_BATCH rows padded to BERT_SEQ with BERT_LENS valid tokens, token
    types split at a seeded point inside each row, BERT_MASKED masked
    positions per row inside its valid length, and MLM / NSP labels."""
    rng = np.random.default_rng(1)
    b, s = BERT_BATCH, BERT_SEQ
    lens = np.array(BERT_LENS)
    ids = rng.integers(0, vocab, (b, s))
    mask = np.arange(s)[None] < lens[:, None]
    split = np.array([rng.integers(1, n) for n in lens])
    types = (np.arange(s)[None] >= split[:, None]) & mask
    pos = np.stack([np.sort(rng.choice(np.arange(1, n), BERT_MASKED,
                                       replace=False)) for n in lens])
    labels = rng.integers(0, vocab, (b, BERT_MASKED))
    nsp = rng.integers(0, 2, b)

    def dev(x, dtype=torch.long):
        return torch.as_tensor(x, device="cuda", dtype=dtype)

    return (dev(ids), dev(mask, torch.bool), dev(types), dev(pos),
            dev(labels), dev(nsp))


def run_bert(card):
    """BERT-large at full width and depth, bf16, random weights from a seed:
    a BertForMaskedLM forward on BERT_BATCH x BERT_SEQ padded rows (every
    layer through B7, none through B1), four rows alone without a mask
    through the dense path (B1) as the oracle, then one BertForPreTraining
    MLM + NSP cross-entropy forward and backward (B7, dK/dV and dQ per
    layer). Returns the launch counts and the measurements."""
    from flash_attn_tpu_torch.models.bert import (
        BertForMaskedLM,
        BertForPreTraining,
        bert_large,
    )

    cfg = bert_large(torch.bfloat16)
    n = cfg.num_hidden_layers
    ids, mask, types, pos, labels, nsp = bert_inputs(cfg.vocab_size)
    valid = int(mask.sum())
    mlm = BertForMaskedLM(cfg, device="cuda")
    mlm.reset_parameters(torch.Generator(device="cuda").manual_seed(3))
    mlm.requires_grad_(False)
    n_params = sum(p.numel() for p in mlm.parameters())
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_kernel_counts()
        logits = mlm(ids, mask, types, pos)
        torch.cuda.synchronize()
        inf_launches = kernel_counts()
        want = want_counts(flash_varlen_fwd_persistent=n)
        require(inf_launches == want, f"BERT forward launches {inf_launches},"
                                      f" want {want}")
        require(logits.shape == (BERT_BATCH, BERT_MASKED, cfg.vocab_size)
                and bool(torch.isfinite(logits).all()), "BERT MLM logits")
        print(f"BERT-large: {n_params / 1e6:.1f}M parameters, {n} layers; "
              f"BertForMaskedLM forward on {BERT_BATCH} x {BERT_SEQ} rows "
              f"({valid} valid tokens, {BERT_MASKED} masked positions a row): "
              f"launches {inf_launches}; logits {tuple(logits.shape)}, finite")
        hidden = mlm.bert(ids, mask, types)
        diffs = []
        for i in range(4):
            n_i = BERT_LENS[i]
            alone = mlm.bert(ids[i:i + 1, :n_i], None, types[i:i + 1, :n_i])
            diffs.append((hidden[i, :n_i].float() - alone[0].float()).abs())
        d_max = max(x.max().item() for x in diffs)
        d_mean = sum(x.sum().item() for x in diffs) / sum(x.numel()
                                                          for x in diffs)
        print(f"BERT-large oracle: rows 0-3 alone without a mask (dense B1) "
              f"vs the packed path (B7): valid hidden states max abs diff "
              f"{d_max:.4f} (bound {BERT_HIDDEN_MAX}), mean {d_mean:.5f} "
              f"(bound {BERT_HIDDEN_MEAN}); hidden std "
              f"{hidden[mask].float().std().item():.3f}")
        require(d_max <= BERT_HIDDEN_MAX and d_mean <= BERT_HIDDEN_MEAN,
                "packed BERT disagrees with per-row dense runs")
        del hidden, diffs, logits
        fwd_ms = wall_ms(lambda: mlm(ids, mask, types, pos), runs=5)
    del mlm
    torch.cuda.empty_cache()

    model = BertForPreTraining(cfg, device="cuda")
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(3))

    def step():
        model.zero_grad(set_to_none=True)
        mlm_logits, nsp_logits = model(ids, mask, types, pos)
        mlm_loss = F.cross_entropy(mlm_logits.flatten(0, 1), labels.flatten())
        loss = mlm_loss + F.cross_entropy(nsp_logits, nsp)
        loss.backward()
        return mlm_loss, loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    mlm_loss, loss = step()
    torch.cuda.synchronize()
    step_launches = kernel_counts()
    want = want_counts(flash_varlen_fwd_persistent=n, fa_varlen_bwd_dkdv=n,
                       fa_varlen_bwd_dq=n)
    require(step_launches == want, f"BERT training step launches "
                                   f"{step_launches}, want {want}")
    finite = all(bool(torch.isfinite(p.grad).all())
                 for p in model.parameters())
    ln_v = math.log(cfg.vocab_size)
    print(f"BERT-large BertForPreTraining MLM + NSP step: launches "
          f"{step_launches}; MLM loss {mlm_loss.item():.4f} (ln vocab "
          f"{ln_v:.4f}), total {loss.item():.4f}; every gradient finite: "
          f"{finite}")
    require(finite and math.isfinite(loss.item()), "non-finite BERT step")
    require(abs(mlm_loss.item() - ln_v) <= FIRST_LOSS_BAND,
            f"BERT MLM loss {mlm_loss.item()} not within {FIRST_LOSS_BAND} of "
            f"ln(vocab)")
    step_ms = wall_ms(step, runs=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dev_ms = device_families(
        step, {"attention forward (B7)": ("varlen_fwd",),
               "attention backward (B6 dK/dV + dQ)": ("varlen_dkdv",
                                                      "varlen_dq"),
               "matmuls (cuBLAS)": MATMULS, "copies and casts": COPIES},
        "one BERT-large MLM + NSP step")
    result = {"forward_ms": fwd_ms, "step_ms": step_ms, "peak_gb": peak_gb,
              "forward_tokens_per_s": valid / fwd_ms * 1e3,
              "step_tokens_per_s": valid / step_ms * 1e3,
              "step_device_ms": dev_ms, "step_idle_share": 1 - dev_ms / step_ms}
    print(f"BERT-large at {BERT_BATCH} x {BERT_SEQ} ({valid} valid tokens) on "
          f"{card}: MLM forward {fwd_ms:.2f} ms ({result['forward_tokens_per_s']:.0f}"
          f" valid tokens/s), MLM + NSP forward + backward {step_ms:.2f} ms "
          f"({result['step_tokens_per_s']:.0f} valid tokens/s), median of 5; "
          f"peak memory {peak_gb:.2f} GB (max_memory_allocated); a step's "
          f"device time {dev_ms:.2f} ms, idle share "
          f"{result['step_idle_share']:.3f}")
    del model
    torch.cuda.empty_cache()
    launches = {k: inf_launches[k] + step_launches[k] for k in step_launches}
    return launches, result


def mla_flops_bytes(pairs, rows, keys, h, h_k, d, dv, qv, esz, out_bytes,
                    table_entries):
    """Work of one MLA call: per (query row, key) pair and head, a score of
    depth d (+ dv with qv) and a dv-wide output row; q (and qv) read, the
    output written, each key's K (and, with qv, its separate V) read once,
    the table read. Returns (flops, bytes)."""
    depth = d + dv if qv else d
    flops = 2 * (depth + dv) * h * pairs
    nbytes = (esz * rows * h * depth + out_bytes
              + esz * keys * h_k * (d + dv if qv else d) + 4 * table_entries)
    return flops, nbytes


def mla_sdpa(q, qv, k_lin, v_lin, lens_q, lens_k, scale, causal):
    """The library yardstick of an MLA call, over a pre-gathered linear
    cache: scaled_dot_product_attention of q || qv against k || v (v alone
    for the output), one KV head spread over the query heads as a view,
    with a boolean mask for the lengths and the bottom-right causal band.
    q (b, sq, h, d), qv (b, sq, h, dv) or None, k_lin/v_lin (b, S, h_k,
    d/dv). Returns a function to time."""
    b, sq, h, _ = q.shape
    s_len, h_k = k_lin.shape[1], k_lin.shape[2]
    qq = (q if qv is None else torch.cat([q, qv], -1)).transpose(1, 2)
    kk = (k_lin if qv is None else torch.cat([k_lin, v_lin], -1))
    kk = kk.transpose(1, 2).repeat_interleave(h // h_k, 1) if h_k > 1 else \
        kk.transpose(1, 2).expand(b, h, s_len, kk.shape[-1])
    vv = v_lin.transpose(1, 2).repeat_interleave(h // h_k, 1) if h_k > 1 \
        else v_lin.transpose(1, 2).expand(b, h, s_len, v_lin.shape[-1])
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(s_len, device=q.device)[None, :]
    lq = torch.as_tensor(lens_q, device=q.device)[:, None, None, None]
    lk = torch.as_tensor(lens_k, device=q.device)[:, None, None, None]
    mask = cols < lk
    if causal:
        mask = mask & (cols <= rows + lk - lq)
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                                  scale=scale)


def check_mla(gen, card):
    """The two MLA kernels against their plain versions (the 2x rule against
    the fp32 plain version, with the same attention in the inputs' type as
    the low-precision reference; lse within LSE_ATOL), on
    MLA_PREFILL_CASES and MLA_DECODE_CASES; times B8p's first case and
    the decode cases that name a timing key beside the bound, the plain
    version and the SDPA yardstick. Returns the worst errors and the
    timings."""
    from flash_attn_tpu_torch.cache.kvcache import _default_num_splits
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.kernels import flash_paged_prefill as fpp
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        attention_varlen_paged_ref,
        check_against_ref,
        paged_to_linear,
    )

    worst = {"flash_paged_prefill": 0.0, "flash_decode_mla": 0.0}
    timings = {}
    yard = ("scaled_dot_product_attention of q || qv against k || v over a "
            "pre-gathered linear cache (the gather untimed), boolean mask")
    for ci, (name, lens_q, cached, h, h_k, d, dv, page, dtype, causal) in \
            enumerate(MLA_PREFILL_CASES):
        b = len(lens_q)
        lens_k = [c + n for c, n in zip(cached, lens_q)]
        cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                          dtype=torch.int32, device="cuda")
        total = int(cu[-1])
        q, qv = (torch.randn(total, h, w, device="cuda", generator=gen)
                 .to(dtype) for w in (d, dv))
        kp, vp, table = paged_cache(gen, b, h_k, d, page, max(lens_k), dtype,
                                    dv)
        seqlens_k = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
        args = (cu, max(lens_q), seqlens_k, table)
        kw = dict(qv=qv, softmax_scale=MLA_SCALE, causal=causal)
        out, lse = fpp.flash_attention_paged_prefill_varlen(q, kp, vp, *args,
                                                            **kw)
        ref, ref_lse = fpp.flash_attention_paged_prefill_varlen_plain(
            q.float(), kp.float(), vp.float(), *args, qv=qv.float(),
            softmax_scale=MLA_SCALE, causal=causal)
        ref_lp = attention_varlen_paged_ref(
            q, kp, vp, cu, seqlens_k, table, causal=causal,
            softmax_scale=MLA_SCALE, upcast=False, qv=qv)
        torch.cuda.synchronize()
        case = (f"{name}: chunks {lens_q} over {lens_k} keys, h={h} h_k={h_k}"
                f" d={d} + qv dv={dv}, pages of {page}, {str(dtype)[6:]}, "
                f"causal={causal}")
        err, err_lp = check_against_ref(out, ref, ref_lp,
                                        msg=f"flash_paged_prefill {case}")
        fin = torch.isfinite(ref_lse)
        require(torch.equal(torch.isfinite(lse), fin),
                f"flash_paged_prefill {case}: rows without keys differ")
        lse_err = (lse[fin] - ref_lse[fin]).abs().max().item()
        require(lse_err <= LSE_ATOL, f"flash_paged_prefill lse error {lse_err}")
        worst["flash_paged_prefill"] = max(worst["flash_paged_prefill"], err)
        print(f"flash_paged_prefill {case}: out max abs err {err:.3e} "
              f"(low-precision reference {err_lp:.3e}), lse max abs err "
              f"{lse_err:.3e}")
        del ref, ref_lp
        if ci:
            continue
        ms = time_ms(lambda: fpp.flash_attention_paged_prefill_varlen(
            q, kp, vp, *args, **kw), runs=10)
        plain_ms = wall_ms(lambda: fpp.flash_attention_paged_prefill_varlen_plain(
            q, kp, vp, *args, **kw))
        dense = lambda x: x.reshape(b, lens_q[0], h, x.shape[-1])
        lin = [paged_to_linear(x, table, seqlens_k).transpose(1, 2)
               for x in (kp, vp)]
        lib_ms = time_ms(mla_sdpa(dense(q), dense(qv), *lin, lens_q, lens_k,
                                  MLA_SCALE, causal), runs=10)
        del lin
        pairs = attended_pairs(lens_q, lens_k, causal)
        flops, nbytes = mla_flops_bytes(
            pairs, total, sum(lens_k), h, h_k, d, dv, True, 2,
            2 * total * h * dv + 4 * total * h, table.numel())
        timings["flash_paged_prefill"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_call": yard, **bound(flops, nbytes)}
        t = timings["flash_paged_prefill"]
        print(f"flash_paged_prefill time at {name} ({flops / 1e12:.3f} "
              f"TFLOP): kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"plain {plain_ms:.4f} ms (host clock), SDPA {lib_ms:.4f} ms; "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) on {card}")

    for (name, b, h, keys, d, dv, has_qv, page, splits, dtype,
         timed) in MLA_DECODE_CASES:
        seqlens = torch.tensor(keys, dtype=torch.int32, device="cuda")
        q = torch.randn(b, 1, h, d, device="cuda", generator=gen).to(dtype)
        qv = (torch.randn(b, 1, h, dv, device="cuda", generator=gen).to(dtype)
              if has_qv else None)
        if page:
            kc, vc, table = paged_cache(gen, b, 1, d, page, max(keys), dtype,
                                        dv)
            k_lin, v_lin = (paged_to_linear(x, table, seqlens).transpose(1, 2)
                            for x in (kc, vc))
        else:
            table = None
            s_max = -(-max(keys) // 64) * 64
            kc = torch.randn(b, 1, s_max, d, device="cuda",
                             generator=gen).to(dtype)
            vc = (torch.randn(b, 1, s_max, dv, device="cuda", generator=gen)
                  .to(dtype) if has_qv else kc[..., :dv])
            k_lin, v_lin = kc.transpose(1, 2), vc.transpose(1, 2)
        if splits == 0:
            splits = _default_num_splits(q, kc, vc, table, has_qv)
        splits = max(1, min(splits, -(-flash_decode.cache_capacity(kc, table)
                                      // 64)))
        call = lambda: flash_decode.flash_attention_decode_partials(
            q, kc, vc, seqlens, splits, MLA_SCALE, True, block_table=table,
            qv=qv)
        out, lse = flash_decode.flash_attention_decode(
            q, kc, vc, seqlens, MLA_SCALE, True, splits, block_table=table,
            qv=qv)
        f32 = lambda x: None if x is None else x.float()
        ref_p = flash_decode.flash_attention_decode_partials_plain(
            q.float(), k_lin.transpose(1, 2).float(),
            v_lin.transpose(1, 2).float(), seqlens, splits, 64, MLA_SCALE,
            True, qv=f32(qv))
        ref, ref_lse = flash_decode.combine_splits(*ref_p)
        ref = ref.reshape(b, 1, 1, h, dv)[:, :, 0]
        ref_lse = ref_lse.reshape(b, h, 1)
        keep = torch.arange(k_lin.shape[1], device="cuda")[None] \
            < seqlens[:, None]
        ref_lp, _ = attention_ref(q, k_lin, v_lin, key_padding_mask=keep,
                                  softmax_scale=MLA_SCALE, upcast=False,
                                  qv=qv)
        torch.cuda.synchronize()
        case = (f"{name}: b={b} h={h} d={d}{' + qv' if has_qv else ''} "
                f"dv={dv}, keys {min(keys)}..{max(keys)}, "
                f"{'pages of ' + str(page) if page else 'linear cache'}, "
                f"{str(dtype)[6:]}, {splits} splits")
        err, err_lp = check_against_ref(out, ref, ref_lp,
                                        msg=f"flash_decode_mla {case}")
        lse_err = (lse - ref_lse).abs().max().item()
        require(lse_err <= LSE_ATOL, f"flash_decode_mla lse error {lse_err}")
        worst["flash_decode_mla"] = max(worst["flash_decode_mla"], err)
        print(f"flash_decode_mla {case}: out max abs err {err:.3e} "
              f"(low-precision reference {err_lp:.3e}), lse max abs err "
              f"{lse_err:.3e}")
        del ref_p, ref, ref_lp
        if timed is None:
            continue
        ms = time_ms(call)
        plain_ms = wall_ms(lambda: (
            flash_decode.flash_attention_decode_paged_partials_plain(
                q, kc, vc, seqlens, table, splits, 64, MLA_SCALE, True, qv=qv)
            if page else flash_decode.flash_attention_decode_partials_plain(
                q, kc, vc, seqlens, splits, 64, MLA_SCALE, True, qv=qv)))
        lib_ms = time_ms(mla_sdpa(q, qv, k_lin, v_lin, [1] * b, keys,
                                  MLA_SCALE, True))
        # The bound is the decode function's: q, qv, the cache, the table
        # and lengths read, the combined output (in q's type) and lse
        # written. The fp32 split partials the kernel writes (and the merge
        # reads) follow from the wrapper's split count, not from the
        # function, so they are reported beside the bound, not in it.
        total_keys = sum(keys)
        esz = torch.finfo(dtype).bits // 8
        flops, nbytes = mla_flops_bytes(
            total_keys, b, total_keys, h, 1, d, dv, has_qv, esz,
            esz * b * h * dv + 4 * b * h,
            0 if table is None else table.numel())
        nbytes += 4 * b
        partial_bytes = 4 * splits * b * h * (dv + 1)
        timings[timed] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "library_call": yard,
                          "num_splits": splits,
                          "split_partial_bytes": partial_bytes,
                          **bound(flops, nbytes)}
        t = timings[timed]
        print(f"flash_decode_mla time at {name} ({splits} splits): kernel "
              f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s of the function's "
              f"{nbytes / 1e6:.2f} MB, {flops / ms / 1e9:.1f} TFLOP/s), "
              f"plain {plain_ms:.4f} ms (host clock), SDPA {lib_ms:.4f} ms; "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); besides, the "
              f"split partials {partial_bytes / 1e6:.2f} MB "
              f"({partial_bytes / PEAK_BYTES * 1e3:.4f} ms at the memory "
              f"rate) on {card}")
    return worst, timings


def run_mla_serving(gen, card):
    """DeepSeek-V3's absorbed attention stack served through the public API
    at full width and depth with seeded tensors: MLA_BATCH prompts of
    MLA_PROMPT tokens prefilled in chunks of MLA_CHUNK (kv_cache_update +
    flash_attn_varlen_func(block_table=, qv=)), then MLA_NEW decode steps
    (flash_attn_with_kvcache(k=, v=, qv=, block_table=)), each of the
    MLA_LAYERS layers over its own paged latent cache. The counted run
    checks launches and finiteness; an oracle then runs the last layer's
    last decode step again as a 1-token chunk through B8p; a second run is
    timed. Returns the launch counts and the measurements."""
    from flash_attn_tpu_torch import (
        flash_attn_varlen_func,
        flash_attn_with_kvcache,
    )
    from flash_attn_tpu_torch.cache.kvcache import kv_cache_update
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
        paged_to_linear,
    )

    n, h, d, dv = MLA_LAYERS, MLA_HEADS, MLA_ROPE, MLA_LATENT
    b, chunks = MLA_BATCH, MLA_PROMPT // MLA_CHUNK
    width = -(-(MLA_PROMPT + MLA_NEW) // MLA_PAGE)
    dt = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dt)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pages = [(torch.zeros(b * width + 1, 1, MLA_PAGE, d, dtype=dt,
                          device="cuda"),
              torch.zeros(b * width + 1, 1, MLA_PAGE, dv, dtype=dt,
                          device="cuda")) for _ in range(n)]
    table = (1 + torch.randperm(b * width, device="cuda", generator=gen)
             ).reshape(b, width).to(torch.int32)
    # seeded inputs, made before the runs: per chunk the queries of every
    # layer (shared), per layer and chunk the new rope keys and latents
    chunk_q = [(randn(b * MLA_CHUNK, h, d), randn(b * MLA_CHUNK, h, dv))
               for _ in range(chunks)]
    chunk_kv = randn(n, chunks, b, MLA_CHUNK, 1, d + dv)
    step_q = randn(MLA_NEW, n, b, 1, h, d + dv)
    step_kv = randn(MLA_NEW, n, b, 1, 1, d + dv)
    cu = torch.arange(b + 1, dtype=torch.int32, device="cuda") * MLA_CHUNK

    def prefill(c, layer):
        """Chunk c of every sequence through one layer: append its rope keys
        and latents, then attend."""
        kp, vp = pages[layer]
        before = torch.full((b,), c * MLA_CHUNK, dtype=torch.int32,
                            device="cuda")
        kv = chunk_kv[layer, c]
        kv_cache_update(kp, vp, kv[..., :d], kv[..., d:], before,
                        block_table=table)
        q, qv = chunk_q[c]
        return flash_attn_varlen_func(
            q, kp, vp, cu, None, MLA_CHUNK, (c + 1) * MLA_CHUNK,
            softmax_scale=MLA_SCALE, causal=True, block_table=table,
            seqused_k=before + MLA_CHUNK, qv=qv)

    def decode(step, layer, lens):
        """One decode step of one layer: append and attend."""
        kp, vp = pages[layer]
        qq, kv = step_q[step, layer], step_kv[step, layer]
        return flash_attn_with_kvcache(
            qq[..., :d], kp, vp, k=kv[..., :d], v=kv[..., d:],
            qv=qq[..., d:], cache_seqlens=lens, block_table=table,
            softmax_scale=MLA_SCALE, causal=True)

    def serve(check: bool):
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(chunks):
            for layer in range(n):
                out = prefill(c, layer)
                if check:
                    finite &= torch.isfinite(out).all()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lens = torch.full((b,), MLA_PROMPT, dtype=torch.int32, device="cuda")
        for step in range(MLA_NEW):
            for layer in range(n):
                out = decode(step, layer, lens)
                if check:
                    finite &= torch.isfinite(out).all()
            lens = lens + 1
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        # out: the last layer's last decode step
        return bool(finite), out, lens, t1 - t0, t2 - t1

    reset_kernel_counts()
    finite, dec_out, lens, _, _ = serve(True)
    launches = kernel_counts()
    want = want_counts(flash_paged_prefill=n * chunks,
                       flash_decode_mla=n * MLA_NEW)
    print(f"MLA serving: {n} layers x {h} heads, rope {d} + latent {dv}, "
          f"scale {MLA_SCALE:.5f}; {b} x {MLA_PROMPT}-token prompts in "
          f"{chunks} chunks of {MLA_CHUNK}, then {MLA_NEW} decode steps, "
          f"pages of {MLA_PAGE}; launches {launches}; every output finite: "
          f"{finite}")
    require(launches == want, f"MLA serving launches {launches}, want {want}")
    require(finite, "non-finite MLA serving output")

    # The oracle: the last layer's last decode step as a 1-token chunk
    # through B8p (not counted), both held to the 2x rule against the fp32
    # reference over the gathered cache, and against each other.
    kp, vp = pages[-1]
    qq = step_q[-1, -1]
    q1, qv1 = qq[..., :d].reshape(b, h, d), qq[..., d:].reshape(b, h, dv)
    one = torch.arange(b + 1, dtype=torch.int32, device="cuda")
    pf_out = flash_attn_varlen_func(
        q1, kp, vp, one, None, 1, MLA_PROMPT + MLA_NEW,
        softmax_scale=MLA_SCALE, causal=True, block_table=table,
        seqused_k=lens, qv=qv1).reshape(b, 1, h, dv)
    k_lin, v_lin = (paged_to_linear(x, table, lens).transpose(1, 2)
                    for x in (kp, vp))
    keep = torch.arange(k_lin.shape[1], device="cuda")[None] < lens[:, None]
    refs = [attention_ref(qq[..., :d], k_lin, v_lin, key_padding_mask=keep,
                          softmax_scale=MLA_SCALE, upcast=up,
                          qv=qq[..., d:])[0] for up in (True, False)]
    err_dec, err_lp = check_against_ref(dec_out, *refs,
                                        msg="MLA decode vs reference")
    err_pf, _ = check_against_ref(pf_out, *refs, msg="MLA B8p vs reference")
    diff = (dec_out.float() - pf_out.float()).abs().max().item()
    require(diff <= 2 * err_lp + 1e-5,
            f"MLA decode and the 1-token B8p chunk differ by {diff}")
    print(f"MLA oracle, layer {n}'s last decode step: decode max abs err "
          f"{err_dec:.3e}, as a 1-token B8p chunk {err_pf:.3e} (bf16 "
          f"reference {err_lp:.3e}); decode vs B8p {diff:.3e} (bound "
          f"{2 * err_lp + 1e-5:.3e})")
    del refs, k_lin, v_lin, pf_out

    _, _, _, prefill_s, decode_s = serve(False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Where the time goes: the last chunk of layer 0 and the last decode
    # step of every layer again (the same writes), by kernel family, beside
    # their wall time.
    last = torch.full((b,), MLA_PROMPT + MLA_NEW - 1, dtype=torch.int32,
                      device="cuda")
    families = {"MLA attention kernels": ("paged_prefill_kernel",
                                          "decode_mla_kernel"),
                "copies and fills": COPIES + ("fill",)}
    split = {}
    for what, fn in (
            ("prefill layer-chunk", lambda: prefill(chunks - 1, 0)),
            (f"decode step over {n} layers",
             lambda: [decode(MLA_NEW - 1, layer, last) for layer in range(n)])):
        dev_ms = device_families(fn, families, f"one MLA {what}")
        wall = wall_ms(fn, runs=5)
        split[what] = {"device_ms": dev_ms, "wall_ms": wall,
                       "idle_share": 1 - dev_ms / wall}
        print(f"MLA {what}: wall {wall:.3f} ms, device {dev_ms:.3f} ms, "
              f"device idle share {1 - dev_ms / wall:.3f} on {card}")
    result = {"prefill_ms_per_layer_chunk": prefill_s * 1e3 / (n * chunks),
              "prefill_s": prefill_s,
              "decode_step_ms": decode_s * 1e3 / MLA_NEW,
              "decode_tokens_per_s": b * MLA_NEW / decode_s,
              "peak_gb": peak_gb, "oracle_err": diff, "profile": split}
    print(f"MLA serving on {card}: prefill {prefill_s:.3f} s "
          f"({result['prefill_ms_per_layer_chunk']:.3f} ms per layer-chunk "
          f"of {b} x {MLA_CHUNK} tokens), decode step over {n} layers "
          f"{result['decode_step_ms']:.3f} ms, "
          f"{result['decode_tokens_per_s']:.1f} tokens/s at b={b}; peak "
          f"memory {peak_gb:.2f} GB (max_memory_allocated)")
    del pages, chunk_q, chunk_kv, step_q, step_kv
    torch.cuda.empty_cache()
    return launches, result


def blocksparse_mask(kind: str, b: int, nq: int, nk: int) -> torch.Tensor:
    """The (nq, nk) block mask of BS_CASES (per batch entry, (b, nq, nk),
    for "random")."""
    i = torch.arange(nq)[:, None]
    j = torch.arange(nk)[None, :]
    if kind == "causal":
        return j <= i
    if kind == "local":
        return ((j <= i) & (j > i - BS_WINDOW)) | (j == 0)
    gen = torch.Generator().manual_seed(6)
    mask = torch.rand(b, nq, nk, generator=gen) < 0.5
    empty = ~mask.any(-1)
    mask[empty, torch.randint(nk, (int(empty.sum()),), generator=gen)] = True
    mask[0, 1] = False  # the one empty row
    return mask


def blocksparse_pair_mask(mask, b, s, block, causal) -> torch.Tensor:
    """(b, s, s) bool: the (row, key) pairs the block mask lists and the
    causal mask keeps."""
    w = mask.expand(b, *mask.shape[-2:]).repeat_interleave(block, 1)
    w = w.repeat_interleave(block, 2)
    if causal:
        w &= torch.ones(s, s, dtype=torch.bool).tril()
    return w


def blocksparse_dense_oracle(q, k, v, dout, out, lse, grads, ref, ref_lp,
                             case):
    """The full causal block mask against the dense kernels: out and lse
    bitwise equal to B1's, which walks the same 64-key tiles in the same
    order; the gradients against B6's backward over the same rows packed as
    b sequences, which walks the same tiles of bwd_tile.cuh (bitwise, or
    else the 2x rule against the plain fp32 backward, reported)."""
    from flash_attn_tpu_torch.kernels import flash_fwd, flash_varlen
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    b, h, s, d = q.shape
    out1, lse1 = flash_fwd.flash_attention_fwd(q, k, v, causal=True)
    require(torch.equal(out1, out) and torch.equal(lse1, lse),
            f"block-sparse {case}: out/lse differ from B1")
    cu = torch.arange(b + 1, dtype=torch.int32, device="cuda") * s
    packed = [x.transpose(1, 2).reshape(b * s, h, d)
              for x in (dout, q, k, v, out)]
    dense = flash_varlen.flash_attention_varlen_bwd(
        *packed, lse.permute(1, 0, 2).reshape(h, b * s), cu, cu, s, s,
        causal=True)
    dense = [g.reshape(b, s, h, d).transpose(1, 2) for g in dense]
    bitwise = all(torch.equal(g.to(g6.dtype), g6)
                  for g, g6 in zip(grads, dense))
    if not bitwise:
        for gname, g6, r, lp in zip("qkv", dense, ref, ref_lp):
            check_against_ref(g6, r, lp, atol=BWD_ATOL,
                              msg=f"B6 d{gname} as the oracle of {case}")
    print(f"block-sparse {case}: out and lse bitwise equal to B1 "
          f"(flash_attn_func causal); gradients "
          + ("bitwise equal to B6's over the same rows packed" if bitwise
             else "not bitwise equal to B6's over the same rows packed; B6 "
                  "holds the 2x rule against the plain fp32 backward"))


def check_blocksparse(gen, card):
    """B10 (csrc/flash_blocksparse.cu) on BS_CASES. Each case first drives
    the public differentiable flash_attention_blocksparse(...).backward()
    with the counts set to 0 just before and read just after (1 forward, 1
    dK/dV and 1 dQ launch, nothing else); then holds the forward and the
    fp32 backward to the 2x rule against the plain fp32 versions (the plain
    forward in bf16, and autograd through it, as the low-precision
    reference; lse within LSE_ATOL), requires the backward to give the same
    bits twice, and on the full causal mask the bits of B1 (out, lse) and
    of B6's backward over the same rows (blocksparse_dense_oracle); times
    kernel, plain and SDPA with the expanded boolean mask (forward and
    backward; masks with no empty row) beside the bound: the listed,
    unmasked pairs' 4 d flops (10 d backward) over 989 TFLOP/s, or the
    bytes over 3.35 TB/s, with a profiler split of the backward's two
    kernels. Returns the launches, worst errors and timings."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    h, d = BS_HEADS, BS_DIM
    launches = {"flash_blocksparse_fwd": 0, "flash_blocksparse_bwd": 0}
    worst = dict.fromkeys(launches, 0.0)
    timings = {}
    for name, b, s, block, kind, causal in BS_CASES:
        nt = s // block
        mask = blocksparse_mask(kind, b, nt, nt)
        num, idx = (x.cuda() for x in bs.blockmask_to_kv_indices(mask))
        q, k, v, dout = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                         .to(torch.bfloat16) for _ in range(4))
        kw = dict(causal=causal, block_q=block, block_k=block)
        case = f"{name} (b={b}, s={s}, tiles of {block})"

        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        torch.cuda.synchronize()
        reset_kernel_counts()
        bs.flash_attention_blocksparse(*leaves, num, idx, **kw).backward(dout)
        torch.cuda.synchronize()
        got = kernel_counts()
        require(got == want_counts(flash_blocksparse_fwd=1,
                                   fa_blocksparse_bwd_dkdv=1,
                                   fa_blocksparse_bwd_dq=1),
                f"block-sparse {case}: launch counts {got}")
        launches["flash_blocksparse_fwd"] += 1
        launches["flash_blocksparse_bwd"] += 2
        api_grads = [x.grad for x in leaves]
        del leaves

        out, lse = bs.flash_attention_blocksparse_fwd(q, k, v, num, idx, **kw)
        grads = bs.flash_attention_blocksparse_bwd(dout, q, k, v, out, lse,
                                                   num, idx, **kw)
        again = bs.flash_attention_blocksparse_bwd(dout, q, k, v, out, lse,
                                                   num, idx, **kw)
        require(all(torch.equal(a, b_) for a, b_ in zip(grads, again)),
                f"block-sparse backward differs between runs: {case}")
        require(all(torch.equal(a, g.bfloat16())
                    for a, g in zip(api_grads, grads)),
                f"block-sparse autograd gradients are not the fp32 "
                f"gradients in bf16: {case}")
        del again, api_grads

        f32 = [x.float() for x in (q, k, v)]
        out32, lse32 = bs.flash_attention_blocksparse_fwd_plain(*f32, num, idx,
                                                                **kw)
        ref = bs.flash_attention_blocksparse_bwd_plain(
            dout.float(), *f32, out32, lse32, num, idx, **kw)
        lp_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out_lp, _ = bs.flash_attention_blocksparse_fwd_plain(
            *lp_leaves, num, idx, upcast=False, **kw)
        ref_lp = torch.autograd.grad(out_lp, lp_leaves, dout)
        err, err_lp = check_against_ref(out, out32, out_lp.detach(),
                                        msg=f"block-sparse out {case}")
        fin = torch.isfinite(lse32)
        require(torch.equal(torch.isfinite(lse), fin),
                f"block-sparse lse -inf pattern: {case}")
        lse_err = float((lse[fin] - lse32[fin]).abs().max())
        require(lse_err <= LSE_ATOL, f"block-sparse lse {lse_err}: {case}")
        worst["flash_blocksparse_fwd"] = max(worst["flash_blocksparse_fwd"],
                                             err)
        errs = [f"out {err:.3e} (low-precision reference {err_lp:.3e}), lse "
                f"{lse_err:.3e}"]
        for gname, g, r, lp in zip("qkv", grads, ref, ref_lp):
            e, e_lp = check_against_ref(g, r, lp, atol=BWD_ATOL,
                                        msg=f"block-sparse d{gname} {case}")
            worst["flash_blocksparse_bwd"] = max(
                worst["flash_blocksparse_bwd"], e)
            errs.append(f"d{gname} {e:.3e} ({e_lp:.3e})")
        empty = ~mask.expand(b, nt, nt).any(-1)
        if empty.any():
            rows = empty.repeat_interleave(block, 1).cuda()  # (b, s)
            require(not out.transpose(1, 2)[rows].any()
                    and bool(lse.transpose(1, 2)[rows].isneginf().all())
                    and not grads[0].transpose(1, 2)[rows].any(),
                    f"block-sparse empty row: out 0, lse -inf, dq 0: {case}")
        print(f"block-sparse {case}: launches 1/1/1 through autograd; "
              f"backward bitwise equal over two runs; max abs err "
              f"{', '.join(errs)}")
        if kind == "causal":
            blocksparse_dense_oracle(q, k, v, dout, out, lse, grads, ref,
                                     ref_lp, case)
        del out32, lse32, ref, lp_leaves, out_lp, ref_lp, f32

        em = blocksparse_pair_mask(mask, b, s, block, causal)
        pairs = int(em.sum()) * h
        el = b * h * s * d
        list_bytes = 4 * (num.numel() + idx.numel())
        fwd_bound = bound(4 * d * pairs, 2 * 4 * el + 4 * b * h * s
                          + list_bytes)
        bwd_bound = bound(10 * d * pairs, 2 * 5 * el + 4 * 3 * el
                          + 4 * b * h * s + list_bytes)
        t = {"pairs": pairs, "density": pairs / (b * h * s * s)}
        t["fwd_ms"] = time_ms(lambda: bs.flash_attention_blocksparse_fwd(
            q, k, v, num, idx, **kw), runs=10)
        t["bwd_ms"] = time_ms(lambda: bs.flash_attention_blocksparse_bwd(
            dout, q, k, v, out, lse, num, idx, **kw), runs=10)
        t["bwd_kernels_ms"] = kernel_split_ms(
            lambda: bs.flash_attention_blocksparse_bwd(
                dout, q, k, v, out, lse, num, idx, **kw),
            ["bs_dkdv_kernel", "bs_dq_kernel"])
        t["plain_fwd_ms"] = wall_ms(lambda: bs.flash_attention_blocksparse_fwd_plain(
            q, k, v, num, idx, **kw))
        t["plain_bwd_ms"] = wall_ms(lambda: bs.flash_attention_blocksparse_bwd_plain(
            dout, q, k, v, out, lse, num, idx, **kw))
        t["sdpa_fwd_ms"] = t["sdpa_bwd_ms"] = None
        if not empty.any():
            em = em[:, None].cuda()
            t["sdpa_fwd_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=em), runs=10)
            sl = [x.detach().requires_grad_() for x in (q, k, v)]
            so = F.scaled_dot_product_attention(*sl, attn_mask=em)
            t["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                so, sl, dout, retain_graph=True), runs=10)
            del sl, so
        del em
        t["fwd_bound_ms"], t["fwd_bound_by"] = (fwd_bound["bound_ms"],
                                                fwd_bound["bound_by"])
        t["bwd_bound_ms"], t["bwd_bound_by"] = (bwd_bound["bound_ms"],
                                                bwd_bound["bound_by"])
        timings[name] = t
        print(f"block-sparse {case}: {pairs / (b * h * s * s):.4f} of the "
              f"pairs; forward {t['fwd_ms']:.4f} ms (bound "
              f"{t['fwd_bound_ms']:.4f}, {t['fwd_bound_by']}; plain "
              f"{t['plain_fwd_ms']:.4f}; masked SDPA {t['sdpa_fwd_ms']}), "
              f"backward {t['bwd_ms']:.4f} ms (bound {t['bwd_bound_ms']:.4f},"
              f" {t['bwd_bound_by']}; plain {t['plain_bwd_ms']:.4f}; masked "
              f"SDPA {t['sdpa_bwd_ms']}; profiler: dK/dV kernel "
              f"{t['bwd_kernels_ms']['bs_dkdv_kernel']:.4f}, dQ kernel "
              f"{t['bwd_kernels_ms']['bs_dq_kernel']:.4f}) on {card}")
        del q, k, v, dout, out, lse, grads
        torch.cuda.empty_cache()
    tb = timings[BS_TIMED]
    timing = {
        "flash_blocksparse_fwd": {
            "ms": tb["fwd_ms"], "plain_ms": tb["plain_fwd_ms"],
            "bound_ms": tb["fwd_bound_ms"], "bound_by": tb["fwd_bound_by"],
            "library_ms": tb["sdpa_fwd_ms"],
            "library_call": "scaled_dot_product_attention(attn_mask=the "
                            "expanded boolean mask)"},
        "flash_blocksparse_bwd": {
            "ms": tb["bwd_ms"], "plain_ms": tb["plain_bwd_ms"],
            "bound_ms": tb["bwd_bound_ms"], "bound_by": tb["bwd_bound_by"],
            "library_ms": tb["sdpa_bwd_ms"],
            "library_call": "its backward (torch.autograd.grad)"}}
    return launches, worst, timing, timings


def run_probes(card):
    """The two H100 probes (B13), each with its count set to 0 just before
    and read just after: the shared-memory probe at every size of
    smem_probe.SIZES_KB (every size up to SMEM_LIMIT_KB accepted, every
    larger one refused, outputs equal to the plain version) and the
    mma/exp2 overlap probe (us a step of each mode by trip-count slope,
    outputs against the plain version). Times each kernel beside its
    plain version and bound. Returns launches, errors, timings and the
    readings."""
    from flash_attn_tpu_torch.probes import mma_exp2_overlap_probe as ov
    from flash_attn_tpu_torch.probes import smem_probe as sm

    sm.launches = 0
    rows = sm.run()
    smem_launches = sm.launches
    for r in rows:
        require(r["accepted"] == (r["kb"] <= SMEM_LIMIT_KB),
                f"smem probe: {r['kb']} KB accepted={r['accepted']}")
        require(not r["accepted"] or r["max_abs_err"] == 0.0,
                f"smem probe: {r['kb']} KB error {r['max_abs_err']}")
    require(smem_launches == sum(r["accepted"] for r in rows),
            f"smem probe launches {smem_launches}")
    for r in rows:
        print(f"smem probe {r['kb']} KB: "
              f"{'accepted' if r['accepted'] else 'refused'}, "
              f"{r['blocks_per_sm']} block(s) an SM, max abs err "
              f"{r['max_abs_err']} on {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(sm.SHAPE, device="cuda", generator=gen)
    top = SMEM_LIMIT_KB * 1024
    smem_t = {"ms": time_ms(lambda: sm.smem_probe(x, top)),
              "plain_ms": time_ms(lambda: sm.smem_probe_plain(x)),
              "library_ms": None,
              # x read and o written once, fp32
              **bound(x.numel(), 2 * 4 * x.numel())}

    ov.launches = 0
    res = ov.run()
    ov_launches = ov.launches
    for m in ov.MODES:
        require(res[f"{m}_max_abs_err"] <= 1e-6,
                f"overlap probe {m}: error {res[m + '_max_abs_err']}")
    steps = ov.STEPS[1]
    # per step: 4 rounds of 4 m16n8k16 products (4,096 flops) a warp over 4
    # warps; 4 rounds of 16 exp2 chain steps (multiply, exp2, subtract) a
    # thread over 128 threads, at the card's fp32 rate outside the tensor
    # cores (67 TFLOP/s)
    mma_flops = steps * ov.REPS * ov.CH * 4 * 4096
    exp_ops = steps * ov.REPS * ov.NV * ov.THREADS * 3
    t_mma, t_exp = mma_flops / PEAK_FLOPS, exp_ops / 67e12
    ov_t = {"ms": ov._launch_ms("both", steps, 11),
            "plain_ms": wall_ms(lambda: ov.overlap_probe_plain("both", steps)),
            "library_ms": None,
            "bound_ms": max(t_mma, t_exp) * 1e3,
            "bound_by": "operations"}
    print(f"mma/exp2 overlap probe (one block of {ov.THREADS} threads): mma "
          f"{res['mma_us_per_step']:.4f}, exp2 {res['exp2_us_per_step']:.4f},"
          f" both {res['both_us_per_step']:.4f} us a step (serial sum "
          f"{res['serial_us_per_step']:.4f}, overlap max "
          f"{res['overlap_us_per_step']:.4f}) on {card}")
    errs = {"smem_probe": max(r["max_abs_err"] for r in rows if r["accepted"]),
            "mma_exp2_overlap_probe": max(res[f"{m}_max_abs_err"]
                                          for m in ov.MODES)}
    return ({"smem_probe": smem_launches,
             "mma_exp2_overlap_probe": ov_launches}, errs,
            {"smem_probe": smem_t, "mma_exp2_overlap_probe": ov_t},
            {"smem": rows, "overlap": res})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        return 2
    from flash_attn_tpu_torch.kernels import _build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(_build.BUILD_DIR.parent.parent)}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    phases = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    fwd_err, fwd_t = phase("forward kernel checks", check_fwd, gen)
    dec_err, dec_t = phase("decode kernel checks", check_decode, gen)
    pdec_err, pdec_t = phase("paged decode kernel checks", check_decode_paged,
                             gen)
    vp_err, vp_t = phase("varlen-paged kernel checks", check_varlen_paged, gen)
    bwd_err, bwd_timing = phase("backward kernel checks", check_bwd, gen)
    api_launches = phase("flash_attn_func backward", run_api_backward, gen)
    vl_err, vl_t = phase("varlen kernel checks", check_varlen, gen)
    bench_vl_launches, bench_vl = phase("bench varlen", run_bench_varlen, gen,
                                        card)
    launches, ttft, tok_s = phase("static serving", run_slice, gen)
    print(f"time to first token (b={BATCH}, prompt {PROMPT}, median of 5): "
          f"{ttft * 1e3:.2f} ms; decode {tok_s:.1f} tokens/s at b={BATCH} "
          f"({NEW_TOKENS - 1} steps) on {card}")
    eng_launches, paged, px_launches, prefix = phase("engines", run_engines,
                                                     card)
    print(f"paged engine (64 slots, {ENGINE_REQUESTS} x {ENGINE_PROMPT}-token "
          f"prompts + {ENGINE_NEW} new): {paged['tokens_per_s']:.1f} tokens/s,"
          f" TTFT p50 {paged['ttft_p50_ms']:.1f} ms, p99 "
          f"{paged['ttft_p99_ms']:.1f} ms; prefix-cache engine "
          f"({PREFIX_REQUESTS} prompts sharing {PREFIX_SHARED} tokens): "
          f"{prefix['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{prefix['ttft_p50_ms']:.1f} ms, p99 {prefix['ttft_p99_ms']:.1f} ms"
          f" on {card}")
    train_launches, train = phase("training", run_training)
    print(f"training step (median of steps {TRAIN_WARM + 1}-{TRAIN_STEPS}): "
          f"{train['step_ms']:.1f} ms; {train['tokens_per_s']:.0f} tokens/s; "
          f"{train['tflops_per_s']:.1f} TFLOP/s (model_flops_per_token); peak "
          f"memory {train['peak_gb']:.2f} GB (max_memory_allocated) on {card}")
    bert_launches, bert = phase("BERT-large", run_bert, card)
    print(f"BERT-large (bert-large-uncased widths, 24 layers) at "
          f"{BERT_BATCH} x {BERT_SEQ}: MLM forward {bert['forward_ms']:.2f} ms,"
          f" forward + backward {bert['step_ms']:.2f} ms, "
          f"{bert['step_tokens_per_s']:.0f} valid tokens/s trained, peak "
          f"{bert['peak_gb']:.2f} GB; varlen TFLOP/s (bench.py shapes): "
          f"{bench_vl['const_tflops']:.1f} (4 x 8192), "
          f"{bench_vl['mixed_tflops']:.1f} (mixed causal), "
          f"{bench_vl['mixed_bwd_tflops']:.1f} (mixed backward) on {card}")
    mla_err, mla_t = phase("MLA kernel checks", check_mla, gen, card)
    mla_launches, mla = phase("MLA serving", run_mla_serving, gen, card)
    bs_launches, bs_err, bs_t, bs_all = phase("block-sparse",
                                              check_blocksparse, gen, card)
    pr_launches, pr_err, pr_t, probes = phase("probes", run_probes, card)
    print(f"DeepSeek-V3 absorbed attention ({MLA_LAYERS} layers): prefill "
          f"{mla['prefill_ms_per_layer_chunk']:.3f} ms per layer-chunk, "
          f"decode step {mla['decode_step_ms']:.3f} ms, "
          f"{mla['decode_tokens_per_s']:.1f} tokens/s at b={MLA_BATCH}, peak "
          f"{mla['peak_gb']:.2f} GB on {card}")
    print("phase wall times: " + ", ".join(
        f"{name} {sec:.1f} s" for name, sec in phases.items()))

    def entry(name, source, replaces, n, err, timing):
        if not replaces.startswith("benchmarks/"):
            replaces = f"flash_attn_tpu/kernels/{replaces}"
        return {"name": name, "route": "cuda",
                "source": f"flash_attn_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                **timing}

    print(json.dumps({"kernels": [
        entry("flash_fwd", "flash_fwd.cu", "flash_fwd.py:59",
              launches["flash_fwd"], fwd_err, fwd_t),
        entry("flash_decode", "flash_decode.cu", "flash_decode.py:54",
              launches["flash_decode"], dec_err, dec_t),
        entry("flash_decode_paged", "flash_decode.cu", "flash_decode.py:54",
              eng_launches["flash_decode_paged"], pdec_err, pdec_t),
        entry("flash_varlen_paged", "flash_varlen_paged.cu",
              "flash_varlen_paged.py:69", px_launches["flash_varlen_paged"],
              vp_err, vp_t),
        entry("flash_bwd_preprocess", "flash_bwd.cu", "flash_bwd.py:408",
              train_launches["flash_bwd_preprocess"],
              bwd_err["flash_bwd_preprocess"],
              bwd_timing["flash_bwd_preprocess"]),
        entry("flash_bwd", "flash_bwd.cu", "flash_bwd.py:181",
              train_launches["fa_bwd_dkdv"] + train_launches["fa_bwd_dq"],
              bwd_err["flash_bwd"], bwd_timing["flash_bwd"]),
        entry("flash_bwd_fused", "flash_bwd.cu", "flash_bwd_fused.py:64",
              api_launches[False]["flash_bwd_fused"],
              bwd_err["flash_bwd_fused"], bwd_timing["flash_bwd_fused"]),
        entry("flash_varlen_fwd", "flash_varlen.cu", "flash_varlen.py:79",
              bench_vl_launches["flash_varlen_fwd"], vl_err["flash_varlen_fwd"],
              vl_t["bench.py mixed"]["flash_varlen_fwd"]),
        entry("flash_varlen_fwd_persistent", "flash_varlen.cu",
              "flash_varlen_persistent.py:72",
              bert_launches["flash_varlen_fwd_persistent"],
              vl_err["flash_varlen_fwd_persistent"],
              vl_t["BERT-large packing"]["flash_varlen_fwd_persistent"]),
        entry("fa_varlen_bwd_dkdv", "flash_varlen.cu", "flash_varlen.py:462",
              bert_launches["fa_varlen_bwd_dkdv"], vl_err["fa_varlen_bwd_dkdv"],
              vl_t["BERT-large packing"]["fa_varlen_bwd_dkdv"]),
        entry("fa_varlen_bwd_dq", "flash_varlen.cu", "flash_varlen.py:651",
              bert_launches["fa_varlen_bwd_dq"], vl_err["fa_varlen_bwd_dq"],
              vl_t["BERT-large packing"]["fa_varlen_bwd_dq"]),
        entry("flash_paged_prefill", "flash_paged_prefill.cu",
              "flash_paged_prefill.py:60",
              mla_launches["flash_paged_prefill"],
              mla_err["flash_paged_prefill"], mla_t["flash_paged_prefill"]),
        entry("flash_decode_mla", "flash_decode_mla.cu", "flash_decode.py:54",
              mla_launches["flash_decode_mla"], mla_err["flash_decode_mla"],
              mla_t["flash_decode_mla"]),
        entry("flash_blocksparse_fwd", "flash_blocksparse.cu",
              "flash_blocksparse.py:46", bs_launches["flash_blocksparse_fwd"],
              bs_err["flash_blocksparse_fwd"], bs_t["flash_blocksparse_fwd"]),
        entry("flash_blocksparse_bwd", "flash_blocksparse.cu",
              "flash_blocksparse.py:225", bs_launches["flash_blocksparse_bwd"],
              bs_err["flash_blocksparse_bwd"], bs_t["flash_blocksparse_bwd"]),
        entry("smem_probe", "probes.cu", "benchmarks/vmem_probe.py:18",
              pr_launches["smem_probe"], pr_err["smem_probe"],
              pr_t["smem_probe"]),
        entry("mma_exp2_overlap_probe", "probes.cu",
              "benchmarks/mxu_vpu_overlap_probe.py:31",
              pr_launches["mma_exp2_overlap_probe"],
              pr_err["mma_exp2_overlap_probe"],
              pr_t["mma_exp2_overlap_probe"]),
    ], "engines": {"paged": paged, "prefix_cache": prefix},
        "varlen": {"timings": vl_t, "bench": bench_vl}, "bert": bert,
        "mla": {"serving": mla, "timings": mla_t},
        "blocksparse": bs_all, "probes": probes}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
