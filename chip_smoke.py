"""Smoke run of the PyTorch + CUDA port (flash_attn_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --spec-readings 5

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
   tensor cores); the forward (B1, the wgmma/TMA tile of fwd_sm90.cuh) is
   timed at the prefill's shape and the training shape beside SDPA, gives
   the same bits twice, and at both shapes the block-sparse forward B10
   over the full causal block mask (the same tile over the same band) gives
   its out and lse bitwise; at the
   training shape it splits each backward path into its kernels and the
   torch ops around them (torch.profiler), and B10's backward over the full
   causal block mask (B3's tiles over the same band) gives B3's gradients
   bitwise once rounded to bf16; on every backward shape B6's backward
   over the same rows packed gives B3's bits (both run the tiles of
   bwd_sm90.cuh); the paged varlen prefill (B8, the
   same tile with a paged K/V source) gives the same bits twice and B6's
   forward's bits over the same rows packed, and at the prefix-cached
   admission's shape its whole call and its kernel alone (torch.profiler)
   are timed;
3. calls flash_attn_func(...).backward() at the training shape, once with
   deterministic=True and once with False, and checks each run's launch
   counts (1 preprocess, then 1 dK/dV + 1 dQ, or 1 fused) and gradients;
4. serves 8 seeded 512-token prompts with the flagship 913M GPT (random
   weights from a seed, bf16) through serving.generation.decode for 32 new
   tokens, with its decode step replayed as a CUDA graph and then eagerly
   (tokens and logits bitwise equal, the same launch counts), checks that
   the kernels carried it (launch counts), that the logits are finite and
   that the decode steps agree with one teacher-forced forward; then times
   the first token and the graphed and eager decode rates;
5. trains the same model (random weights from a seed, bf16 weights with
   fp32 masters, bf16 Adam moments, fused CE) at b=4 x 2048 for 10 steps
   with Trainer.fit over an LMDataLoader of a seeded token file, checks
   the launch counts (per step 16 forward, 16 preprocess, 16 dK/dV, 16 dQ),
   a finite and falling loss, and the first step's
   fused-CE loss against torch's cross-entropy over full fp32 logits; then
   prints the step time, tokens/s, TFLOP/s, peak memory and a split of one
   training step's device time (torch.profiler and CUDA events); then
   takes REMAT_STEPS steps of the same model without remat and with
   GPTConfig(remat=True) under 'full' and 'dots' over the same batches
   (losses bitwise equal, B1 launched once more a layer under remat, peak
   memory lower under both policies; step times and peaks printed), and
   runs an MHA(dwconv=True) at the model's attention widths: a prefill
   then decode steps against its train mode over the same tokens, both
   held to an fp32 copy of the module by the 2x rule;
6. serves the same model through the continuous-batching InferenceEngine
   over a paged cache at the shape of bench.py's engine trace (64 slots,
   256-token pages, 96 seeded 512-token prompts arriving 8 at a time, 32
   new tokens each, decode blocks of 8), then again with prefix caching (64
   prompts sharing one 256-token page); checks the launch counts per
   admission and decode block, that every request finishes and every page
   returns, and that the engine's tokens agree with a teacher-forced static
   decode of the same prompts; each engine runs with its decode block
   captured as a CUDA graph and then eagerly, the tokens bitwise equal;
   then the speculative engine (k = 4 proposals a round, graphed) on the
   paged cache over 32 of the prompts, with the target as its own draft
   and with a seeded 4-layer draft of its widths (also eagerly): its tokens
   equal the plain engine's or part from them only at a bf16 near-tie,
   every page returns, and the self-draft accepts no less than its bound;
   prints tokens/s, TTFT p50/p99 and the device idle share of a decode
   block, graphed and eager.

7. holds the five packed-varlen kernels (B6's forward and the persistent
   B7, both on the wgmma/TMA tile of fwd_sm90.cuh over the same 128-row
   work list, and B6's backward preprocess, dK/dV and dQ, on the wgmma/TMA
   tiles of bwd_sm90.cuh) against their plain versions on four shapes
   (BERT-large's packing, bench.py's mixed lengths, ragged GQA fp16 with
   seqused and a packed tail, GQA at d=64), requires B7 to equal B6's
   forward bitwise and B6's forward, B7 and the backward each to repeat
   bitwise, and times kernels (the backward's three by the profiler),
   plain versions and an SDPA yardstick at the first two;
8. runs bench.py's varlen section (bench.py:203-245): 4 x 8192 and 16
   mixed-length causal sequences through flash_attn_varlen_func (B7), B6's
   forward on the mixed lengths (bitwise equal to B7), the backward from
   B7's residuals (1 preprocess, 1 dK/dV, 1 dQ launch), and
   flash_attn_varlen_func(...).backward() (its
   gradients bitwise equal to that backward's), with counted launches, and
   prints TFLOP/s of useful work;
9. runs BERT-large (bert-large-uncased widths, 24 layers, random bf16
   weights from a seed) on 32 rows padded to 512: a BertForMaskedLM forward
   (24 B7 launches, none of B1), four rows alone through the dense path as
   the oracle, and a BertForPreTraining MLM + NSP step (24 B7, 24
   preprocess, 24 dK/dV, 24 dQ launches); prints forward and step times,
   valid tokens/s and peak
   memory;
10. holds the two absorbed-MLA kernels against their plain versions: the
   paged chunked prefill with qv (B8p, wgmma and TMA page copies) on 7
   shapes (the serving phase's 8 x 512-row chunk over 2,048 keys,
   DeepSeek-V3's widths at 4 x 256, ragged chunks over pages of 16 and 256,
   GQA 8/2 at 64 + 128 in fp16, GQA 16/2 at 128 + 128, chunks that start
   mid-page) and the MLA decode route (the same wgmma/TMA tile of
   mla_sm90.cuh) on 7 (qv over a paged cache at the serving phase's last
   step, 8 rows of 2,080 keys, and with lengths 1..2080 at 1 and the
   default splits, the 576/512 latent view over a linear cache, qv at 64 +
   128 over a linear cache in fp16, qv at 128 + 128 over pages of 16, b=32
   x 8192): every form each kernel is compiled for. Each decode case gives
   the same bits twice, and at one split B8p's bits over the same step as a
   one-row chunk. The serving chunk and three decode shapes (the serving
   step, lengths 1..2080, b=32 x 8192) are timed beside their bounds and an
   SDPA yardstick over a pre-gathered linear cache (q || qv against k || v,
   the gather untimed), with the key tiles of the busiest decode block
   against the mean;
11. serves DeepSeek-V3's 61-layer absorbed attention stack at full width
   (128 heads, 64-wide rope key + 512-wide latent, one KV head, pages of
   64, seeded bf16 tensors, no weights): 8 sequences of 2048-token prompts
   prefilled in 4 chunks of 512 through kv_cache_update +
   flash_attn_varlen_func(block_table=, qv=), then 32 decode steps through
   flash_attn_with_kvcache(k=, v=, qv=, block_table=), each step's 61
   layers replayed as one CUDA graph and then run eagerly (the outputs
   bitwise equal); requires 244 B8p
   and 1,952 MLA decode launches and nothing else, finite outputs, and one
   layer's last decode step run again as a 1-token chunk through B8p in
   agreement with it; prints prefill ms per layer-chunk, decode step ms,
   tokens/s, peak memory and a profiler split of one layer-chunk and of
   one decode step;
12. drives block-sparse attention (B10), which no model path calls,
   through its public functions at the 913M GPT's attention widths (16
   heads of 128, bf16): the full causal block mask, a causal local window
   of 4 tiles plus tile 0 (also at b=1 x 8192) and a seeded 50% random mask
   with an empty row (tiles of 128, 128 and 512; b=4 x 2048), all on the
   wgmma/TMA tiles of fwd_sm90.cuh and bwd_sm90.cuh. Each runs
   flash_attention_blocksparse(...).backward() once as the counted path
   (1 forward, 1 preprocess, 1 dK/dV, 1 dQ launch), then holds the forward
   and backward kernels to the 2x rule against their plain versions and
   the backward's preprocess (delta, lse in base 2, the inverse lists) to
   its plain version, requires the backward bitwise over two runs and, on
   the full causal mask, out and lse bitwise equal to B7's over the same
   rows packed as 4 sequences and the gradients bitwise equal to B6's
   backward over the same rows, and times them beside their bounds and
   SDPA with the expanded boolean mask, with a profiler split of the
   backward's kernels and the torch ops around them;
13. runs the two H100 probes (B13): the dynamic shared memory a block can
   opt into (48 KB to 256 KB, the kernel's output against the plain
   version at each accepted size) and whether an mma.sync chain and an
   exp2 chain overlap in one block (us a step by trip-count slope);
14. model breadth: holds B1 (GQA 71/1 at d=64, 48/1 at d=128, non-causal
   at 197 tokens and d=64) and B4's linear route (groups 71 and 48) against
   their plain versions at the shapes the new families give them, timed
   beside their bounds and SDPA; then builds each family from its
   published config.json (numbers written out below) with a seeded
   checkpoint in the HF names loaded through the port's remap, and serves
   it as in 4. (graphed and eager, the teacher-forced check, the launch
   counts): Llama-3-8B at full width and depth, then 16 requests through
   the paged engine; Falcon-7B (parallel block, tied norm, MQA at group
   71), Pythia-6.9B (parallel block, untied norms, rotary on a quarter of
   each head), OPT-6.7B (learned positions; also through the prefix-cached
   engine, whose positions come from the prefix length) and StarCoder
   (learned positions, MQA at group 48) at full width and 4 layers; each
   freed before the next; then ViT-L/16 at full depth on 32 images (24 B1
   launches), its logits held to the 2x rule against the model run on the
   plain versions in fp32;
15. head dims 96 and 256: holds B1 (b=8 x 512, causal and not), B4 over
   a linear cache (static decode's lengths), over the engine's 16 slots of
   pages of 256 (and the verify step, sq = 5, at 96) and B8 (the prefix
   admission's shape) at GPT-NeoX-20B's 64 heads of 96 and GPT-J-6B's 16
   heads of 256 against their plain versions, timed beside their bounds
   and SDPA; then builds GPT-NeoX-20B (22 of 44 layers) and GPT-J-6B (all
   28) at full width from their config.json numbers with seeded HF
   checkpoints remapped a
   layer at a time (the peak printed), serves each as Llama-3-8B (graphed
   and eager, the teacher-forced check), then through the engines on 16
   slots (GPT-NeoX-20B the paged and the prefix-cached, GPT-J-6B the
   prefix-cached, each held to a teacher-forced static decode), and prints
   each decode step beside the time to read its weights once;
16. training at head dims 96 and 256: holds B3, B2 and the preprocess at
   GPT-NeoX-20B's 64 heads of 96 and GPT-J-6B's 16 of 256 (b=4 x 2048
   causal, b=2 x 1024 non-causal, 1000 rows over 1300 keys) against the
   plain fp32 backward (the 2x rule, references a batch row at a time), B3
   bitwise twice, B6's backward over the same rows packed bitwise equal to
   B3's and B6's forward and B7 to B1's, counts
   flash_attn_func(...).backward() both ways, times each kernel beside its
   bound, its plain version and SDPA (over nested tensors for the packed
   ones) and reads each kernel's registers and spills (cuobjdump
   -res-usage); runs the packed path at the training shape (B7, B6's
   forward, the backward, counted) and the packed MHA at each family's
   widths against the same module on the CPU (fp32, and bf16 for the 2x
   rule); then trains GPT-J-6B (8 of 28 layers) and GPT-NeoX-20B (4 of 44)
   at full width with Trainer.fit as in 5. (launches per step and layer,
   a falling loss, the fused-CE check) and prints their step time,
   tokens/s, TFLOP/s and peak memory.

17. the band masks (sliding window, chunked attention, sink tokens;
   utils/cases.py's BAND_* lists): B1's band instantiation on 10 shapes
   (Mistral-7B's prefill, b=2 x 6144 at 32/8 heads of 128 under a window
   of 4096; a window both ways at d=64; a window narrower than a tile; sq
   < sk; sq > sk causal and not, with rows that see no key; a chunk of
   1024; 4 sinks under a window of 1024; windows at d = 96 and 256), B4 on
   8 (Mistral-7B's static decode step at 6,208 keys with the default, 1
   and 8 splits, a verify step whose first split lies wholly below its
   later tokens' windows, a chunk; the engine's decode and verify steps
   over pages of 256; a chunk at the verify step over pages of 64) and B8
   at Mistral-7B's prefix-cached admission (8 x 512 rows over 5,120 keys,
   the window's edge inside the shared pages) against their plain versions
   (the 2x rule, lse, the same bits twice, each launch counted as the
   band's), each timed beside the band-free kernel at the same shape, SDPA
   with the band as a boolean mask and a bound that counts only the pairs
   inside the band;
18. Mistral-7B-v0.1 at full width and 16 of 32 layers from its config.json
   numbers (the Llama adapter plus window_size = (4095, 0), a seeded checkpoint
   remapped a layer at a time): static serving of b=2 x 6144 tokens to 64
   new ones (graphed and eager, bitwise equal tokens, the teacher-forced
   check, every attention launch the band's), the window in force (the
   same weights without it give last-position logits that differ by more
   than the decode's own bf16 noise; both TTFTs printed), the paged engine
   (8 requests of 5120 tokens on 8 slots, 32 new each), the prefix-cached
   engine (prompts sharing 4608 tokens: admissions through B8 with the
   window) and the speculative engine with the target as its own draft,
   each held to a teacher-forced static decode or to the plain engine.
19. the band masks in training (utils/cases.py BAND_BWD_CASES): B3's and
   B2's band instantiations and the preprocess on 8 shapes (Mistral-7B's
   training shape, b=1 x 8192 at 32/8 heads of 128 under the window of
   4096; a chunk of 1024; 4 sinks under a window with sq < sk and a key
   count off the 64-key tile; a window both ways; sq > sk with rows that
   see no key; windows at d = 64, 96 and 256) against the plain fp32 band
   backward (the 2x rule), each launch counted as the band's, B3 bitwise
   twice, B6's band backward over the same rows packed bitwise B3's and
   B6's band forward and B7's bitwise B1's (no sinks: the varlen route
   takes none); at Mistral-7B's shape B3's gradients lie BAND_GAP times
   farther (L2) from the plain band-free backward's than from the plain
   band backward's (the window is in force),
   flash_attn_func(...).backward() is counted both ways and each
   band kernel is timed beside the band-free pair, its bound (the band's
   pairs), its plain version and SDPA with the band as a boolean mask; a
   window that reaches every key launches the band-free kernels with
   their bits; the band instantiations' registers;
20. the windowed MHA at Mistral-7B's widths (window BAND_MHA_WINDOW),
   unpacked and packed, forward and backward, against the same module on
   the CPU, every attention launch the band's;
21. Mistral-7B-v0.1 trained at full width (8 of 32 layers, the Llama
   adapter plus window_size = (4095, 0)) at b=1 x 8192 with Trainer.fit as
   in 5. (per step and layer one band forward, one preprocess, one band
   dK/dV and one band dQ launch, no band-free one; a falling loss, the
   fused-CE check) and a profiled step; prints the step time, tokens/s,
   TFLOP/s and peak memory;
22. softcap and ALiBi (utils/cases.py SCORE_*_CASES): B1's score
   instantiation (the cap alone at 50 and 30, ALiBi with (h,) and (b, h)
   slopes, causal and not, sq < sk, sq = sk and sq > sk, both together,
   both under a window, GQA, d 64, 96, 128 and 256, bf16 and fp16), B4
   with the cap and the slopes (linear and paged, sq = 1 and 5, one split
   and the default splits, GQA groups) and B8 with the cap against their
   plain versions (the 2x rule on out, lse within LSE_ATOL in JAX's
   last-key form, the same bits twice, each launch counted as the score
   map's), timed at Baichuan-13B's and the softcap GPT's serving shapes
   beside the kernel without the map, the plain version, a library call
   (SDPA with ALiBi as a float mask; compiled flex_attention with a tanh
   score_mod and a block mask of the lengths, over the gathered cache for
   the paged routes) and a bound that is the largest of the matmul's, the MUFU's (an ex2
   and, under a cap, a tanh a score at 16 a clock an SM) and the bytes'
   times;
23. Baichuan-13B-Base at full width and depth (40 layers, 5120 wide, 40
   heads of 128, ALiBi, 13.3B parameters) from a seeded checkpoint in HF's
   names through the port's adapter: static serving as in 4. (every launch
   the score map's), ALiBi in force (the logits without it differ by more
   than the decode's bf16 noise), the paged engine (16 requests on 16
   slots) and the speculative engine with the target as its own draft,
   each held to a teacher-forced decode; the prefix-cached engine must
   refuse it;
24. the 913M GPT with softcap 50 (Gemma-2's attn_logit_softcapping):
   static serving, the cap in force, the paged and the prefix-cached
   engine (B8 under the cap), each held to a teacher-forced decode;
25. softcap and ALiBi in training (utils/cases.py SCORE_BWD_CASES): B3's
   and B2's score instantiations and the preprocess on 9 shapes
   (Baichuan-13B's training shape, 2 x 4096 at 40 heads of 128 under causal
   ALiBi; the 913M's, 4 x 2048 under a cap of 50; the cap at GQA 32/8 with
   sq < sk; ALiBi (b, h) not causal with sq < sk; ALiBi (h,) causal with
   rows that see no key; both under a window; both at d = 64 in fp16 with
   a cap of 5, at 96 and at 256) against the plain fp32 score backward (the
   2x rule), each launch counted as the score map's, B3 bitwise twice, a
   requires_grad slopes tensor given exact zeros by flash_attn_func, B6's
   score backward over the same rows packed bitwise B3's and B6's and B7's
   score forwards bitwise B1's; at the two training shapes
   flash_attn_func(...).backward() is counted both ways and each score
   kernel is timed beside the pair without the map, a bound that reckons
   the MUFU, its plain version and a library call (SDPA with ALiBi as a
   float mask; compiled flex_attention forward and backward with a tanh
   score_mod, held to the plain gradients first); the score
   instantiations' registers;
26. packed input through an MHA with ALiBi at Baichuan-13B's widths (B6's
   score forward, as JAX routes ALiBi) and one with the cap at the 913M's
   (B7's), forward and backward (B6's score backward), against the same
   module on the CPU and the padded dense call on the card;
27. Baichuan-13B-Base trained at full width (8 of 40 layers, the Baichuan
   adapter: ALiBi, an untied head) at b=2 x 4096 with Trainer.fit as in 5.
   (per step and layer one score forward, one preprocess, one score dK/dV
   and one score dQ launch) and a profiled step;
28. the 913M GPT with softcap 50 trained as in 5., every attention launch
   the score map's, and a profiled step;
29. quantized KV caches (utils/cases.py KVQUANT_*): B11's conversion held
   bitwise (one key at d = 256 whose V row holds every e4m3 code but the
   two NaN codes, and every int8 code, through B4 and through B8's
   kv_dequant conversion), B4 over 1-byte caches (e4m3 and int8, linear,
   paged and the verify step at every head dim, a window, ALiBi) and B8
   with descales (every head dim, a window, softcap, a bf16 cache) against
   their plain versions with distinct per-(row, KV head) descales, timed at
   the 913M's steps beside the same kernels over a bf16 cache;
30. the 913M GPT served from an fp8 cache at kv_cache_scale 1.0 and 2.0:
   static decode graphed and eagerly (tokens bitwise equal, every decode
   launch over the 1-byte cache), its logits teacher-forced with the bf16
   cache's tokens within 0.15 of the bf16 cache's (JAX's own bound), the
   decode rate beside the bf16 cache's in turns; the paged, prefix-cached
   and speculative engines (the target as its own draft) on the first
   requests of the engine traces, held to a teacher-forced static decode
   over the fp8 cache and to the plain engine; and (in 14.) Llama-3-8B
   served from an fp8 cache with the weights of its bf16 run;
31. head dim 80 (utils/cases.py HD80_*): B1 (with ALiBi at BTLM-3B-8K's
   prefill and softmax scale 1/80, without the map at a GQA shape, under
   the band), B4 (linear, paged and the verify step under ALiBi at BTLM's
   steps, the band, 1-byte caches with descales) and B8 (plain, a window,
   the cap, descales over 1-byte pages) at 80 against their plain
   versions, timed at BTLM's shapes; then flash_attn_varlen_func(
   block_table=) and flash_attn_with_kvcache over an fp8 page pool, which
   no model path at 80 reaches, counted once each at BTLM's shapes;
32. BTLM-3B-8K (cerebras/btlm-3b-8k-base config.json: 32 heads of 80,
   ALiBi, muP, SwiGLU, tied embeddings) at full width and depth from a
   seeded checkpoint through the BTLM adapter: static serving graphed and
   eager, ALiBi in force, the paged and the speculative engine as for
   Baichuan-13B in 23.; the prefix-cached engine refuses it (queue C);
   then trained at full width (BTLM_TRAIN_LAYERS of its 32 layers);
33. the learnable sink (run_gpt_oss_sinks): gpt-oss-20b's attention stack
   with seeded tensors at its published widths (24 layers of 64 query
   heads on 8 KV heads of 64, alternately a 128-key window and full
   causal, a trained sink logit a head and layer) through
   flash_attn_func(learnable_sink=) at 2 x 4,096 and packed through
   flash_attn_varlen_func, forward and backward, counted; B1, B3 and B2
   with the sink's gradient against the plain fp32 versions by the 2x
   rule, B3 bitwise twice; B7 = B6 = B1 and B6's backward = B3 bitwise
   under a sink; ALiBi with a sink through B6's forward; the prefix-cached
   admission through B8 (sliding, full, an fp8 pool with descales; B8 =
   B6 bitwise); B8p with a sink at DeepSeek-V3's serving chunk; rows that
   see no key at out 0 and lse = sink; each sink form timed beside its
   sink-free form, its plain version and SDPA with the sink as one more
   key;
34. q/k head dim 192 beside v head dim 128 (run_deepseek_v3_attention):
   DeepSeek-V3's attention trained without absorbing its MLA, seeded
   tensors at its published widths (61 layers of 128 heads, q and k 128 +
   64 rope columns, v 128, causal, its softmax scale 0.135234) through
   flash_attn_func at 1 x 4,096, forward and backward, counted (61 each of
   B1, the preprocess, dK/dV and dQ, all the 192 / 128 form) and finite,
   its peak printed; B1, B3, B2 and the preprocess at 192 / 128 on
   utils/cases.py DV_CASES (that layer, GQA, non-causal, sq < sk, sq > sk,
   a learnable sink, fp16) against the plain fp32 versions by the 2x rule,
   B3 bitwise twice; the counted deterministic=False call at the layer
   shape; flash_attn_func(qv=) at (64, 128) bitwise equal to the explicit
   concatenated call; each kernel timed at the layer shape beside the same
   kernels at d = dv = 128, the plain versions, SDPA and its bound.

It prints the card's name and power limit, one JSON line with the kernels'
launches, errors and times, and as its last line
{"ok": true, "device": {...}}. With --spec-readings N it builds the
kernels and then only serves N seeded prompt sets through the speculative
engine with the target as its own draft, printing each set's share of
examined proposals rejected (the readings behind SPEC_MISMATCH_READ). It needs a CUDA card and exits non-zero
without one, and when run outside a checkout of the repo.
"""

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

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
# The speculative engine: SPEC_K proposals a round over the first
# SPEC_REQUESTS prompts of the engine trace; a seeded draft of
# SPEC_DRAFT_LAYERS layers of the target's widths. With the target as its
# own draft the draft's decode (sq = 2 then 1, a linear cache) and the
# verify (sq = SPEC_K + 1, the paged cache) run other matmul shapes, so
# the two differ by bf16 rounding and a near-tie may reject a proposal.
# SPEC_MISMATCH_READ is the largest share of examined proposals so
# rejected over five seeded prompt sets (chip_smoke.py --spec-readings 5 on
# an H100 80GB HBM3 at 700 W: 0.0250, 0.0460, 0.0277, 0.0321, 0.0343);
# MIN_SELF_ACCEPTED (3.16 of 4) is what a round accepts on average when
# each proposal is rejected at twice that rate. A wrong cache offset or
# rewind rejects nearly every proposal.
SPEC_K, SPEC_REQUESTS, SPEC_DRAFT_LAYERS = 4, 32, 4
SPEC_MISMATCH_READ = 0.046
MIN_SELF_ACCEPTED = sum((1 - 2 * SPEC_MISMATCH_READ) ** i
                        for i in range(1, SPEC_K + 1))
# Where a speculative engine's greedy tokens part from the plain engine's,
# both tokens lie within TIE_STEPS bf16 steps (at the top logit's
# magnitude) of the top logit: a near-tie that the two engines' matmul
# shapes round apart. A verify step that kept a token other than the
# target's argmax would miss by the logits' own spread (~1).
TIE_STEPS = 4
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
    ("chunks that start mid-page", [130, 33, 1], [37, 90, 200], 128, 1,
     MLA_ROPE, MLA_LATENT, MLA_PAGE, torch.bfloat16, True),
]
MLA_DECODE_CASES = [  # (name, b, h, keys, d, dv, qv, page (0: linear),
    # num_splits (0: the default), dtype, the key its timing is kept under
    # (None: not timed)); every form of MLA_DECODE_DIMS. The first is the
    # serving phase's last step (every row at 2,048 + 32 keys), timed into
    # the kernels line; the second spreads the same batch over lengths
    # 1..2080, so that the splits of a row differ in length.
    ("qv, paged, serving step (8 x 2080 keys), default splits", 8, 128,
     [MLA_PROMPT + MLA_NEW] * MLA_BATCH, 64, 512, True, 64, 0,
     torch.bfloat16, "flash_decode_mla"),
    ("qv, paged, lengths 1..2080, default splits", 8, 128,
     np.linspace(1, 2080, 8).round().astype(int).tolist(), 64, 512, True,
     64, 0, torch.bfloat16, "lengths 1..2080"),
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
# Model breadth: each family's published config.json, its numbers written
# out here (no download), weights from a seed in the HF names, loaded
# through the port's remap. Llama-3-8B is served at full width and depth;
# the other four at full width and BREADTH_LAYERS layers (depth is what a
# smoke run can afford, widths are what the kernels see); ViT-L/16 at full
# depth.
LLAMA3_8B = SimpleNamespace(  # meta-llama/Meta-Llama-3-8B config.json
    vocab_size=128256, hidden_size=4096, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336,
    rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
    attention_bias=False, mlp_bias=False)
FALCON_7B = SimpleNamespace(  # tiiuae/falcon-7b config.json
    vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
    num_attention_heads=71, multi_query=True, parallel_attn=True,
    new_decoder_architecture=False, bias=False, alibi=False,
    layer_norm_epsilon=1e-5)
PYTHIA_6_9B = SimpleNamespace(  # EleutherAI/pythia-6.9b config.json
    vocab_size=50432, hidden_size=4096, num_hidden_layers=32,
    num_attention_heads=32, intermediate_size=16384, rotary_pct=0.25,
    rotary_emb_base=10000, use_parallel_residual=True, layer_norm_eps=1e-5,
    tie_word_embeddings=False)
OPT_6_7B = SimpleNamespace(  # facebook/opt-6.7b config.json
    vocab_size=50272, hidden_size=4096, num_hidden_layers=32,
    num_attention_heads=32, ffn_dim=16384, max_position_embeddings=2048,
    do_layer_norm_before=True, word_embed_proj_dim=4096)
STARCODER = SimpleNamespace(  # bigcode/starcoder config.json
    vocab_size=49152, n_embd=6144, n_layer=40, n_head=48, n_inner=24576,
    n_positions=8192, multi_query=True,
    activation_function="gelu_pytorch_tanh", layer_norm_epsilon=1e-5)
VIT_L16 = SimpleNamespace(  # google/vit-large-patch16-224 config.json
    image_size=224, patch_size=16, num_channels=3, hidden_size=1024,
    num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096,
    layer_norm_eps=1e-12)
VIT_CLASSES, VIT_BATCH = 1000, 32
BREADTH_LAYERS = 2
# The Llama-3-8B engine: BREADTH_REQUESTS prompts of ENGINE_PROMPT tokens
# on BREADTH_SLOTS slots (pages of ENGINE_PAGE), ENGINE_NEW new tokens each;
# OPT's prefix-cached engine: as many prompts sharing PREFIX_SHARED tokens.
BREADTH_SLOTS, BREADTH_REQUESTS = 16, 16
# B1 and B4 at the shapes the new families give them, each against its
# plain version: (name, (b, sq, sk, h, h_k, d, causal)) and (name, b, h,
# h_k, d) at static decode's lengths (PROMPT + 1 .. PROMPT + NEW_TOKENS
# keys, in a cache of 640 rows).
BREADTH_FWD_CASES = [
    ("flash_fwd_gqa71", (BATCH, PROMPT, PROMPT, 71, 1, 64, True)),
    ("flash_fwd_gqa48", (BATCH, PROMPT, PROMPT, 48, 1, 128, True)),
    ("flash_fwd_vit", (VIT_BATCH, 197, 197, 16, 16, 64, False)),
]
BREADTH_DEC_CASES = [
    ("flash_decode_group71", BATCH, 71, 1, 64),
    ("flash_decode_group48", BATCH, 48, 1, 128),
]
# Head dims 96 and 256, which B1, B8 and B4 (d = dv) take and the backward
# kernels do not yet: GPT-NeoX-20B and GPT-J-6B at full width from their
# published config.json numbers (GPT-NeoX-20B at SERVE_LAYERS of its 44
# layers, GPT-J-6B at its full depth), served as Llama-3-8B is
# (static, then BREADTH_REQUESTS requests on BREADTH_SLOTS slots: GPT-NeoX
# through the paged engine, GPT-J through the prefix-cached one, whose
# admissions run B8 at 256). The seeded GPT-J checkpoint's lm_head.bias is
# zeros: the port has no place for a nonzero one (models/hf_adapters.py).
NEOX_20B = SimpleNamespace(  # EleutherAI/gpt-neox-20b config.json
    vocab_size=50432, hidden_size=6144, num_hidden_layers=44,
    num_attention_heads=64, intermediate_size=24576, rotary_pct=0.25,
    rotary_emb_base=10000, use_parallel_residual=True, layer_norm_eps=1e-5,
    tie_word_embeddings=False)
GPTJ_6B = SimpleNamespace(  # EleutherAI/gpt-j-6b config.json
    vocab_size=50400, n_embd=4096, n_layer=28, n_head=16, rotary_dim=64,
    n_inner=None, n_positions=2048, layer_norm_epsilon=1e-5,
    activation_function="gelu_new")
# The kernels at the shapes the two families give them, each against its
# plain version and timed: (family, head dim, heads). B1 at the prefill
# (b=8 x 512, causal and not), B4 over a linear cache at static decode's
# lengths, over the engine's 16 slots of pages of 256 (and, at
# WIDE_VERIFY_D, a speculative verify step of sq = SPEC_K + 1), B8 at the
# prefix admission's shape of VARLEN_CASES.
WIDE_FAMILIES = [("GPT-NeoX-20B", 96, 64), ("GPT-J-6B", 256, 16)]
WIDE_VERIFY_D = 96
# Training at those head dims. The backward kernels (B3, B2 and their
# preprocess; B6's backward and the packed forwards B6 and B7 over the same
# rows packed) at each family's heads on WIDE_BWD_CASES (b, sq, sk,
# causal): the training shape first, then non-causal, then sq != sk with a
# key count that is not a multiple of the 64-key tile.
WIDE_BWD_CASES = [(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, True),
                  (2, 1024, 1024, False), (2, 1000, 1300, True)]
# Each family trained at full width from its config with the depth cut so
# that the trainer's state (bf16 weights and gradients, fp32 masters, bf16
# Adam moments: ~12 bytes a parameter, plus the update's fp32 transients)
# and the activations at b = 4 x 2048 (~2-3 GB a layer) fit 80 GB: GPT-J-6B
# at 8 of 28 layers (2.0B parameters), GPT-NeoX-20B at 4 of 44 (2.4B).
WIDE_TRAIN_LAYERS = {"GPT-J-6B": 4, "GPT-NeoX-20B": 4}
# The packed MHA at each family's widths on the card, against the same
# module on the CPU (plain versions; fp32, and bf16 for the 2x rule): ragged
# sequences whose key counts are not multiples of the 64-key tile.
WIDE_MHA_LENS = [200, 129, 183]
# Mistral-7B-v0.1 (mistralai/Mistral-7B-v0.1 config.json): Llama's shape
# with a sliding window of 4096 keys, served at full width and
# SERVE_LAYERS of its 32 layers
# through the port's Llama adapter with window_size = (4095, 0) set on its
# config (the JAX package's adapter reads no sliding_window either):
# static serving of MISTRAL_BATCH prompts of MISTRAL_PROMPT tokens (past
# the window) to MISTRAL_NEW new tokens; the paged engine with
# MISTRAL_SLOTS requests of MISTRAL_ENGINE_PROMPT tokens on as many slots
# (pages of ENGINE_PAGE, MISTRAL_ENGINE_NEW new tokens each: 5,152 of
# MISTRAL_ENGINE_MAX_LEN positions, the rest the decode block's margin);
# the prefix-cached engine with prompts sharing MISTRAL_PREFIX tokens.
MISTRAL_7B = SimpleNamespace(
    vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336,
    rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
    sliding_window=4096, max_position_embeddings=32768,
    attention_bias=False, mlp_bias=False)
MISTRAL_BATCH, MISTRAL_PROMPT, MISTRAL_NEW = 2, 6144, 64
MISTRAL_SLOTS, MISTRAL_ENGINE_PROMPT, MISTRAL_ENGINE_NEW = 8, 5120, 32
MISTRAL_PREFIX, MISTRAL_ENGINE_MAX_LEN = 4608, 5376
# The depth at which the serving phases run GPT-NeoX-20B (44 layers) and
# Mistral-7B (32), at full width: halved, then halved again when the head
# dim 80 serving phases came, and cut again when its training phases
# came, to keep the whole script near 900 s as it grows; every kernel and
# shape of those paths is the same at any depth, and each phase's launch
# checks count its layers.
SERVE_LAYERS = {"GPT-NeoX-20B": 6, "Mistral-7B": 4}
# The band in training: Mistral-7B-v0.1 (MISTRAL_7B) trained at full width
# through the Llama adapter with window_size = (4095, 0) and the depth cut
# to MISTRAL_TRAIN_LAYERS of 32 (2.0B parameters, as GPT-J-6B's 8 of 28),
# at MISTRAL_TRAIN_BATCH x MISTRAL_TRAIN_SEQ: the tokens of the repo's
# 4 x 2048 step in one sequence, long enough for the window to mask (it
# keeps 0.750 of the causal pairs).
MISTRAL_TRAIN_LAYERS, MISTRAL_TRAIN_BATCH, MISTRAL_TRAIN_SEQ = 4, 1, 8192
# The windowed MHA at Mistral-7B's widths (4096 wide, 32/8 heads of 128,
# rotary over the whole head) on the card against the same module on the
# CPU: a window of BAND_MHA_WINDOW keys over BAND_MHA_LENS packed and
# BAND_MHA_BATCH rows of their longest unpacked, so that the band bites at
# lengths the CPU reference runs in seconds.
BAND_MHA_WINDOW, BAND_MHA_LENS, BAND_MHA_BATCH = (127, 0), [300, 129, 183], 2
# The band backward's gradients at Mistral-7B's training shape against the
# plain band-free backward's must differ by this many times their
# difference from the plain band backward's, both in the L2 norm over all
# of dq, dk and dv: the window is in force. (The max-abs ratio depends on
# the draw: 17x and 7.5x in two runs on different seeds; the L2 norm sums
# the window's systematic change against the rounding's noise.)
BAND_GAP = 4.0
# remat: the 913M GPT's training step at b=4 x 2048 without remat and with
# GPTConfig(remat=True) under each policy, REMAT_STEPS steps each over the
# same batches (the step time is the median of all but the first).
REMAT_STEPS = 4


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS) -> dict:
    """The least time the card could take for work of ``flops`` operations
    (at ``peak_flops``, the tensor cores' bf16 rate unless given) over
    ``nbytes`` of device memory traffic, and which of the two binds."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attended_pairs(lens_q, lens_k, causal: bool, window=(None, None)) -> int:
    """(query row, key) pairs that attention computes for these lengths,
    bottom-right causal when ``causal``, inside ``window`` when given."""
    total = 0
    for lq, lk in zip(lens_q, lens_k):
        if window != (None, None):
            total += int(band_mask(lq, lk, causal, window).sum())
        elif causal:
            total += int(np.clip(np.arange(lq) + lk - lq + 1, 0, lk).sum())
        else:
            total += lq * lk
    return total


def band_mask(sq: int, sk: int, causal: bool, window=(None, None),
              sink: int = 0, chunk: int = 0, chunk_upper: bool = True,
              shift=None):
    """(sq, sk) bool on the card: the pairs inside the causal bound and
    the band (dispatch/band.py's semantics), bottom-right aligned (shift sk
    - sq) unless ``shift`` is given."""
    from flash_attn_tpu_torch.dispatch.band import band_valid

    rows = torch.arange(sq, device="cuda")[:, None]
    cols = torch.arange(sk, device="cuda")[None, :]
    return band_valid(rows, cols, sk - sq if shift is None else shift,
                      causal, window, sink, chunk, chunk_upper)


def band_keys(lens_q, lens_k, causal: bool, window=(None, None)) -> int:
    """Keys that some query row of each sequence sees: what a kernel that
    skips the rest must read."""
    return sum(int(band_mask(lq, lk, causal, window).any(0).sum())
               if window != (None, None) else lk
               for lq, lk in zip(lens_q, lens_k))


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


def blocksparse_full_mask(s: int, causal: bool):
    """B10's lists (on the card) over the full block mask of s rows and keys
    at tiles of 128 (causal: every tile that reaches the diagonal), and the
    tile sizes."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs

    bq, bk = bs.effective_tiles(s, s, 128, 128)
    i = torch.arange(-(-s // bq))[:, None]
    j = torch.arange(s // bk)[None, :]
    mask = j * bk <= i * bq + bq - 1 if causal else (i >= 0) & (j >= 0)
    num, idx = (x.cuda() for x in bs.blockmask_to_kv_indices(mask))
    return num, idx, dict(causal=causal, block_q=bq, block_k=bk)


def blocksparse_full_mask_forward(qt, kt, vt, causal):
    """B10 over the full block mask on B1's (b, h, s, d) views with sq = sk
    and h = h_k: it walks fwd_sm90.cuh's tile over B1's band in B1's order.
    Returns (out (b, h, s, d), lse (b, h, s)), as B1 does."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs

    num, idx, kw = blocksparse_full_mask(qt.shape[2], causal)
    return bs.flash_attention_blocksparse_fwd(qt, kt, vt, num, idx, **kw)


def blocksparse_full_mask_backward(qt, kt, vt, dot, out, lse, causal):
    """B10's backward over the full block mask on B3's (b, h, s, d) views
    with sq = sk and h = h_k: its dK/dV and dQ kernels walk bwd_sm90.cuh's
    tiles over B3's band in B3's order. Returns the fp32 (dq, dk, dv)."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs

    num, idx, kw = blocksparse_full_mask(qt.shape[2], causal)
    return bs.flash_attention_blocksparse_bwd(dot, qt, kt, vt, out, lse, num,
                                              idx, **kw)


def packed_b6_backward(dot, qt, kt, vt, out, lse, causal, **band):
    """B6's backward as a function of the (b, h, s, d) views that B3 takes:
    the same rows packed as b sequences, under ``band`` (window_size,
    attention_chunk) when given. Returns a function giving (dq, dk, dv) in
    B3's (b, h, s, d) layout."""
    from flash_attn_tpu_torch.kernels import flash_varlen

    b, h, sq, d = qt.shape
    sk = kt.shape[2]
    cu_q, cu_k = (torch.arange(b + 1, dtype=torch.int32, device="cuda") * n
                  for n in (sq, sk))
    packed = [x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
              for x in (dot, qt, kt, vt, out)]
    lse_p = lse.permute(1, 0, 2).reshape(h, b * sq)

    def run():
        g = flash_varlen.flash_attention_varlen_bwd(
            *packed, lse_p, cu_q, cu_k, sq, sk, causal=causal, **band)
        return [x.reshape(b, -1, x.shape[1], d).transpose(1, 2) for x in g]
    return run


def packed_b7_forward(q, k, v, causal):
    """B7 as a function of (b, s, h, d) q, k, v with sq = sk: the same rows
    packed as b sequences, with its work list built beforehand. Returns a
    function giving (out (b, h, s, d), lse (b, h, s)), as B1 does."""
    from flash_attn_tpu_torch import get_scheduler_metadata
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp

    b, s, h, d = q.shape
    cu = torch.arange(b + 1, dtype=torch.int32, device=q.device) * s
    packed = [x.reshape(b * s, x.shape[2], d) for x in (q, k, v)]
    meta = get_scheduler_metadata(b, s, s, h, k.shape[2], d, cu_seqlens_q=cu,
                                  cu_seqlens_k=cu, causal=causal).meta

    def run():
        out, lse = fvp.flash_attention_varlen_fwd_persistent(
            *packed, cu, cu, s, s, causal=causal, meta=meta)
        return (out.reshape(b, s, h, d).transpose(1, 2),
                lse.reshape(h, b, s).transpose(0, 1))
    return run


def fwd_case(gen, case):
    """B1 on one (b, sq, sk, h, h_k, d, causal) case against its plain
    version (the 2x rule against the fp32 plain version with a bf16
    reference, lse within LSE_ATOL, the same bits twice). Returns the
    (b, h, s, d) views of q, k, v, out, lse and the error."""
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
    )

    b, sq, sk, h, h_k, d, causal = case

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    # bshd tensors seen as (b, h, s, d) views, as the model passes them
    q, k, v = randn(b, sq, h, d), randn(b, sk, h_k, d), randn(b, sk, h_k, d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal)
    again = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal)
    ref, ref_lse = flash_fwd.flash_attention_fwd_plain(
        qt.float(), kt.float(), vt.float(), causal=causal)
    ref_lp, _ = attention_ref(q, k, v, causal=causal, upcast=False)
    torch.cuda.synchronize()
    err, err_lp = check_against_ref(
        out.transpose(1, 2), ref.transpose(1, 2), ref_lp,
        msg=f"flash_fwd {case}")
    lse_err = (lse - ref_lse).abs().max().item()
    require(lse_err <= LSE_ATOL, f"lse error {lse_err}")
    require(torch.equal(again[0], out) and torch.equal(again[1], lse),
            f"flash_fwd {case}: two runs differ")
    print(f"flash_fwd b={b} sq={sq} sk={sk} h={h} h_k={h_k} d={d} "
          f"causal={causal}: out max abs err {err:.3e} (bf16 reference "
          f"{err_lp:.3e}), lse max abs err {lse_err:.3e}, bitwise equal "
          f"over two runs")
    return (qt, kt, vt), out, lse, err


def fwd_timing(qt, kt, vt, case, what: str):
    """B1's, its plain version's and SDPA's times at one case (with GQA
    through SDPA's enable_gqa) beside its bound."""
    from flash_attn_tpu_torch.kernels import flash_fwd

    b, sq, sk, h, h_k, d, causal = case
    ms = time_ms(lambda: flash_fwd.flash_attention_fwd(
        qt, kt, vt, causal=causal))
    plain_ms = time_ms(lambda: flash_fwd.flash_attention_fwd_plain(
        qt, kt, vt, causal=causal), runs=10)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=h != h_k))
    pairs = b * attended_pairs([sq], [sk], causal)
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "library_call": f"scaled_dot_product_attention(is_causal="
                              f"{causal}{', enable_gqa=True' * (h != h_k)})",
              **bound(4 * h * d * pairs,
                      2 * (2 * b * sq * h * d + 2 * b * sk * h_k * d)
                      + 4 * b * h * sq)}
    print(f"flash_fwd time at {what} (b={b} x {sq}, {h}/{h_k} heads of {d}, "
          f"causal={causal}): kernel {ms:.4f} ms "
          f"({4 * h * d * pairs / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms "
          f"(median of 25); bound {timing['bound_ms']:.4f} ms "
          f"({timing['bound_by']})")
    return timing


def check_fwd(gen):
    """B1 against its plain version on FWD_CASES (fwd_case); times it at
    the prefill's shape (the first case) and the training shape (the last)
    beside its bound, the plain version and SDPA, and at both requires B10
    over the full block mask to give B1's out and lse bitwise (the same
    tile over the same band in the same order). Returns the worst error and
    the prefill shape's timing, with the training shape's under
    "training_shape"."""
    worst, timings = 0.0, []
    for ci, case in enumerate(FWD_CASES):
        (qt, kt, vt), out, lse, err = fwd_case(gen, case)
        worst = max(worst, err)
        if ci not in (0, len(FWD_CASES) - 1):
            continue
        causal = case[-1]
        bs_out, bs_lse = blocksparse_full_mask_forward(qt, kt, vt, causal)
        require(torch.equal(bs_out, out) and torch.equal(bs_lse, lse),
                f"B10 over the full causal block mask differs from B1: "
                f"{case}")
        del bs_out, bs_lse
        timings.append(fwd_timing(
            qt, kt, vt, case,
            "the prefill shape" if ci == 0 else "the training shape"))
        print("B10 over the full causal block mask: out and lse bitwise "
              "equal to B1's")
    return worst, {**timings[0], "training_shape": timings[1]}


def decode_case(gen, b, h, h_k, d, s_max, splits, lens):
    """B4's d = dv route over a linear cache against its plain version (the
    2x rule, lse within LSE_ATOL) at lengths ``lens`` = (first, last),
    spread over the rows; ``splits`` 0 takes the split count that
    flash_attn_with_kvcache picks. Returns the inputs, the key mask, the
    split count and the error."""
    from flash_attn_tpu_torch.cache.kvcache import _default_num_splits
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
    )

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    q = randn(b, 1, h, d)
    kc, vc = randn(b, h_k, s_max, d), randn(b, h_k, s_max, d)
    seqlens = torch.linspace(*lens, b, device="cuda").round().to(torch.int32)
    splits = splits or _default_num_splits(q, kc, vc, None, False)
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
    print(f"flash_decode b={b} h={h} h_k={h_k} d={d} s_max={s_max} "
          f"num_splits={splits} seqlens {lens[0]}..{lens[1]}: out max abs err "
          f"{err:.3e} (bf16 reference {err_lp:.3e}), lse max abs err "
          f"{lse_err:.3e}")
    return (q, kc, vc, seqlens), keep, splits, err


def decode_timing(q, kc, vc, seqlens, keep, splits, what: str):
    """B4's partials, their plain version's and masked SDPA's times (with
    GQA through SDPA's enable_gqa) beside the bound."""
    from flash_attn_tpu_torch.dispatch.config import DECODE_BLOCK_K
    from flash_attn_tpu_torch.kernels import flash_decode

    b, _, h, d = q.shape
    h_k = kc.shape[1]
    scale = d ** -0.5
    ms = time_ms(lambda: flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, True))
    plain_ms = time_ms(
        lambda: flash_decode.flash_attention_decode_partials_plain(
            q, kc, vc, seqlens, splits, DECODE_BLOCK_K, scale, True))
    qh, mask = q.transpose(1, 2), keep[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kc, vc, attn_mask=mask, enable_gqa=h != h_k))
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "library_call": "scaled_dot_product_attention with a boolean "
                              "length mask over the linear cache"
                              + ", enable_gqa=True" * (h != h_k),
              **decode_bound(seqlens, b, h, h_k, d, splits, 0)}
    cluster, busiest, mean = decode_block_tiles(seqlens, h_k, splits)
    print(f"flash_decode time at {what} (b={b}, {h}/{h_k} heads of {d}, "
          f"{splits} splits): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms (median of 25); "
          f"bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}); "
          f"clusters of {cluster} blocks, the busiest block {busiest} key "
          f"tiles, the mean {mean:.2f}")
    return timing


def check_decode(gen):
    """B4's linear route on DEC_CASES (decode_case), timed at the decode
    shape (the first)."""
    worst, timing = 0.0, None
    for b, h, h_k, d, s_max, splits in DEC_CASES:
        inputs, keep, splits, err = decode_case(gen, b, h, h_k, d, s_max,
                                                splits, (1, 600))
        worst = max(worst, err)
        if timing is None:
            timing = decode_timing(*inputs, keep, splits, "the decode shape")
    return worst, timing


def decode_block_tiles(seqlens, h_k, splits):
    """The d = dv decode route's cluster size and its blocks' 64-key tiles
    (the busiest block's, the mean over blocks) for these lengths: each
    split's contiguous run of tiles (the wrapper's _split_bounds) dealt out
    in contiguous shares to a cluster's blocks."""
    from flash_attn_tpu_torch.dispatch.config import (
        DECODE_BLOCK_K,
        decode_cluster,
        num_sms,
    )

    b = seqlens.numel()
    cluster = decode_cluster(b * h_k * splits, num_sms(0))
    shares = []
    for n in seqlens.tolist():
        tiles = -(-n // DECODE_BLOCK_K)
        kps = -(-tiles // splits)
        for sp in range(splits):
            t = max(0, min(tiles, (sp + 1) * kps) - sp * kps)
            per = -(-t // cluster)
            shares += [max(0, min(t - c * per, per)) for c in range(cluster)]
    return cluster, max(shares), sum(shares) / len(shares)


def decode_bound(seqlens, b, h, h_k, d, splits, table_entries, sq=1):
    """Bound of one decode call of sq query rows a sequence (bf16, causal
    bottom-right: row t of a sequence of n keys sees n - sq + 1 + t): every
    cached K and V row read once, q read, the fp32 split partials and the
    lengths (and the block table) read or written once."""
    keys = int(seqlens.sum())
    pairs = sq * keys - b * sq * (sq - 1) // 2
    return bound(4 * h * d * pairs,
                 2 * 2 * keys * h_k * d + 2 * b * sq * h * d
                 + 4 * splits * b * sq * h * (d + 1)
                 + 4 * (b + table_entries))


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
            gathered, sdpa_only = paged_sdpa(q, kp, vp, table, seqlens)
            lib_ms, sdpa_ms = time_ms(gathered), time_ms(sdpa_only)
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "library_call": "the cache gathered through the block "
                                      "table to the linear layout, then "
                                      "scaled_dot_product_attention with a "
                                      "boolean length mask (the gather "
                                      "included)",
                      "library_sdpa_only_ms": sdpa_ms,
                      **decode_bound(seqlens, b, h, h_k, d, splits,
                                     table.numel())}
            cluster, busiest, mean = decode_block_tiles(seqlens, h_k, splits)
            print(f"flash_decode_paged time at the engine's decode shape: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, gather + "
                  f"masked scaled_dot_product_attention {lib_ms:.4f} ms "
                  f"({sdpa_ms:.4f} ms without the gather; median of 25); "
                  f"bound {timing['bound_ms']:.4f} ms "
                  f"({timing['bound_by']}); clusters of {cluster} blocks, the "
                  f"busiest block {busiest} key tiles, the mean {mean:.2f}")
    return worst, timing


def check_decode_verify(gen):
    """The paged decode kernel at a speculative round's verify step (sq =
    SPEC_K + 1, causal bottom-right over the appended rows) against its
    plain version (paged_decode_case): the speculative engine's shape (64
    slots, 16 heads of 128, pages of 256, contexts of the engine trace
    after an append, the split count the engine takes) and GQA 16/4 over
    pages of 64 at 3 splits ((k + 1) x 4 = 20 rows, three 8-row blocks a
    KV head). The first is timed."""
    worst, timing = 0.0, None
    for b, h, h_k, page, splits in ((ENGINE_SLOTS, 16, 16, ENGINE_PAGE, 0),
                                    (16, 16, 4, 64, 3)):
        err, t = paged_decode_case(gen, b, h, h_k, 128, page, SPEC_K + 1,
                                   "the verify step", splits,
                                   timed=timing is None)
        worst, timing = max(worst, err), timing or t
    return worst, timing


def varlen_paged_case(gen, case, with_b6: bool = True, timed: bool = False,
                      window=(None, None), softcap: float = 0.0):
    """B8 on one case of VARLEN_CASES' form against its plain version (the
    2x rule, lse within LSE_ATOL), bitwise equal over two runs and, where
    B6 takes the head dim (``with_b6``), to B6's forward over the same rows
    packed (the two run one tile); with ``timed``, its whole call and, by
    the profiler, its kernel alone beside the bound and the plain version.
    With a ``window`` the band instantiation must run (its launch counted),
    the bound counts the pairs inside the window, and the band-free kernel
    is timed at the same shape. With ``softcap`` the score instantiation
    runs, the bound reckons the MUFU (an ex2 and a tanh a score), the
    kernel without the cap is timed, and the library call is compiled
    flex_attention with a tanh score_mod over the same padding and gather.
    Returns the error and the timing (None untimed)."""
    from flash_attn_tpu_torch.kernels import flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.utils.testing import (
        attention_varlen_paged_ref,
        check_against_ref,
        paged_to_linear,
    )

    name, lens_q, lens_k, used, h, h_k, d, page, dtype, causal = case
    b = len(lens_q)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                      dtype=torch.int32, device="cuda")
    q = torch.randn(int(cu[-1]), h, d, device="cuda", generator=gen).to(dtype)
    kp, vp, table = paged_cache(gen, b, h_k, d, page, max(max(lens_k), 1),
                                dtype)
    seqlens_k = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    seqused = (None if used is None else
               torch.tensor(used, dtype=torch.int32, device="cuda"))
    max_q = max(max(lens_q), 1)
    args = (cu, max_q, seqlens_k, table)
    banded = window != (None, None)
    band_launches = fvp.launches_band
    sc = dict(softcap=softcap) if softcap else {}
    out, lse = fvp.flash_attention_varlen_paged_fwd(
        q, kp, vp, *args, seqused_q=seqused, causal=causal,
        window_size=window, **sc)
    ref, ref_lse = fvp.flash_attention_varlen_paged_fwd_plain(
        q.float(), kp.float(), vp.float(), *args, seqused_q=seqused,
        causal=causal, window_size=window, **sc)
    ref_lp = attention_varlen_paged_ref(
        q, kp, vp, cu, seqlens_k, table, seqused_q=seqused,
        causal=causal, upcast=False, window_size=window, **sc)
    torch.cuda.synchronize()
    desc = (f"{name}: lens_q {lens_q} lens_k {lens_k} seqused_q {used} "
            f"h={h} h_k={h_k} d={d} page={page} {str(dtype)[6:]} "
            f"causal={causal}" + (f" window {window}" if banded else "")
            + (f" softcap {softcap}" if softcap else ""))
    require(fvp.launches_band == band_launches + banded,
            f"flash_varlen_paged {desc}: the band instantiation ran "
            f"{fvp.launches_band - band_launches} times")
    err, err_lp = check_against_ref(out, ref, ref_lp,
                                    msg=f"flash_varlen_paged {desc}")
    fin = torch.isfinite(ref_lse)
    require(torch.equal(torch.isfinite(lse), fin),
            f"flash_varlen_paged {desc}: rows without keys differ")
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item() \
        if fin.any() else 0.0
    require(lse_err <= LSE_ATOL, f"varlen paged lse error {lse_err}")
    again = fvp.flash_attention_varlen_paged_fwd(
        q, kp, vp, *args, seqused_q=seqused, causal=causal,
        window_size=window, **sc)
    require(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
            f"flash_varlen_paged {desc}: two runs differ")
    if with_b6:
        k, v = (torch.cat([lin[s, :, :n].transpose(0, 1)
                           for s, n in enumerate(lens_k)]).contiguous()
                for lin in (paged_to_linear(x, table, seqlens_k)
                            for x in (kp, vp)))
        cu_k = torch.tensor(np.concatenate([[0], np.cumsum(lens_k)]),
                            dtype=torch.int32, device="cuda")
        b6 = flash_varlen.flash_attention_varlen_fwd(
            q, k, v, cu, cu_k, max_q, max(lens_k), seqused_q=seqused,
            causal=causal)
        require(torch.equal(out, b6[0]) and torch.equal(lse, b6[1]),
                f"flash_varlen_paged {desc}: differs from B6's forward over "
                "the same rows packed")
    print(f"flash_varlen_paged {desc}: out max abs err {err:.3e} "
          f"(low-precision reference {err_lp:.3e}), lse max abs err "
          f"{lse_err:.3e}; bitwise equal twice"
          + (" and to B6's forward over the same rows packed" if with_b6
             else ""))
    if not timed:
        return err, None
    call = lambda: fvp.flash_attention_varlen_paged_fwd(
        q, kp, vp, *args, seqused_q=seqused, causal=causal,
        window_size=window, **sc)
    ms = time_ms(call)
    kernel_ms = kernel_split_ms(call, ("varlen_paged_kernel",))
    plain_ms = time_ms(lambda: fvp.flash_attention_varlen_paged_fwd_plain(
        q, kp, vp, *args, seqused_q=seqused, causal=causal,
        window_size=window, **sc))
    # the yardstick: the packed rows padded to (b, max_q) and the cache
    # gathered (paged_sdpa), the output packed again; rows past seqused_q
    # attend as the others (their output is not read)
    seq = torch.repeat_interleave(torch.arange(b, device="cuda"),
                                  torch.tensor(lens_q, device="cuda"))
    pos = torch.arange(int(cu[-1]), device="cuda") - cu[seq].long()
    qpad = q.new_zeros(b, max_q, h, d)
    qpad[seq, pos] = q
    gathered, sdpa_only = paged_sdpa(qpad, kp, vp, table, seqlens_k, causal,
                                     lens_q, window)

    def packed_lib():
        qpad.zero_()
        qpad[seq, pos] = q
        return gathered().transpose(1, 2)[seq, pos]
    lib_ms, sdpa_ms = ((None, None) if softcap else
                       (time_ms(packed_lib), time_ms(sdpa_only)))
    shift = seqlens_k - torch.tensor(lens_q, dtype=torch.int32, device="cuda")

    def keep(bi, hi, qi, ki):
        inside = ki < seqlens_k[bi]
        if causal:
            inside = inside & (ki <= qi + shift[bi])
        if window[0] is not None:
            inside = inside & (ki >= qi + shift[bi] - window[0])
        if window[1] is not None:
            inside = inside & (ki <= qi + shift[bi] + window[1])
        return inside

    def flex_call():
        run = flex_softcap(softcap, keep, b, max_q, table.shape[1] * page)

        def call():
            qpad.zero_()
            qpad[seq, pos] = q
            return run(qpad.transpose(1, 2), *(
                paged_to_linear(x, table, seqlens_k) for x in (kp, vp))
            ).transpose(1, 2)[seq, pos]
        return call
    total_q = int(cu[-1])
    pairs = attended_pairs(used or lens_q, lens_k, causal, window)
    timing = {"ms": ms, "kernel_ms": kernel_ms["varlen_paged_kernel"],
              "wrapper_ops_ms": kernel_ms["other"],
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "library_sdpa_only_ms": sdpa_ms,
              "library_call": "the packed rows padded, the cache gathered "
                              "through the block table to the linear "
                              "layout, scaled_dot_product_attention with a "
                              "boolean causal length mask, the rows packed "
                              "again (the gather and the packing included)"
                              + (" and the window in the mask" if banded
                                 else ""),
              **score_bound(4 * h * d * pairs,
                            2 * 2 * total_q * h * d
                            + 2 * 2 * band_keys(used or lens_q, lens_k,
                                                causal, window) * h_k * d
                            + 4 * h * total_q,
                            h * pairs * (1 + (softcap > 0)))}
    if softcap:
        timing.update(flex_row(
            flex_call, ref, err_lp, "a block mask of the lengths, the causal "
            "bound and the window, the packed rows padded and the cache "
            "gathered through the block table (the gather and the packing "
            "included)"))
        timing["without_map_ms"] = time_ms(
            lambda: fvp.flash_attention_varlen_paged_fwd(
                q, kp, vp, *args, seqused_q=seqused, causal=causal,
                window_size=window))
    if banded:
        timing["band_free_ms"] = time_ms(
            lambda: fvp.flash_attention_varlen_paged_fwd(
                q, kp, vp, *args, seqused_q=seqused, causal=causal))
        print(f"flash_varlen_paged at {name} without the window (the "
              f"band-free kernel): {timing['band_free_ms']:.4f} ms")
    print(f"flash_varlen_paged time at {name} (h={h}, d={d}): the whole "
          f"call {ms:.4f} ms (median of 25), of which the kernel "
          f"{timing['kernel_ms']:.4f} ms and the wrapper's torch ops "
          f"{timing['wrapper_ops_ms']:.4f} ms (profiler, device time); "
          f"plain {plain_ms:.4f} ms; " + (
              f"without the cap {timing['without_map_ms']:.4f} ms, "
              + ("no library time" if timing["library_ms"] is None else
                 f"library {timing['library_ms']:.4f} ms") + " ("
              + timing["library_call"] + ")"
              if softcap else
              f"padding, gather and masked scaled_dot_product_attention "
              f"{lib_ms:.4f} ms (SDPA alone {sdpa_ms:.4f} ms)") + "; bound "
          f"{timing['bound_ms']:.4f} ms ({timing['bound_by']})")
    return err, timing


def check_varlen_paged(gen):
    """The packed-varlen prefill kernel over the paged cache (B8) on the
    cases of VARLEN_CASES (utils/cases.py) by varlen_paged_case; times the
    first, the prefix-cached admission's shape."""
    from flash_attn_tpu_torch.utils.cases import VARLEN_CASES

    worst, timing = 0.0, None
    for i, case in enumerate(VARLEN_CASES):
        err, t = varlen_paged_case(gen, case, timed=i == 0)
        worst, timing = max(worst, err), timing or t
    return worst, timing


def check_bwd(gen):
    """Both backward paths against the plain fp32 backward on every case
    (the 2x rule, with autograd through attention_ref in the inputs' type
    as the low-precision reference), and the preprocess kernel against its
    plain version; deterministic grads bitwise equal over two runs and to
    B6's backward over the same rows packed as b sequences (the two run the
    tiles of bwd_sm90.cuh). At the training shape: kernel, plain and library
    times beside the bounds, a profiler split of each path into its kernels
    and the torch ops around them, and B10's backward over the full causal
    block mask bitwise equal to B3's gradients once rounded to bf16."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
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
            if det:
                b3 = grads
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
        # B6 runs B3's tiles (bwd_sm90.cuh): the same rows packed as b
        # sequences give the same bits
        b6 = packed_b6_backward(dot, qt, kt, vt, out, lse, causal)()
        require(all(torch.equal(a, b_) for a, b_ in zip(b3, b6)),
                f"B6's backward over the same rows packed differs from "
                f"B3's: {case}")
        del b3, b6
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
        print(f"{case}: deterministic backward bitwise equal over two runs "
              f"and to B6's over the same rows packed; preprocess delta max "
              f"abs err {err:.3e}, lse2 within 1e-5")
        if timing is None:
            timing = time_bwd(qt, kt, vt, dot, out, lse, causal, case)
        del grads, again, ref, ref_lp, f32, out32, lse32
    return worst, timing


def time_bwd(qt, kt, vt, dot, out, lse, causal, case):
    """Times at the training shape: the preprocess, B3 and B2 beside their
    bounds, plain versions and one library call each; a profiler split of
    each path. Requires B10's backward over the full causal block mask,
    which walks B3's tiles over the same band, to give B3's gradients
    bitwise once rounded to the inputs' type."""
    from flash_attn_tpu_torch.kernels import flash_bwd

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
    if h == h_k:
        b3 = bwd(True)()
        b10 = blocksparse_full_mask_backward(qt, kt, vt, dot, out, lse,
                                             causal)
        require(all(torch.equal(g.to(w.dtype), w) for g, w in zip(b10, b3)),
                f"B10's backward over the full causal block mask differs "
                f"from B3's: {case}")
        print(f"B10's backward over the full causal block mask ({case}): "
              f"gradients bitwise equal to B3's once rounded to bf16")
        del b3, b10
    # 5 products (S, dV, dP, dQ, dK) over the attended pairs; q, k, v,
    # out, dout read and dq, dk, dv written once, lse read
    common = {"plain_ms": plain_ms, "library_ms": lib_ms,
              "library_call": "scaled_dot_product_attention(is_causal"
                              "=True) backward (torch.autograd.grad)",
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
              + f"; its kernels {t['kernels_device_ms']:.4f} ms")
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


def serve_static(model, ids, name: str, new_tokens: int = NEW_TOKENS,
                 band: bool = False, score: bool = False):
    """Serve ``ids`` (BATCH prompts of PROMPT tokens, or any (b, prompt)) to
    prompt + ``new_tokens`` through serving.generation.decode, with the
    decode step captured as a CUDA graph and then eagerly: each run
    launches n_layer B1 and n_layer x (new_tokens - 1) B4 (counts at 0 just
    before it; with ``band``, every launch that of the band masks, with
    ``score`` that of the score map: softcap or ALiBi), the
    tokens of both bitwise equal, the logits finite; then the decode steps'
    logits against one teacher-forced forward over the same tokens, taken
    at the decoded positions only (LOGIT_BOUND, MIN_ARGMAX_AGREEMENT).
    Returns the graphed run's launches and sequences and the largest
    logit difference of that check."""
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    n = model.config.n_layer
    batch, prompt = ids.shape
    gen_cfg = GenerationConfig(max_length=prompt + new_tokens)
    torch.cuda.synchronize()
    steps = new_tokens - 1
    want = dict(flash_fwd=n, flash_decode=n * steps)
    if band:
        want.update(flash_fwd_band=n, flash_decode_band=n * steps)
    if score:
        want.update(flash_fwd_score=n, flash_decode_score=n * steps)
    runs = {}
    for cg in (True, False):  # the captured decode step, then eagerly
        reset_kernel_counts()
        seqs, length, scores = decode(ids, model, gen_cfg, output_scores=True,
                                      cg=cg)
        torch.cuda.synchronize()
        launches = kernel_counts()
        runs[cg] = seqs, scores, launches
        print(f"{name} ({'graphed' if cg else 'eager'}): {n} layers; served "
              f"{batch} x {prompt}-token prompts to length {length}; "
              f"launches {launches}")
        require(launches == want_counts(**want),
                f"{name}: launch counts {launches}")
        require(length == prompt + new_tokens
                and seqs.shape == (batch, length)
                and torch.equal(seqs[:, :prompt], ids), f"{name}: sequences")
        require(bool(torch.isfinite(scores).all()),
                f"{name}: non-finite decode logits")
    seqs, scores, launches = runs[True]
    same_scores = torch.equal(scores, runs[False][1])
    print(f"{name}: graphed and eager tokens bitwise equal: "
          f"{torch.equal(seqs, runs[False][0])}; logits bitwise equal: "
          f"{same_scores} (max abs diff "
          f"{(scores - runs[False][1]).abs().max().item():.3e})")
    require(torch.equal(seqs, runs[False][0]),
            f"{name}: graphed and eager static decode tokens differ")
    del runs

    with torch.inference_mode():  # teacher-forced forward, same kernels
        hidden = model.forward_hidden(seqs[:, :-1])[:, prompt - 1:]
        tf = model.logits(hidden).transpose(0, 1)  # (new tokens, b, vocab)
    del hidden
    require(bool(torch.isfinite(tf).all()), f"{name}: non-finite forward "
            "logits")
    diff = (tf - scores).abs().max().item()
    agree = (tf.argmax(-1) == seqs[:, prompt:].T).float().mean().item()
    print(f"{name}: decode vs teacher-forced logits: max abs diff "
          f"{diff:.4f} (bound {LOGIT_BOUND}), argmax agreement {agree:.4f} "
          f"(bound {MIN_ARGMAX_AGREEMENT}; logit std {scores.std().item():.3f})")
    require(diff <= LOGIT_BOUND and agree >= MIN_ARGMAX_AGREEMENT,
            f"{name}: decode steps disagree with the teacher-forced forward")
    return launches, seqs, diff


def static_rates(model, ids, modes=(True, False, True, False),
                 runs: int = 3, new_tokens: int = NEW_TOKENS):
    """TTFT (the prefill token alone, median of 5) and the decode rate of
    the remaining ``new_tokens`` - 1 steps for each run in ``modes``
    (graphed or eager, in turns; median of ``runs`` whole calls less
    TTFT)."""
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    def served(max_length, cg=True):
        def fn():
            out = decode(ids, model, GenerationConfig(max_length=max_length),
                         cg=cg)
            torch.cuda.synchronize()
            return out
        return fn

    batch, prompt = ids.shape
    steps = new_tokens - 1
    ttft = wall_ms(served(prompt + 1), 5) / 1e3  # no decode step
    tok_s = {}
    for cg in modes:
        t_full = wall_ms(served(prompt + new_tokens, cg), runs) / 1e3
        tok_s.setdefault(cg, []).append(batch * steps / (t_full - ttft))
    return ttft, tok_s


def run_slice(gen):
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel, gpt_913m

    cfg = gpt_913m(max_decode_seqlen=PROMPT + NEW_TOKENS + 8)
    model = GPTLMHeadModel(cfg, device="cuda")
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(1))
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: {n_params / 1e6:.1f}M parameters")
    ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda",
                        generator=gen)
    launches, _, _ = serve_static(model, ids, "slice")
    ttft, tok_s = static_rates(model, ids)
    steps = NEW_TOKENS - 1
    print(f"static decode tokens/s at b={BATCH} ({steps} steps), in turns: "
          f"graphed {tok_s[True][0]:.1f}, {tok_s[True][1]:.1f}; eager "
          f"{tok_s[False][0]:.1f}, {tok_s[False][1]:.1f}")
    return launches, ttft, {"graphed": statistics.mean(tok_s[True]),
                            "eager": statistics.mean(tok_s[False])}


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
    kernels since the last reset_kernel_counts(), the band's, the score
    map's and the quantized cache's among them, and of the conversion of a
    quantized cache's pages (bwd_counts() has the dense backward's)."""
    from flash_attn_tpu_torch.kernels import (
        flash_blocksparse,
        flash_decode,
        flash_fwd,
        flash_paged_prefill,
        flash_varlen,
        flash_varlen_paged,
        flash_varlen_persistent,
        kv_dequant,
    )

    return {"flash_fwd": flash_fwd.launches,
            "flash_decode_kv8": flash_decode.launches_kv8,
            "flash_decode_paged_kv8": flash_decode.launches_paged_kv8,
            "flash_varlen_paged_descale": flash_varlen_paged.launches_descale,
            "kv_dequant": kv_dequant.launches,
            "flash_fwd_band": flash_fwd.launches_band,
            "flash_fwd_score": flash_fwd.launches_score,
            "flash_decode": flash_decode.launches,
            "flash_decode_band": flash_decode.launches_band,
            "flash_decode_score": flash_decode.launches_score,
            "flash_decode_paged": flash_decode.launches_paged,
            "flash_decode_paged_band": flash_decode.launches_paged_band,
            "flash_decode_paged_score": flash_decode.launches_paged_score,
            "flash_varlen_paged_band": flash_varlen_paged.launches_band,
            "flash_varlen_paged_score": flash_varlen_paged.launches_score,
            "flash_decode_mla": flash_decode.launches_mla,
            "flash_paged_prefill": flash_paged_prefill.launches,
            "flash_varlen_paged": flash_varlen_paged.launches,
            "flash_varlen_fwd": flash_varlen.launches_fwd,
            "flash_varlen_fwd_persistent": flash_varlen_persistent.launches,
            "fa_varlen_bwd_preprocess": flash_varlen.launches_preprocess,
            "fa_varlen_bwd_dkdv": flash_varlen.launches_dkdv,
            "fa_varlen_bwd_dq": flash_varlen.launches_dq,
            "flash_varlen_fwd_band": flash_varlen.launches_fwd_band,
            "flash_varlen_fwd_persistent_band":
                flash_varlen_persistent.launches_band,
            "fa_varlen_bwd_dkdv_band": flash_varlen.launches_dkdv_band,
            "fa_varlen_bwd_dq_band": flash_varlen.launches_dq_band,
            "flash_varlen_fwd_score": flash_varlen.launches_fwd_score,
            "flash_varlen_fwd_persistent_score":
                flash_varlen_persistent.launches_score,
            "fa_varlen_bwd_dkdv_score": flash_varlen.launches_dkdv_score,
            "fa_varlen_bwd_dq_score": flash_varlen.launches_dq_score,
            "flash_blocksparse_fwd": flash_blocksparse.launches_fwd,
            "fa_blocksparse_bwd_preprocess":
                flash_blocksparse.launches_preprocess,
            "fa_blocksparse_bwd_dkdv": flash_blocksparse.launches_dkdv,
            "fa_blocksparse_bwd_dq": flash_blocksparse.launches_dq}


def bwd_counts():
    """Launches of the dense forward and backward kernels since the last
    reset_kernel_counts(), the band and the score instantiations' among
    them."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd

    return {"flash_fwd": flash_fwd.launches,
            "flash_fwd_band": flash_fwd.launches_band,
            "flash_fwd_score": flash_fwd.launches_score,
            "flash_bwd_preprocess": flash_bwd.launches_preprocess,
            "fa_bwd_dkdv": flash_bwd.launches_dkdv,
            "fa_bwd_dq": flash_bwd.launches_dq,
            "flash_bwd_fused": flash_bwd.launches_fused,
            "fa_bwd_dkdv_band": flash_bwd.launches_dkdv_band,
            "fa_bwd_dq_band": flash_bwd.launches_dq_band,
            "flash_bwd_fused_band": flash_bwd.launches_fused_band,
            "fa_bwd_dkdv_score": flash_bwd.launches_dkdv_score,
            "fa_bwd_dq_score": flash_bwd.launches_dq_score,
            "flash_bwd_fused_score": flash_bwd.launches_fused_score}


# bwd_counts()' score instantiations' keys, 0 in a run without the map
NO_SCORE = {"flash_fwd_score": 0, "fa_bwd_dkdv_score": 0,
            "fa_bwd_dq_score": 0, "flash_bwd_fused_score": 0}


def reset_kernel_counts():
    from flash_attn_tpu_torch.kernels import reset_launch_counters

    reset_launch_counters()


def want_counts(**nonzero):
    """kernel_counts() as a run should leave them: ``nonzero`` and 0 for
    every other kernel."""
    return {**dict.fromkeys(kernel_counts(), 0), **nonzero}


def run_engine(model, prompts, prefix_cache: bool, card: str, cg: bool = True,
               draft=None, slots: int = ENGINE_SLOTS, name=None,
               max_len: int = ENGINE_MAX_LEN, new_tokens: int = ENGINE_NEW,
               admit_tokens: int = ENGINE_ARRIVAL * ENGINE_PROMPT,
               warm_prompt: int = ENGINE_PROMPT, band: bool = False,
               score: bool = False, kv8: bool = False):
    """Serve ``prompts`` through an InferenceEngine over the paged cache,
    submitted ENGINE_ARRIVAL at a time whenever the queue is empty (the
    closed-loop trace of bench.py:516-541), after warmup(), which captures
    the engine's decode program (with ``cg``; eagerly without). ``draft``
    (a model on a linear cache) makes every step a speculative round of
    SPEC_K proposals. The kernel counts are set to 0 just before the trace
    and read just after; returns them with the generated tokens and the
    measurements. ``slots`` is the engine's batch (its pool holds that many
    sequences of ``max_len`` positions); ``name`` heads its printed lines;
    each request asks ``new_tokens``, an admission takes up to
    ``admit_tokens`` padded tokens (warm-up prefills ENGINE_ARRIVAL rows
    of ``warm_prompt``); with ``band`` every attention launch must be that
    of the band masks, with ``score`` that of the score map (softcap or
    ALiBi), with ``kv8`` every decode launch over a 1-byte cache and every
    paged prefill with descales, after the conversion of its pages."""
    from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
    from flash_attn_tpu_torch.serving.generation import GenerationConfig

    cfg = model.config
    width = -(-max_len // ENGINE_PAGE)
    pool = PagePool(cfg.paged_kv_num_pages, ENGINE_PAGE, width, slots)
    eng = InferenceEngine(model, slots, GenerationConfig(top_k=1),
                          page_pool=pool, max_admit_tokens=admit_tokens,
                          decode_block_size=ENGINE_BLOCK,
                          prefix_cache=prefix_cache, draft_model=draft,
                          speculative_k=SPEC_K, cg=cg)
    t0 = time.perf_counter()
    eng.warmup(prefill_shapes=[(ENGINE_ARRIVAL, warm_prompt)])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    calls = {"prefill": 0, "decode_block": 0, "spec_round": 0}
    accepted = []  # per speculative round: accepted proposals of each slot

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            out = fn(*args)
            if name == "spec_round":
                accepted.append((out[1] - 1)[args[2]].cpu())
            return out
        return run

    eng._prefill = counted("prefill", eng._prefill)
    eng._decode_block_fn = counted("decode_block", eng._decode_block_fn)
    eng._spec_round = counted("spec_round", eng._spec_round)

    submit_t, first_t, ids = {}, {}, []
    total_tokens, nxt = 0, 0
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    while True:
        if nxt < len(prompts) and not eng.queue:
            for p in prompts[nxt:nxt + ENGINE_ARRIVAL]:
                rid = eng.submit(p, max_new_tokens=new_tokens)
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
    del eng._prefill, eng._decode_block_fn, eng._spec_round
    tokens = [eng.requests[r].generated for r in ids]
    ttfts = sorted(first_t[r] - submit_t[r] for r in ids)
    name = name or ("prefix-cache engine" if prefix_cache else
                    f"speculative engine (draft: {draft.config.n_layer} "
                    "layers)" if draft is not None else "paged engine")
    name += " (graphed)" if cg else " (eager)"
    print(f"{name}: {len(prompts)} requests, {calls['prefill']} admission "
          f"prefills, {calls['decode_block']} decode blocks of "
          f"{ENGINE_BLOCK}, {calls['spec_round']} speculative rounds of "
          f"{SPEC_K}; launches {launches}; stats {eng.stats()}")
    n = cfg.n_layer
    if draft is None:
        want = want_counts(
            flash_fwd=0 if prefix_cache else n * calls["prefill"],
            flash_decode_paged=n * ENGINE_BLOCK * calls["decode_block"],
            flash_varlen_paged=n * calls["prefill"] if prefix_cache else 0)
    else:
        nd = draft.config.n_layer
        want = want_counts(flash_fwd=(n + nd) * calls["prefill"],
                           flash_decode=nd * SPEC_K * calls["spec_round"],
                           flash_decode_paged=n * calls["spec_round"])
    for flag, suffix in ((band, "_band"), (score, "_score")):
        if flag:
            want.update({k + suffix: want[k] for k in (
                "flash_fwd", "flash_decode", "flash_decode_paged",
                "flash_varlen_paged")})
    if kv8:
        want.update(flash_decode_kv8=want["flash_decode"],
                    flash_decode_paged_kv8=want["flash_decode_paged"],
                    flash_varlen_paged_descale=want["flash_varlen_paged"],
                    kv_dequant=want["flash_varlen_paged"])
    require(launches == want, f"{name} launch counts {launches}, want {want}")
    require(all(len(t) == new_tokens for t in tokens),
            f"{name}: a request did not finish with {new_tokens} tokens")
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
    if draft is not None:
        acc = torch.cat(accepted).float()
        # a slot-round examines proposals up to its first rejection
        examined = float(torch.clamp(acc + 1, max=SPEC_K).sum())
        result.update(rounds=calls["spec_round"],
                      mean_accepted=acc.mean().item(),
                      full_accept_share=(acc == SPEC_K).float().mean().item(),
                      mismatch_rate=float((acc < SPEC_K).sum()) / examined)
        print(f"{name}: {calls['spec_round']} rounds, {acc.numel()} slot-"
              f"rounds, mean accepted proposals {result['mean_accepted']:.3f} "
              f"of {SPEC_K}, all {SPEC_K} accepted in "
              f"{result['full_accept_share']:.3f} of them; "
              f"{result['mismatch_rate']:.4f} of {examined:.0f} examined "
              f"proposals rejected")
    print(f"{name}: {total_tokens} tokens in {elapsed:.3f} s, "
          f"{result['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{result['ttft_p50_ms']:.1f} ms p99 {result['ttft_p99_ms']:.1f} ms "
          f"(warm-up {warm_s:.1f} s) on {card}")
    if not prefix_cache and draft is None:
        result.update(decode_block_idle(eng, prompts, card, slots))
    eng.close()
    return launches, tokens, result


def decode_block_idle(eng, prompts, card, slots: int = ENGINE_SLOTS):
    """Wall time and device time (the profiler's sum over its kernels) of
    one decode block with all ``slots`` busy (contexts of 512 + a few tokens),
    through the engine's own block (the graph's replay, or the eager
    block): the device's idle share of a block."""
    from torch.profiler import ProfilerActivity, profile

    eng.reset()
    eng.max_admit_tokens = None  # one admission of every slot
    for p in prompts[:slots]:
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
    require(attn_ms > 0, "the profiler saw no decode kernel in the block")
    idle = 1.0 - dev_ms / wall_ms
    mode = "graphed" if eng.cg else "eager"
    print(f"decode block of {ENGINE_BLOCK} steps at {slots} busy slots "
          f"({mode}): wall {wall_ms:.2f} ms, device {dev_ms:.2f} ms (paged "
          f"decode kernel {attn_ms:.2f} ms), device idle share {idle:.3f} on "
          f"{card}")
    return {"block_wall_ms": wall_ms, "block_device_ms": dev_ms,
            "block_attention_ms": attn_ms, "block_idle_share": idle}


def model_view(model, **fields):
    """The same weights (shared, not copied) in a model of ``model``'s
    config with ``fields`` replaced, built on the meta device so that no
    second set of weights is allocated."""
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel

    view = GPTLMHeadModel(dataclasses.replace(model.config, **fields),
                          device="meta")
    view.load_state_dict(model.state_dict(), assign=True)
    # the buffers outside the state dict (the ALiBi slopes) that the view
    # keeps too
    kept = dict(view.named_buffers())
    for name, buf in model.named_buffers():
        if name in kept:
            mod, _, attr = name.rpartition(".")
            setattr(view.get_submodule(mod), attr, buf)
    return view.requires_grad_(False)


def linear_view(model):
    """The same weights in a model on a linear cache."""
    return model_view(model, paged_kv_num_pages=0)


def paged_view(model, slots: int, max_len: int = ENGINE_MAX_LEN):
    """The same weights in a model over a page pool of ``slots`` sequences
    of ``max_len`` tokens in pages of ENGINE_PAGE (and the null page)."""
    width = -(-max_len // ENGINE_PAGE)
    return model_view(model, paged_kv_num_pages=slots * width + 1,
                      paged_kv_page_size=ENGINE_PAGE,
                      max_decode_seqlen=max_len)


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at magnitude |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def spec_vs_plain(model, prompts, spec, plain, name, tie_bound=None):
    """Hold a speculative engine's greedy tokens to the plain engine's:
    equal, or, from the first position where they part, both within
    TIE_STEPS bf16 steps of the top logit of one forward over the prompt
    and the tokens they share (a near-tie that the verify step's other
    matmul shapes round the other way in bf16); with ``tie_bound``, within
    that many logits of it instead (a deeper model's own measured bf16
    noise). Returns the share of requests with equal tokens."""
    equal, worst, worst_gap, worst_top = 0, 0.0, 0.0, 0.0
    for p, a, b in zip(prompts, spec, plain):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            equal += 1
            continue
        seq = torch.as_tensor(np.concatenate([p, a[:j]]), device="cuda",
                              dtype=torch.long)[None]
        with torch.inference_mode():
            logits = model(seq)[0, -1].float()
        top = float(logits.max())
        gap = max(top - float(logits[a[j]]), top - float(logits[b[j]]))
        if gap / bf16_step(top) >= worst:
            worst, worst_gap, worst_top = gap / bf16_step(top), gap, top
    share = equal / len(spec)
    print(f"{name} vs the plain greedy engine: {equal} of {len(spec)} "
          f"requests equal; where they part, the largest top-logit gap of "
          f"either token {worst:.1f} bf16 steps ({worst_gap:.4f} below a top "
          f"of {worst_top:.4f}; bound "
          + (f"{TIE_STEPS} steps)" if tie_bound is None else
             f"{tie_bound:.4f}, the model's decode noise)"))
    require(worst <= TIE_STEPS if tie_bound is None else
            worst_gap <= tie_bound,
            f"{name}: a token parts from the plain engine's beyond a tie")
    return share


def engine_agreement(model, prompts, tokens, name,
                     min_agreement: float = MIN_ENGINE_AGREEMENT):
    """Hold the engine's tokens against a teacher-forced static decode of
    the same prompts on the linear cache, in batches of 8: each token the
    argmax of the static decode's logits at >= ``min_agreement`` of the
    positions, and within LOGIT_BOUND of the top logit everywhere."""
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    lin = linear_view(model)
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
          f"{share:.4f} over {total} tokens (bound {min_agreement}); "
          f"largest top-logit gap of an engine token {gap:.4f} (bound "
          f"{LOGIT_BOUND})")
    require(share >= min_agreement and gap <= LOGIT_BOUND,
            f"{name}: tokens disagree with the teacher-forced decode")
    return share, gap


def run_engines(card):
    """The paged engine on bench.py's trace, then the prefix-cached engine
    over shared-prefix prompts, each with its decode block captured and
    then eagerly (the tokens bitwise equal), then the speculative engine
    (SPEC_K proposals a round) on the paged cache over the first
    SPEC_REQUESTS prompts of the trace, with the target as its own draft
    and with a seeded SPEC_DRAFT_LAYERS-layer draft of the same widths
    (also eagerly); returns the launch counts of each graphed run and the
    measurements."""
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel

    model = engine_model()
    vocab = model.config.vocab_size
    rng = np.random.default_rng(0)
    prompts = list(rng.integers(0, vocab, (ENGINE_REQUESTS, ENGINE_PROMPT),
                                dtype=np.int64))
    shared = rng.integers(0, vocab, PREFIX_SHARED, dtype=np.int64)
    px_prompts = [np.concatenate([shared, rng.integers(
        0, vocab, ENGINE_PROMPT - PREFIX_SHARED, dtype=np.int64)])
        for _ in range(PREFIX_REQUESTS)]
    out, launches, tokens = {}, {}, {}
    for name, trace, prefix in (("paged", prompts, False),
                                ("prefix_cache", px_prompts, True)):
        t0 = time.perf_counter()
        launches[name], tokens[name], out[name] = run_engine(
            model, trace, prefix, card)
        _, eager_tokens, out[name + "_eager"] = run_engine(
            model, trace, prefix, card, cg=False)
        require(eager_tokens == tokens[name],
                f"{name} engine: graphed and eager tokens differ")
        out[name]["agreement"], out[name]["logit_gap"] = engine_agreement(
            model, trace, tokens[name], f"{name} engine")
        print(f"{name} engine: graphed and eager tokens bitwise equal; phase "
              f"wall time {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    spec_prompts = prompts[:SPEC_REQUESTS]
    plain = tokens["paged"][:SPEC_REQUESTS]
    draft = GPTLMHeadModel(dataclasses.replace(
        model.config, n_layer=SPEC_DRAFT_LAYERS, paged_kv_num_pages=0),
        device="cuda")
    draft.reset_parameters(torch.Generator(device="cuda").manual_seed(3))
    draft.requires_grad_(False)
    for name, dm in (("speculative_self", linear_view(model)),
                     ("speculative_draft", draft)):
        launches[name], spec, out[name] = run_engine(
            model, spec_prompts, False, card, draft=dm)
        out[name]["equal_to_plain"] = spec_vs_plain(
            model, spec_prompts, spec, plain, name)
        if dm is draft:
            _, eager_spec, out[name + "_eager"] = run_engine(
                model, spec_prompts, False, card, cg=False, draft=dm)
            require(eager_spec == spec,
                    f"{name}: graphed and eager tokens differ")
        tokens[name] = spec
    require(out["speculative_self"]["mean_accepted"] >= MIN_SELF_ACCEPTED,
            "the target as its own draft: proposals rejected "
            f"({out['speculative_self']['mean_accepted']:.3f} accepted of "
            f"{SPEC_K} a round, bound {MIN_SELF_ACCEPTED:.3f})")
    print(f"speculative engines phase wall time "
          f"{time.perf_counter() - t0:.1f} s")
    del model, draft
    torch.cuda.empty_cache()
    return launches, out


def spec_readings(card, n: int) -> int:
    """The speculative engine with the target as its own draft over n
    seeded sets of SPEC_REQUESTS prompts (seeds 1..n; the default run's are
    the trace's, seed 0): prints each set's share of examined proposals
    rejected, the reading that SPEC_MISMATCH_READ is taken from."""
    model = engine_model()
    vocab = model.config.vocab_size
    rates = []
    for seed in range(1, n + 1):
        prompts = list(np.random.default_rng(seed).integers(
            0, vocab, (SPEC_REQUESTS, ENGINE_PROMPT), dtype=np.int64))
        _, _, res = run_engine(model, prompts, False, card,
                               draft=linear_view(model))
        rates.append(res["mismatch_rate"])
        print(f"prompt seed {seed}: mean accepted {res['mean_accepted']:.4f} "
              f"of {SPEC_K}, mismatch rate {res['mismatch_rate']:.4f}")
    print(json.dumps({"spec_mismatch_rates": rates, "card": card}))
    return 0


def write_token_file(path: str, vocab: int) -> None:
    import numpy as np

    period = np.random.default_rng(1).integers(0, vocab, DATA_PERIOD,
                                               dtype=np.uint16)
    n = DATA_WINDOWS * TRAIN_SEQ + 1
    np.resize(period, n).tofile(path)


def make_trainer(**overrides):
    from flash_attn_tpu_torch.models.gpt import gpt_913m
    from flash_attn_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = TrainConfig(**{**dict(
        model=gpt_913m(), batch_size=TRAIN_BATCH, seqlen=TRAIN_SEQ, lr=1e-3,
        warmup_steps=TRAIN_WARM, total_steps=100, opt_state_dtype="bfloat16",
        zero1=False, fused_ce=True, log_every=1), **overrides})
    return Trainer(cfg, device="cuda")


def make_loader(path: str, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ):
    from flash_attn_tpu_torch.training.data import (
        FaultTolerantSampler,
        LMDataLoader,
        TokenDataset,
    )

    ds = TokenDataset(path, seqlen=seq)
    return LMDataLoader(ds, batch, FaultTolerantSampler(len(ds), seed=0))


def fit_checked(label, mcfg, path, batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ, band: bool = False, score: bool = False):
    """Trainer.fit of the model of ``mcfg`` at batch x seq tokens a step
    (the repo's training shape, TRAIN_BATCH x TRAIN_SEQ, by default),
    TRAIN_STEPS steps over the token file at ``path``, with the checks of
    every training phase: per step and layer 1 forward, 1 preprocess, 1
    dK/dV and 1 dQ launch (with ``band``, every one of the forward's and
    the backward's that of the band instantiation, none band-free; with
    ``score``, every one that of the score instantiation); a
    finite loss near ln(vocab) that falls; the first step's fused-CE loss
    against torch's cross-entropy over the full fp32 logits of the same
    batch. Returns the launch counts, the measurements, the trainer and its
    loader."""
    from flash_attn_tpu_torch.training.trainer import model_flops_per_token

    trainer = make_trainer(model=mcfg, batch_size=batch, seqlen=seq)
    n_params = sum(p.numel() for p in trainer.model.parameters())

    # The first batch of the run, through torch's cross-entropy over the
    # full fp32 logits of a no-grad forward.
    inp, lab = next(iter(make_loader(path, batch, seq)))
    with torch.no_grad():
        logits = trainer.model(trainer._batch(inp))
        ce_ref = F.cross_entropy(logits.flatten(0, 1).float(),
                                 trainer._batch(lab).flatten()).item()
    del logits

    logs, per_step = [], []

    def log(metrics):  # called after every step (log_every=1)
        logs.append(metrics)
        per_step.append(bwd_counts())

    loader = make_loader(path, batch, seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    trainer.fit(loader, steps=TRAIN_STEPS, log_fn=log)
    torch.cuda.synchronize()
    launches = bwd_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: {n_params / 1e6:.1f}M parameters, {mcfg.n_layer} "
          f"layers, b={batch} x {seq}, {TRAIN_STEPS} steps of "
          f"Trainer.fit; launches {launches}")
    n = mcfg.n_layer
    for i, c in enumerate(per_step):
        m = n * (i + 1)
        want = {"flash_fwd": m, "flash_bwd_preprocess": m, "fa_bwd_dkdv": m,
                "fa_bwd_dq": m, "flash_bwd_fused": 0,
                "flash_fwd_band": m * band, "fa_bwd_dkdv_band": m * band,
                "fa_bwd_dq_band": m * band, "flash_bwd_fused_band": 0,
                "flash_fwd_score": m * score, "fa_bwd_dkdv_score": m * score,
                "fa_bwd_dq_score": m * score, "flash_bwd_fused_score": 0}
        require(c == want,
                f"{label}: launch counts after training step {i + 1}: {c}")
    require(len(per_step) == TRAIN_STEPS and launches == per_step[-1],
            f"{label}: training launch counts {launches}")
    losses = [m["loss"] for m in logs]
    norms = [m["grad_norm"] for m in logs]
    print(f"{label} losses " + " ".join(f"{x:.4f}" for x in losses))
    print(f"{label} grad norms " + " ".join(f"{x:.4f}" for x in norms))
    require(len(losses) == TRAIN_STEPS and all(
        math.isfinite(x) for x in losses + norms), f"{label}: non-finite loss")
    ln_v = math.log(mcfg.vocab_size)
    require(abs(losses[0] - ln_v) <= FIRST_LOSS_BAND,
            f"{label}: first loss {losses[0]} not within {FIRST_LOSS_BAND} "
            f"of ln(vocab) {ln_v:.4f}")
    tail = statistics.mean(losses[-3:])
    require(tail <= losses[0] - MIN_LOSS_DROP,
            f"{label}: loss did not fall: first {losses[0]}, last 3 {tail}")
    print(f"{label}: first-step loss {losses[0]:.4f} (ln vocab {ln_v:.4f}); "
          f"mean of the last 3 {tail:.4f}; torch cross-entropy over full fp32 "
          f"logits {ce_ref:.4f}")
    require(abs(losses[0] - ce_ref) <= CE_LOSS_ATOL,
            f"{label}: fused CE {losses[0]} vs full-logits CE {ce_ref}")
    step_s = statistics.median(batch * seq / m["tokens_per_s"]
                               for m in logs[TRAIN_WARM:])
    tok_s = batch * seq / step_s
    tflops = tok_s * model_flops_per_token(mcfg, seq) / 1e12
    return launches, {"params_b": n_params / 1e9, "layers": n,
                      "step_ms": step_s * 1e3, "tokens_per_s": tok_s,
                      "tflops_per_s": tflops, "peak_gb": peak_gb,
                      "first_loss": losses[0], "last3_loss": tail,
                      "ce_ref": ce_ref}, trainer, loader


def run_training():
    """Trainer.fit of the 913M GPT at the repo's training shape
    (fit_checked), a profile of one step, and two short runs from one
    seed; returns the launch counts of the fit and its measurements."""
    from flash_attn_tpu_torch.models.gpt import gpt_913m

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens.bin")
        mcfg = gpt_913m()
        write_token_file(path, mcfg.vocab_size)
        launches, res, trainer, loader = fit_checked("training", mcfg, path)
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
    return launches, {"step_ms": res["step_ms"],
                      "tokens_per_s": res["tokens_per_s"],
                      "tflops_per_s": res["tflops_per_s"],
                      "peak_gb": res["peak_gb"], "same_losses": same}


class ProfilerLost(RuntimeError):
    """torch.profiler traced no device activity where kernels ran."""


def device_events(fn, runs: int = 1, tries: int = 3):
    """The CUDA events (torch.profiler key averages with device time) of
    ``runs`` calls of fn(), after one warm-up call. The trace opens with one
    more call in the warm-up step of the profiler's schedule, whose events
    are dropped: a trace's first kernel can go missing (seen on the card,
    four launches of the first kernel traced in five calls). A trace that
    recorded no device activity at all (the profiler's CUDA tracing lost
    the window, seen late in long runs on the card) is taken again, up to
    ``tries`` times, then ProfilerLost is raised."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and getattr(e, "device_time_total", 0.0) > 0
                  and not e.key.startswith("ProfilerStep")]
        if events:
            return events
    raise ProfilerLost(f"chip_smoke: {tries} profiler traces recorded no "
                       f"device activity")


def device_families(fn, families, what: str) -> float:
    """Device time of fn() by kernel family (torch.profiler): prints each
    family's share and the 12 costliest kernels; returns the total ms, or
    NaN (printed as not measured) where the profiler traced no device
    activity."""
    totals = dict.fromkeys(list(families) + ["elementwise, reductions, other"], 0.0)
    kernels = []
    try:
        events = device_events(fn)
    except ProfilerLost as e:
        print(f"profile: {what}: not measured ({e})")
        return math.nan
    for evt in events:
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


def profile_step(trainer, loader, what: str = "one training step",
                 batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ):
    """Device time of one training step (batch x seq tokens) by kernel
    family (torch.profiler), and the phases of a step timed with CUDA
    events."""
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
        what)

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
          f"({mcfg.n_layer} layers, b={batch} x {seq})")


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


def entry_kernel(entry: str) -> str:
    """The kernel a C entry point of the kernels' library launches (each
    launches one): fa_bwd_dq -> dq_kernel, fa_varlen_bwd_dkdv ->
    varlen_dkdv_kernel, fa_blocksparse_bwd_dq -> bs_dq_kernel."""
    return (entry.removeprefix("fa_").replace("blocksparse_", "bs_")
            .replace("bwd_", "") + "_kernel")


def entry_split_ms(fn, names, runs: int = 10):
    """kernel_split_ms's split timed with CUDA events in place of the
    profiler: every C entry point of the kernels' library records an event
    pair around its call while a sleep kernel holds the stream and the
    ``runs`` calls are enqueued behind it, so that each pair brackets its
    launch on the device (the launch's own gap of a few microseconds
    included); "other" is the runs' whole span less the named kernels', a
    call. A batch whose enqueueing outlasted the sleep is taken again under
    a sleep twice as long. Fails unless each named kernel launched once a
    call."""
    from flash_attn_tpu_torch.kernels import _build

    lib = _build.load_library()
    originals = {e: getattr(lib, e) for e in _build.SIGNATURES}
    spans = []

    def timed(entry, launch):
        kernel = entry_kernel(entry)

        def call(*args):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            err = launch(*args)
            end.record()
            spans.append((kernel, start, end))
            return err
        return call

    fn()
    torch.cuda.synchronize()
    sleep_cycles = 100_000_000
    while True:
        spans.clear()
        first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for e, launch in originals.items():
            setattr(lib, e, timed(e, launch))
        try:
            torch.cuda._sleep(sleep_cycles)
            first.record()
            for _ in range(runs):
                fn()
            last.record()
            caught_up = first.query()
            torch.cuda.synchronize()
        finally:
            for e, launch in originals.items():
                setattr(lib, e, launch)
        if not caught_up:
            break
        require(sleep_cycles < 6_400_000_000,
                "entry_split_ms: the device caught up with the host while "
                "runs were enqueued, under a sleep of 6.4e9 cycles")
        sleep_cycles *= 2
    total = dict.fromkeys(names, 0.0)
    count = dict.fromkeys(names, 0)
    for kernel, start, end in spans:
        name = next((n for n in names if n in kernel), None)
        if name is not None:
            total[name] += start.elapsed_time(end)
            count[name] += 1
    require(all(c == runs for c in count.values()),
            f"entry_split_ms: {runs} calls launched {count}, one a call of "
            f"each kernel wanted")
    split = {name: total[name] / runs for name in names}
    split["other"] = (first.elapsed_time(last) - sum(total.values())) / runs
    return split


def kernel_split_ms(fn, names, runs: int = 10, tries: int = 3):
    """Device ms a launch of each kernel whose name contains one of
    ``names`` (the first that matches), and under "other" ms a call of
    every other device activity (torch's own kernels, copies), from
    torch.profiler over ``runs`` calls, each of which launches each named
    kernel once. The profiler can lose a trace's first launches (seen on
    the card late in long runs: one of five launches of a kernel on every
    retrace, 14 of 15 of a backward's three kernels once) and then hand
    one of them to the next trace (8 of 10, then 11 of 10, PR 21), so a
    trace that holds another count than ``runs`` of a kernel is taken
    again, up to ``tries`` times; if none holds every launch, each
    kernel's time is the mean over its launches in the trace nearest to
    ``runs`` ("other" is then off by the launches lost or gained), said in
    a printed line. Where no trace held a launch of each kernel, or every
    trace held more than ``runs``, or the profiler recorded no device
    activity at all, the split is timed with CUDA events around the
    kernels' launches instead (entry_split_ms), said in a printed line."""
    best, over = None, 0
    try:
        for _ in range(tries):
            total = dict.fromkeys(list(names) + ["other"], 0.0)
            count = dict.fromkeys(names, 0)
            for evt in device_events(fn, runs):
                name = next((n for n in names if n in evt.key), "other")
                total[name] += evt.device_time_total
                if name != "other":
                    count[name] += evt.count
            if all(c == runs for c in count.values()):
                best = total, count
                break
            over += any(c > runs for c in count.values())
            print(f"profiler: a trace of {runs} calls held {count} launches; "
                  "taken again", flush=True)
            off = max(abs(c - runs) for c in count.values())
            if best is None or off < max(abs(c - runs)
                                         for c in best[1].values()):
                best = total, count
        lost = None
        if over == tries:
            lost = f"every trace held more launches than calls ({count})"
        elif min(best[1].values()) == 0:
            lost = f"the nearest trace held {best[1]} launches"
    except ProfilerLost as e:
        lost = str(e)
    if lost is not None:
        print(f"profiler: {lost}; the split is timed with CUDA events around "
              f"each launch instead", flush=True)
        return entry_split_ms(fn, names, runs)
    total, count = best
    if any(c != runs for c in count.values()):
        print(f"profiler: no trace held one launch a call; each kernel's "
              f"time is the mean of its {count} traced launches", flush=True)
    split = {name: total[name] / count[name] / 1e3 for name in names}
    split["other"] = total["other"] / runs / 1e3
    return split


def check_varlen(gen):
    """The four packed-varlen kernels against their plain versions on
    VARLEN_DENSE_CASES (the 2x rule against the fp32 plain versions, with
    the per-sequence reference in the inputs' type as the low-precision
    one; lse within LSE_ATOL); B7 bitwise equal to B6's forward (both run
    the wgmma tile of fwd_sm90.cuh over the same 128-row work list); B6's
    forward, B7 and the backward each twice, bitwise. Times kernels, plain
    versions and the library yardstick at the first two cases. Returns the
    worst errors and the timings."""
    from flash_attn_tpu_torch import get_scheduler_metadata
    from flash_attn_tpu_torch.kernels import flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp
    from flash_attn_tpu_torch.utils.testing import (
        attention_varlen_ref,
        attention_varlen_ref_grads,
        check_against_ref,
    )

    worst = dict.fromkeys(("flash_varlen_fwd", "flash_varlen_fwd_persistent",
                           "flash_varlen_bwd_preprocess", "fa_varlen_bwd_dkdv",
                           "fa_varlen_bwd_dq"), 0.0)
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
        # one VarlenMeta for the forwards (their 128-row schedule) and the
        # backward (its 64-row lists), built beforehand as BERT builds it;
        # get_scheduler_metadata takes the packed rows as b x max_seqlen,
        # so it is built over the padded slots' bound and the real totals
        meta = get_scheduler_metadata(
            len(lens_q), max(lens_q), max(lens_k), h, h_k, d,
            cu_seqlens_q=cu_q, cu_seqlens_k=cu_k, seqused_q=sq, seqused_k=sk,
            causal=causal).meta
        kw = dict(causal=causal, meta=meta)
        out, lse = flash_varlen.flash_attention_varlen_fwd(q, k, v, *args,
                                                           **kw)
        out_p, lse_p = fvp.flash_attention_varlen_fwd_persistent(q, k, v, *args,
                                                                 **kw)
        twice = (flash_varlen.flash_attention_varlen_fwd(q, k, v, *args, **kw),
                 fvp.flash_attention_varlen_fwd_persistent(q, k, v, *args,
                                                           **kw))
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
        for kname, (o1, l1), (o2, l2) in zip(
                ("B6 forward", "B7"), ((out, lse), (out_p, lse_p)), twice):
            require(torch.equal(o1, o2) and torch.equal(l1, l2),
                    f"{case}: {kname} differs between runs")
        require(torch.equal(out, out_p) and torch.equal(lse, lse_p),
                f"{case}: B7 differs from B6's forward")
        del twice
        require(all(torch.equal(a, b) for a, b in zip(grads, again)),
                f"{case}: the backward differs between runs")
        # the preprocess alone against its plain version, on the rows of
        # each sequence's whole 128-row tiles (the kernel writes no other)
        meta_b = flash_varlen.varlen_meta(q, k, *args[:4], sq, sk, causal,
                                          meta)
        delta, lse2 = flash_varlen.varlen_bwd_preprocess(
            dout, out, lse, cu_q, cu_k, meta_b, *(torch.empty_like(x)
                                                  for x in (q, k, v)))
        want_delta, want_lse2 = flash_varlen.varlen_bwd_preprocess_plain(
            dout, out, lse, cu_q, sq)
        rows = torch.zeros(delta.shape[1], dtype=torch.bool, device="cuda")
        for i, n in enumerate((used_q or lens_q)):
            p0 = flash_varlen.padded_row(int(cu_q[i]), i)
            rows[p0:p0 + -(-n // 128) * 128] = True
        fin = torch.isfinite(want_lse2[:, rows])
        pre_err = float((delta[:, rows] - want_delta[:, rows]).abs().max())
        require(torch.equal(torch.isfinite(lse2[:, rows]), fin)
                and float((lse2[:, rows][fin] - want_lse2[:, rows][fin])
                          .abs().max()) <= 1e-5 and pre_err <= 1e-3,
                f"{case}: varlen preprocess delta err {pre_err} or lse2")
        worst["flash_varlen_bwd_preprocess"] = max(
            worst["flash_varlen_bwd_preprocess"], pre_err)
        del delta, lse2, want_delta, want_lse2
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
        print(f"varlen {case}: {'; '.join(errs)}; B7 bitwise equal to B6's "
              f"forward; B6 forward, B7 and the backward each bitwise equal "
              f"over two runs")
        if ci >= 2:
            continue
        # times at this shape
        pairs = attended_pairs(used_q or lens_q, used_k or lens_k, causal)
        rows_q, rows_k = sum(used_q or lens_q), sum(used_k or lens_k)
        b6 = lambda: flash_varlen.flash_attention_varlen_fwd(q, k, v, *args,
                                                             **kw)
        b7 = lambda: fvp.flash_attention_varlen_fwd_persistent(q, k, v, *args,
                                                              **kw)
        bwd = lambda: flash_varlen.flash_attention_varlen_bwd(
            dout, q, k, v, out, lse, *args, **kw)
        lib_fwd, lib_bwd, lib_label = sdpa_varlen(
            q, k, v, cu_q, cu_k, lens_q, lens_k, causal, dout)
        t = {"flash_varlen_fwd": time_ms(b6), "flash_varlen_fwd_persistent":
             time_ms(b7), "bwd": time_ms(bwd, runs=10)}
        t.update(kernel_split_ms(bwd, ("varlen_preprocess_kernel",
                                       "varlen_dkdv_kernel",
                                       "varlen_dq_kernel")))
        pre_plain = wall_ms(lambda: flash_varlen.varlen_bwd_preprocess_plain(
            dout, out, lse, cu_q, sq))
        pre_lib = time_ms(lambda: torch.linalg.vecdot(dout, out))
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
        # preprocess: dO and O read once, lse read, delta and lse2 written
        # in fp32; a multiply-add a head-dim element at the fp32 rate
        pre_bound = bound(2 * h * rows_q * d, esz * 2 * rows_q * h * d
                          + 4 * h * rows_q + 2 * 4 * h * rows_q, PEAK_FP32)
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
            "flash_varlen_bwd_preprocess": {
                "ms": t["varlen_preprocess_kernel"], "plain_ms": pre_plain,
                "library_ms": pre_lib,
                "library_call": "torch.linalg.vecdot(dO, O) (in the inputs' "
                                "type)", **pre_bound},
            "bwd_wrapper_ms": t["bwd"]}
        print(f"varlen times at {name} ({pairs / 1e6:.1f}M attended pairs): "
              f"B6 forward {t['flash_varlen_fwd']:.4f} ms, B7 "
              f"{t['flash_varlen_fwd_persistent']:.4f} ms (grid "
              f"{fvp.last_grid} blocks), bound {fwd_bound['bound_ms']:.4f} ms "
              f"({fwd_bound['bound_by']}); backward {t['bwd']:.4f} ms "
              f"(preprocess {t['varlen_preprocess_kernel']:.4f} ms, bound "
              f"{pre_bound['bound_ms']:.4f}; dK/dV kernel "
              f"{t['varlen_dkdv_kernel']:.4f} ms, bound "
              f"{dkdv_bound['bound_ms']:.4f} ({dkdv_bound['bound_by']}); dQ "
              f"kernel {t['varlen_dq_kernel']:.4f} ms, bound "
              f"{dq_bound['bound_ms']:.4f} ({dq_bound['bound_by']}); torch "
              f"ops {t['other']:.4f}); plain forward {plain_fwd:.2f} ms, "
              f"persistent plain {plain_p:.2f} ms, plain backward "
              f"{plain_bwd:.2f} ms, plain preprocess {pre_plain:.2f} ms "
              f"(host clock, median of 3); {lib_label}: forward {lib_f:.4f} "
              f"ms, backward {lib_b:.4f} ms; vecdot {pre_lib:.4f} ms")
        del lib_fwd, lib_bwd
    return worst, timings


def run_bench_varlen(gen, card):
    """bench.py's varlen section (bench.py:203-245) through the port: 4 x
    8192 non-causal and 16 mixed-length causal sequences through
    flash_attn_varlen_func (B7), flash_attention_varlen_fwd (B6 forward) on
    the mixed lengths, the backward alone from B7's residuals, then
    flash_attn_varlen_func(...).backward(), whose gradients must equal that
    backward's bitwise. Each counted; B7 must equal B6's forward bitwise and
    repeat bitwise. Returns the launches of the first counted run and the
    rates."""
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
    # B7's out and lse are the residuals of the backward below
    out_r, lse_r, _ = flash_attn_varlen_func(qm, km, vm, *args_m, causal=True,
                                             return_attn_probs=True)
    out_6, _ = flash_varlen.flash_attention_varlen_fwd(qm, km, vm, *args_m,
                                                       causal=True)
    ones = torch.ones_like(out_r)
    grads_r = flash_varlen.flash_attention_varlen_bwd(ones, qm, km, vm, out_r,
                                                      lse_r, *args_m,
                                                      causal=True)
    torch.cuda.synchronize()
    launches = kernel_counts()
    want = want_counts(flash_varlen_fwd=1, flash_varlen_fwd_persistent=2,
                       fa_varlen_bwd_preprocess=1, fa_varlen_bwd_dkdv=1,
                       fa_varlen_bwd_dq=1)
    require(launches == want, f"bench varlen launches {launches}, want {want}")
    require(bool(torch.isfinite(out_c.float()).all()), "non-finite out (4 x 8192)")
    require(bool(torch.isfinite(out_6.float()).all()), "non-finite B6 out (mixed)")
    require(torch.equal(out_6, out_r), "B7 differs from B6's forward (mixed)")
    require(torch.equal(flash_attn_varlen_func(qm, km, vm, *args_m, causal=True),
                        out_r), "B7 differs between runs (mixed)")

    leaves = [x.detach().requires_grad_() for x in (qm, km, vm)]
    torch.cuda.synchronize()
    reset_kernel_counts()
    flash_attn_varlen_func(*leaves, *args_m, causal=True).backward(ones)
    torch.cuda.synchronize()
    api = kernel_counts()
    want = want_counts(flash_varlen_fwd_persistent=1,
                       fa_varlen_bwd_preprocess=1, fa_varlen_bwd_dkdv=1,
                       fa_varlen_bwd_dq=1)
    require(api == want, f"flash_attn_varlen_func backward launches {api}, "
                         f"want {want}")
    require(all(torch.equal(leaf.grad, g) for leaf, g in zip(leaves, grads_r)),
            "flash_attn_varlen_func gradients differ from the B6 backward's "
            "on B7's residuals")
    print(f"bench varlen: launches {launches}; B7 bitwise equal to B6's "
          f"forward and over two runs; flash_attn_varlen_func"
          f"(...).backward() launches {api}, gradients bitwise equal to the "
          f"backward from B7's residuals")

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
    want = want_counts(flash_varlen_fwd_persistent=n,
                       fa_varlen_bwd_preprocess=n, fa_varlen_bwd_dkdv=n,
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
               "attention backward (B6 preprocess, dK/dV, dQ)": (
                   "varlen_preprocess", "varlen_dkdv", "varlen_dq"),
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
        again = flash_decode.flash_attention_decode(
            q, kc, vc, seqlens, MLA_SCALE, True, splits, block_table=table,
            qv=qv)
        require(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
                f"flash_decode_mla {name}: two runs differ")
        same_as_b8p = ""
        if splits == 1 and page and has_qv:
            # one split runs B8p's tile over the same keys: the step as a
            # one-row chunk through B8p gives the same bits
            one = torch.arange(b + 1, dtype=torch.int32, device="cuda")
            pf, pf_lse = fpp.flash_attention_paged_prefill_varlen(
                q.reshape(b, h, d), kc, vc, one, 1, seqlens, table,
                qv=qv.reshape(b, h, dv), softmax_scale=MLA_SCALE, causal=True)
            require(torch.equal(out.reshape(b, h, dv), pf)
                    and torch.equal(lse.reshape(b, h), pf_lse.T),
                    f"flash_decode_mla {name}: differs from B8p over the "
                    "same step as a one-row chunk")
            same_as_b8p = "; bitwise equal to B8p over the step as a chunk"
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
              f"{lse_err:.3e}; bitwise equal twice{same_as_b8p}")
        del ref_p, ref, ref_lp
        if timed is None:
            continue
        # the partition's balance, for the print line only: key tiles of
        # the busiest (batch row, split) block against the mean, from the
        # wrapper's own partition (sq = 1, so no causal cut shortens a run)
        run = flash_decode._split_bounds(seqlens.long(), splits, 64)
        blocks = [-(-max(0, min(r, n - sp * r)) // 64) for n, r in
                  zip(seqlens.tolist(), run.tolist()) for sp in range(splits)]
        busiest, mean_tiles = max(blocks), sum(blocks) / len(blocks)
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
              f"rate); the busiest block {busiest} key tiles, the mean "
              f"{mean_tiles:.3f} on {card}")
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
    from flash_attn_tpu_torch.serving.graphs import CapturedProgram
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

    def decode_step(qs, kvs, lens):
        """One decode step of every layer (append and attend): the last
        layer's output and whether every layer's output is finite."""
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        for layer in range(n):
            kp, vp = pages[layer]
            qq, kv = qs[layer], kvs[layer]
            out = flash_attn_with_kvcache(
                qq[..., :d], kp, vp, k=kv[..., :d], v=kv[..., d:],
                qv=qq[..., d:], cache_seqlens=lens, block_table=table,
                softmax_scale=MLA_SCALE, causal=True)
            finite &= torch.isfinite(out).all()
        return out, finite

    # the decode step as one CUDA graph (one step shape: b rows of one
    # token), captured at its first call; each step's q, kv and lengths
    # are copied into its static inputs
    graph = CapturedProgram()

    def serve(graphed: bool, keep: bool):
        """Prefill every chunk, then MLA_NEW decode steps through the graph
        or eagerly; with ``keep``, every prefill output's finiteness and
        each step's last-layer output."""
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(chunks):
            for layer in range(n):
                out = prefill(c, layer)
                if keep:
                    finite &= torch.isfinite(out).all()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lens = torch.full((b,), MLA_PROMPT, dtype=torch.int32, device="cuda")
        outs = []
        for step in range(MLA_NEW):
            args = (step_q[step], step_kv[step], lens)
            out, fin = graph(decode_step, *args) if graphed \
                else decode_step(*args)
            finite &= fin
            if keep:
                outs.append(out.clone())
            lens = lens + 1
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return bool(finite), outs, lens, t1 - t0, t2 - t1

    reset_kernel_counts()
    finite, outs, lens, _, _ = serve(True, True)
    launches = kernel_counts()
    want = want_counts(flash_paged_prefill=n * chunks,
                       flash_decode_mla=n * MLA_NEW)
    print(f"MLA serving: {n} layers x {h} heads, rope {d} + latent {dv}, "
          f"scale {MLA_SCALE:.5f}; {b} x {MLA_PROMPT}-token prompts in "
          f"{chunks} chunks of {MLA_CHUNK}, then {MLA_NEW} decode steps "
          f"(graphed), pages of {MLA_PAGE}; launches {launches}; every "
          f"output finite: {finite}")
    require(launches == want, f"MLA serving launches {launches}, want {want}")
    require(finite, "non-finite MLA serving output")
    dec_out = outs[-1]  # the last layer's last decode step

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

    # the eager decode steps over the same inputs: bitwise the graph's
    _, eager_outs, _, _, _ = serve(False, True)
    same = all(torch.equal(x, y) for x, y in zip(outs, eager_outs))
    print(f"MLA decode: graphed and eager outputs of every step's last layer "
          f"bitwise equal: {same}")
    require(same, "MLA decode: graphed and eager outputs differ")
    del outs, eager_outs

    timed = {True: [], False: []}
    for graphed in (True, False, False, True):  # in turns
        _, _, _, prefill_s, decode_s = serve(graphed, False)
        timed[graphed].append((prefill_s, decode_s))
    prefill_s = statistics.mean(t[0] for t in timed[True] + timed[False])
    decode_s = statistics.mean(t[1] for t in timed[True])
    eager_s = statistics.mean(t[1] for t in timed[False])
    print(f"MLA decode step over {n} layers, in turns: graphed "
          f"{timed[True][0][1] * 1e3 / MLA_NEW:.3f}, "
          f"{timed[True][1][1] * 1e3 / MLA_NEW:.3f} ms; eager "
          f"{timed[False][0][1] * 1e3 / MLA_NEW:.3f}, "
          f"{timed[False][1][1] * 1e3 / MLA_NEW:.3f} ms on {card}")
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
    last_step = (step_q[-1], step_kv[-1], last)
    for what, fn, graphed_fn in (
            ("prefill layer-chunk", lambda: prefill(chunks - 1, 0), None),
            (f"decode step over {n} layers",
             lambda: decode_step(*last_step),
             lambda: graph(decode_step, *last_step))):
        dev_ms = device_families(fn, families, f"one MLA {what}")
        wall = wall_ms(fn, runs=5)
        split[what] = {"device_ms": dev_ms, "wall_ms": wall,
                       "idle_share": 1 - dev_ms / wall}
        print(f"MLA {what}: wall {wall:.3f} ms, device {dev_ms:.3f} ms, "
              f"device idle share {1 - dev_ms / wall:.3f} on {card}")
        if graphed_fn is not None:
            g_wall = wall_ms(graphed_fn, runs=5)
            split[what].update(graphed_wall_ms=g_wall,
                               graphed_idle_share=1 - dev_ms / g_wall)
            print(f"MLA {what} (graphed): wall {g_wall:.3f} ms, device "
                  f"idle share {1 - dev_ms / g_wall:.3f} on {card}")
    result = {"prefill_ms_per_layer_chunk": prefill_s * 1e3 / (n * chunks),
              "prefill_s": prefill_s,
              "decode_step_ms": decode_s * 1e3 / MLA_NEW,
              "decode_step_ms_eager": eager_s * 1e3 / MLA_NEW,
              "decode_tokens_per_s": b * MLA_NEW / decode_s,
              "decode_tokens_per_s_eager": b * MLA_NEW / eager_s,
              "peak_gb": peak_gb, "oracle_err": diff, "profile": split}
    print(f"MLA serving on {card}: prefill {prefill_s:.3f} s "
          f"({result['prefill_ms_per_layer_chunk']:.3f} ms per layer-chunk "
          f"of {b} x {MLA_CHUNK} tokens), decode step over {n} layers "
          f"{result['decode_step_ms']:.3f} ms graphed, "
          f"{result['decode_step_ms_eager']:.3f} ms eager, "
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


def blocksparse_dense_oracle(q, k, v, dout, out, lse, grads, case):
    """The full causal block mask against the varlen kernels over the same
    rows packed as b sequences: out and lse must equal B7's bitwise (both
    walk the same band on the wgmma tile of fwd_sm90.cuh in the same
    order), and the gradients, rounded to the inputs' type, B6's backward's
    (both walk it on the tiles of bwd_sm90.cuh)."""
    from flash_attn_tpu_torch.kernels import flash_varlen

    b, h, s, d = q.shape
    out7, lse7 = packed_b7_forward(
        *(x.transpose(1, 2) for x in (q, k, v)), causal=True)()
    require(torch.equal(out7, out) and torch.equal(lse7, lse),
            f"block-sparse {case}: out and lse differ from B7's over the "
            f"same rows packed (max |B10 - B7| "
            f"{(out.float() - out7.float()).abs().max().item():.3e})")
    cu = torch.arange(b + 1, dtype=torch.int32, device="cuda") * s
    packed = [x.transpose(1, 2).reshape(b * s, h, d)
              for x in (dout, q, k, v, out)]
    dense = flash_varlen.flash_attention_varlen_bwd(
        *packed, lse.permute(1, 0, 2).reshape(h, b * s), cu, cu, s, s,
        causal=True)
    dense = [g.reshape(b, s, h, d).transpose(1, 2) for g in dense]
    require(all(torch.equal(g.to(g6.dtype), g6)
                for g, g6 in zip(grads, dense)),
            f"block-sparse {case}: gradients differ from B6's over the same "
            f"rows packed (max |B10 - B6| "
            + ", ".join(f"d{n} {(g.float() - g6.float()).abs().max().item():.3e}"
                        for n, g, g6 in zip("qkv", grads, dense)) + ")")
    print(f"block-sparse {case}: out and lse bitwise equal to B7's, "
          f"gradients bitwise equal to B6's over the same rows packed")


def check_blocksparse(gen, card):
    """B10 (csrc/flash_blocksparse.cu) on BS_CASES. Each case first drives
    the public differentiable flash_attention_blocksparse(...).backward()
    with the counts set to 0 just before and read just after (1 forward, 1
    preprocess, 1 dK/dV and 1 dQ launch, nothing else); then holds the
    forward and the fp32 backward to the 2x rule against the plain fp32
    versions (the plain forward in bf16, and autograd through it, as the
    low-precision reference; lse within LSE_ATOL) and the backward's
    preprocess to its plain version (delta within 1e-3, lse2 within 1e-5,
    the inverse lists equal), requires the backward to give the same bits
    twice, and on the full causal mask B7's bits (out, lse) and B6's
    backward's (blocksparse_dense_oracle); times kernel, plain and SDPA
    with the expanded boolean mask (forward and backward; masks with no
    empty row) beside the bound: the listed, unmasked pairs' 4 d flops (10
    d backward) over 989 TFLOP/s, or the bytes over 3.35 TB/s, with a
    profiler split of the backward into its three kernels and each torch op
    around them. Returns the launches, worst errors and timings."""
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    h, d = BS_HEADS, BS_DIM
    launches = {"flash_blocksparse_fwd": 0,
                "flash_blocksparse_bwd_preprocess": 0,
                "flash_blocksparse_bwd": 0}
    worst = dict.fromkeys(launches, 0.0)
    bwd_kernels = ["bs_preprocess_kernel", "bs_dkdv_kernel", "bs_dq_kernel"]
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
                                   fa_blocksparse_bwd_preprocess=1,
                                   fa_blocksparse_bwd_dkdv=1,
                                   fa_blocksparse_bwd_dq=1),
                f"block-sparse {case}: launch counts {got}")
        launches["flash_blocksparse_fwd"] += 1
        launches["flash_blocksparse_bwd_preprocess"] += 1
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
        # the preprocess kernel against its plain version
        nk = s // block
        numb = num.expand(b, num.shape[-1]).contiguous()
        idxb = idx.expand(b, *idx.shape[-2:]).contiguous()
        pre_args = (dout, out, lse, numb, idxb, nk)
        pre = bs.blocksparse_bwd_preprocess(*pre_args, block, block)
        want = bs.blocksparse_bwd_preprocess_plain(*pre_args)
        pre_err = float((pre[0] - want[0]).abs().max())
        fin = torch.isfinite(want[1])
        listed = (torch.arange(pre[3].shape[-1], device="cuda")
                  < want[2][..., None])
        require(pre_err <= 1e-3 and torch.equal(torch.isfinite(pre[1]), fin)
                and float((pre[1][fin] - want[1][fin]).abs().max()) <= 1e-5
                and torch.equal(pre[2], want[2])
                and torch.equal(pre[3][listed], want[3][listed]),
                f"block-sparse preprocess (delta err {pre_err}): {case}")
        worst["flash_blocksparse_bwd_preprocess"] = max(
            worst["flash_blocksparse_bwd_preprocess"], pre_err)
        print(f"block-sparse {case}: launches 1/1/1/1 through autograd; "
              f"backward bitwise equal over two runs; max abs err "
              f"{', '.join(errs)}; preprocess delta {pre_err:.3e}, lse2 "
              f"within 1e-5, inverse lists equal to the plain version's")
        if kind == "causal":
            blocksparse_dense_oracle(q, k, v, dout, out, lse, grads, case)
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
        t["bwd_split_ms"] = {}

        def bs_bwd():
            return bs.flash_attention_blocksparse_bwd(
                dout, q, k, v, out, lse, num, idx, **kw)
        try:
            events = device_events(bs_bwd, 5)
        except ProfilerLost as e:
            print(f"profiler: {e}; the split is timed with CUDA events "
                  f"around each launch instead", flush=True)
            t["bwd_split_ms"] = entry_split_ms(bs_bwd, bwd_kernels, 5)
            events = []
        for evt in events:
            key = next((n for n in bwd_kernels if n in evt.key), evt.key[:60])
            t["bwd_split_ms"][key] = (t["bwd_split_ms"].get(key, 0.0)
                                      + evt.device_time_total / 5 / 1e3)
        t["pre_ms"] = time_ms(lambda: bs.blocksparse_bwd_preprocess(
            *pre_args, block, block), runs=10)
        t["plain_pre_ms"] = time_ms(lambda: bs.blocksparse_bwd_preprocess_plain(
            *pre_args), runs=10)
        t["lib_pre_ms"] = time_ms(lambda: torch.linalg.vecdot(dout, out),
                                  runs=10)
        # dO and O read once, lse and the kv lists read; delta and lse2
        # written in fp32 over the padded rows, the inverse lists' used
        # entries and their counts written; a multiply-add a head-dim
        # element of a row at the fp32 rate
        s_pad = -(-s // 128) * 128
        pre_bound = bound(2 * b * h * s * d,
                          2 * 2 * el + 4 * b * h * s + 2 * 4 * b * h * s_pad
                          + list_bytes + 4 * (int(want[2].sum()) + b * nk),
                          PEAK_FP32)
        t["pre_bound_ms"], t["pre_bound_by"] = (pre_bound["bound_ms"],
                                                pre_bound["bound_by"])
        del pre, want, numb, idxb, pre_args
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
              f"SDPA {t['sdpa_bwd_ms']}; profiler split, ms a call: "
              + ", ".join(f"{n} {v:.4f}" for n, v in t["bwd_split_ms"].items())
              + f"), preprocess {t['pre_ms']:.4f} ms (bound "
              f"{t['pre_bound_ms']:.4f}, {t['pre_bound_by']}; plain "
              f"{t['plain_pre_ms']:.4f}) on {card}")
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
        "flash_blocksparse_bwd_preprocess": {
            "ms": tb["pre_ms"], "plain_ms": tb["plain_pre_ms"],
            "bound_ms": tb["pre_bound_ms"], "bound_by": tb["pre_bound_by"],
            "library_ms": tb["lib_pre_ms"],
            "library_call": "torch.linalg.vecdot(dO, O) (in bf16): the delta "
                            "alone, as for B3's and B6's preprocess; no call "
                            "computes lse2 or the inverse lists"},
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


def hf_weights(spec, seed: int):
    """A state dict in HF's names, bf16 on the card, from a seeded
    generator: each entry of ``spec`` (shape, std) is N(0, std^2), or
    (shape, "ones") / (shape, "zeros")."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, (shape, init) in spec.items():
        if init in ("ones", "zeros"):
            fill = torch.ones if init == "ones" else torch.zeros
            out[name] = fill(shape, dtype=torch.bfloat16, device="cuda")
        else:
            out[name] = torch.randn(shape, generator=gen, device="cuda",
                                    dtype=torch.bfloat16).mul_(init)
    return out


class HFSpec(dict):
    """A HF checkpoint's tensor shapes and initial scales (flax's: Dense
    kernels N(0, 1/fan_in), embeddings N(0, 1/width), biases N(0, 0.02^2),
    norms 1 and 0), built name by name."""

    def linear(self, name, out_f, in_f, bias=False):
        self[name + ".weight"] = ((out_f, in_f), in_f ** -0.5)
        if bias:
            self[name + ".bias"] = ((out_f,), 0.02)

    def norm(self, name, dim, bias=True):
        self[name + ".weight"] = ((dim,), "ones")
        if bias:
            self[name + ".bias"] = ((dim,), "zeros")

    def embedding(self, name, rows, dim):
        self[name + ".weight"] = ((rows, dim), dim ** -0.5)


def llama_spec(c) -> HFSpec:
    e, i_f = c.hidden_size, c.intermediate_size
    kv = c.num_key_value_heads * (e // c.num_attention_heads)
    spec = HFSpec()
    spec.embedding("model.embed_tokens", c.vocab_size, e)
    for i in range(c.num_hidden_layers):
        p = f"model.layers.{i}."
        spec.norm(p + "input_layernorm", e, bias=False)
        spec.norm(p + "post_attention_layernorm", e, bias=False)
        for name, rows in (("q", e), ("k", kv), ("v", kv), ("o", e)):
            spec.linear(p + f"self_attn.{name}_proj", rows, e)
        spec.linear(p + "mlp.gate_proj", i_f, e)
        spec.linear(p + "mlp.up_proj", i_f, e)
        spec.linear(p + "mlp.down_proj", e, i_f)
    spec.norm("model.norm", e, bias=False)
    spec.linear("lm_head", c.vocab_size, e)
    return spec


def falcon_spec(c) -> HFSpec:
    e = c.hidden_size
    d = e // c.num_attention_heads
    spec = HFSpec()
    spec.embedding("transformer.word_embeddings", c.vocab_size, e)
    for i in range(c.num_hidden_layers):
        p = f"transformer.h.{i}."
        spec.norm(p + "input_layernorm", e)
        # (71 q heads, then one k and one v head) of 64 rows each
        spec.linear(p + "self_attention.query_key_value",
                    (c.num_attention_heads + 2) * d, e)
        spec.linear(p + "self_attention.dense", e, e)
        spec.linear(p + "mlp.dense_h_to_4h", 4 * e, e)
        spec.linear(p + "mlp.dense_4h_to_h", e, 4 * e)
    spec.norm("transformer.ln_f", e)
    return spec


def neox_spec(c) -> HFSpec:
    e, i_f = c.hidden_size, c.intermediate_size
    spec = HFSpec()
    spec.embedding("gpt_neox.embed_in", c.vocab_size, e)
    for i in range(c.num_hidden_layers):
        p = f"gpt_neox.layers.{i}."
        spec.norm(p + "input_layernorm", e)
        spec.norm(p + "post_attention_layernorm", e)
        spec.linear(p + "attention.query_key_value", 3 * e, e, bias=True)
        spec.linear(p + "attention.dense", e, e, bias=True)
        spec.linear(p + "mlp.dense_h_to_4h", i_f, e, bias=True)
        spec.linear(p + "mlp.dense_4h_to_h", e, i_f, bias=True)
    spec.norm("gpt_neox.final_layer_norm", e)
    spec.linear("embed_out", c.vocab_size, e)
    return spec


def gptj_spec(c) -> HFSpec:
    e, i_f = c.n_embd, c.n_inner or 4 * c.n_embd
    spec = HFSpec()
    spec.embedding("transformer.wte", c.vocab_size, e)
    for i in range(c.n_layer):
        p = f"transformer.h.{i}."
        spec.norm(p + "ln_1", e)
        for name in ("q", "k", "v", "out"):
            spec.linear(p + f"attn.{name}_proj", e, e)
        spec.linear(p + "mlp.fc_in", i_f, e, bias=True)
        spec.linear(p + "mlp.fc_out", e, i_f, bias=True)
    spec.norm("transformer.ln_f", e)
    spec.linear("lm_head", c.vocab_size, e)
    # zeros: the port raises for a nonzero lm_head.bias (hf_adapters.py)
    spec["lm_head.bias"] = ((c.vocab_size,), "zeros")
    return spec


def opt_spec(c) -> HFSpec:
    e, f = c.hidden_size, c.ffn_dim
    dec = "model.decoder."
    spec = HFSpec()
    spec.embedding(dec + "embed_tokens", c.vocab_size, e)
    # OPT keeps 2 rows before its first position
    spec.embedding(dec + "embed_positions", c.max_position_embeddings + 2, e)
    for i in range(c.num_hidden_layers):
        p = f"{dec}layers.{i}."
        for name in ("q", "k", "v", "out"):
            spec.linear(p + f"self_attn.{name}_proj", e, e, bias=True)
        spec.norm(p + "self_attn_layer_norm", e)
        spec.linear(p + "fc1", f, e, bias=True)
        spec.linear(p + "fc2", e, f, bias=True)
        spec.norm(p + "final_layer_norm", e)
    spec.norm(dec + "final_layer_norm", e)
    return spec


def starcoder_spec(c) -> HFSpec:
    e, i_f = c.n_embd, c.n_inner
    spec = HFSpec()
    spec.embedding("transformer.wte", c.vocab_size, e)
    spec.embedding("transformer.wpe", c.n_positions, e)
    for i in range(c.n_layer):
        p = f"transformer.h.{i}."
        spec.norm(p + "ln_1", e)
        # q for all heads, then the one k and v head
        spec.linear(p + "attn.c_attn", e + 2 * (e // c.n_head), e, bias=True)
        spec.linear(p + "attn.c_proj", e, e, bias=True)
        spec.norm(p + "ln_2", e)
        spec.linear(p + "mlp.c_fc", i_f, e, bias=True)
        spec.linear(p + "mlp.c_proj", e, i_f, bias=True)
    spec.norm("transformer.ln_f", e)
    return spec


def vit_spec(c, num_classes: int) -> HFSpec:
    e, i_f, p_ = c.hidden_size, c.intermediate_size, c.patch_size
    emb = "vit.embeddings."
    patches = (c.image_size // p_) ** 2
    spec = HFSpec()
    spec[emb + "cls_token"] = ((1, 1, e), 0.02)
    spec[emb + "position_embeddings"] = ((1, patches + 1, e), 0.02)
    fan_in = c.num_channels * p_ * p_
    spec[emb + "patch_embeddings.projection.weight"] = (
        (e, c.num_channels, p_, p_), fan_in ** -0.5)
    spec[emb + "patch_embeddings.projection.bias"] = ((e,), 0.02)
    for i in range(c.num_hidden_layers):
        p = f"vit.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            spec.linear(p + f"attention.attention.{name}", e, e, bias=True)
        spec.linear(p + "attention.output.dense", e, e, bias=True)
        spec.linear(p + "intermediate.dense", i_f, e, bias=True)
        spec.linear(p + "output.dense", e, i_f, bias=True)
        spec.norm(p + "layernorm_before", e)
        spec.norm(p + "layernorm_after", e)
    spec.norm("vit.layernorm", e)
    spec.linear("classifier", num_classes, e, bias=True)
    return spec


# A HF checkpoint's per-layer tensor names: "...layers.<i>." or "...h.<i>."
HF_LAYER = re.compile(r"\.(?:layers|h)\.(\d+)\.")


def hf_model(family: str, hf_cfg, spec_fn, seed: int,
             max_decode_seqlen: int = ENGINE_MAX_LEN, **fields):
    """A GPTLMHeadModel (bf16, on the card, ``max_decode_seqlen``; the
    config's ``fields`` replaced, as the JAX package sets Mistral's window
    on the Llama adapter's config) of ``hf_cfg`` through the port's adapter
    ``family``,
    its weights a seeded HF checkpoint (the values of hf_weights(spec,
    seed)) made and remapped a layer at a time through the port's own
    remap, each part freed before the next: a layer's tensors under layer
    0's names through the remap of a 1-layer config, then the tensors
    outside the layers through that of a 0-layer config. So the checkpoint
    never sits whole on the card beside the model (GPT-NeoX-20B's 41 GB of
    bf16 weights twice would not fit). Returns the model and the peak
    device memory of the build (GB, max_memory_allocated)."""
    from flash_attn_tpu_torch.models import hf_adapters, llama
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel

    mod = llama if family == "llama" else hf_adapters
    cfg = dataclasses.replace(getattr(mod, f"{family}_config_to_gpt_config")(
        hf_cfg, dtype=torch.bfloat16, max_decode_seqlen=max_decode_seqlen),
        **fields)
    remap = getattr(mod, f"remap_state_dict_hf_{family}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = GPTLMHeadModel(cfg, device="cuda").requires_grad_(False)
    params = dict(model.named_parameters())
    spec = spec_fn(hf_cfg)
    layer_of = {name: HF_LAYER.search(name) for name in spec}
    outer = {name: torch.empty(0, dtype=torch.bfloat16, device="cuda")
             for name, m in layer_of.items() if m is None}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    done = set()

    def load(sd, n_layer, layer):
        out = remap(sd, dataclasses.replace(cfg, n_layer=n_layer))
        for name, t in out.items():
            if layer is not None:
                if not name.startswith("transformer.layers.0."):
                    continue  # an outer tensor's placeholder
                name = name.replace(".0.", f".{layer}.", 1)
            params[name].copy_(t)
            done.add(name)

    part, part_layer = {}, None
    for name, (shape, init) in spec.items():  # hf_weights' order and draws
        m = layer_of[name]
        layer = None if m is None else int(m.group(1))
        if part and layer != part_layer:
            load({**outer, **part}, 1, part_layer)
            part = {}
        if init in ("ones", "zeros"):
            fill = torch.ones if init == "ones" else torch.zeros
            t = fill(shape, dtype=torch.bfloat16, device="cuda")
        else:
            t = torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.bfloat16).mul_(init)
        if m is None:
            outer[name] = t
        else:
            part[name[:m.start(1)] + "0" + name[m.end(1):]] = t
            part_layer = layer
    if part:
        load({**outer, **part}, 1, part_layer)
    load(outer, 0, None)
    require(done == set(params), f"{family}: the remap left parameters "
            f"unset: {sorted(set(params) - done)[:4]}")
    del outer, part
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    return model, peak


def check_breadth_kernels(gen):
    """B1 and B4 at the new families' shapes (BREADTH_FWD_CASES,
    BREADTH_DEC_CASES) against their plain versions, each timed beside its
    bound, the plain version and SDPA. Returns errors and timings by
    name."""
    errs, timings = {}, {}
    for name, case in BREADTH_FWD_CASES:
        (qt, kt, vt), _, _, errs[name] = fwd_case(gen, case)
        timings[name] = fwd_timing(qt, kt, vt, case, name)
    lens = (PROMPT + 1, PROMPT + NEW_TOKENS)
    for name, b, h, h_k, d in BREADTH_DEC_CASES:
        inputs, keep, splits, errs[name] = decode_case(gen, b, h, h_k, d,
                                                       640, 0, lens)
        timings[name] = decode_timing(*inputs, keep, splits, name)
    return errs, timings


def paged_sdpa(q, kp, vp, table, seqlens, causal=True, lens_q=None,
               window=(None, None), attention_chunk: int = 0):
    """The library yardstick of attention over a paged cache: the cache
    gathered to the linear layout through its block table (paged_to_linear,
    torch ops) and one scaled_dot_product_attention with a boolean length
    (and bottom-right causal, and band: ``window``, ``attention_chunk``
    with no upper chunk bound, as the decode kernel masks it) mask. q (b,
    sq, h, d), each row's first lens_q (b,) rows its own (all sq by
    default). Returns (gather + SDPA, SDPA over the cache gathered
    beforehand): the first computes the kernel's function from the
    kernel's inputs."""
    from flash_attn_tpu_torch.dispatch.band import band_valid

    from flash_attn_tpu_torch.utils.testing import paged_to_linear

    b, sq, h, d = q.shape
    qh = q.transpose(1, 2)
    gqa = h != kp.shape[1]
    width = table.shape[1] * kp.shape[2]
    row = torch.arange(sq, device=q.device)[:, None]
    col = torch.arange(width, device=q.device)[None, :]
    lens = seqlens.to(q.device, torch.long)[:, None, None]
    rows = sq if lens_q is None else torch.as_tensor(
        lens_q, device=q.device)[:, None, None]
    mask = col[None] < lens
    if causal or window != (None, None) or attention_chunk:
        mask = mask & band_valid(row[None], col[None], lens - rows, causal,
                                 window, attention_chunk=attention_chunk,
                                 chunk_upper=False)
    mask = mask[:, None]
    kl, vl = (paged_to_linear(x, table, seqlens) for x in (kp, vp))

    def gathered():
        return F.scaled_dot_product_attention(
            qh, *(paged_to_linear(x, table, seqlens) for x in (kp, vp)),
            attn_mask=mask, enable_gqa=gqa)

    def sdpa_only():
        return F.scaled_dot_product_attention(qh, kl, vl, attn_mask=mask,
                                              enable_gqa=gqa)
    return gathered, sdpa_only


def paged_decode_case(gen, b, h, h_k, d, page, sq, name, splits=0,
                      timed=True):
    """B4's d = dv route over a page pool of b slots of ENGINE_MAX_LEN
    positions (pages of ``page``, h / h_k heads of d, bf16; ``splits`` 0
    takes the split count flash_attn_with_kvcache picks) at static decode's
    lengths (sq = 1) or a verify step's (sq > 1: contexts of the engine
    trace after an append, causal bottom-right over the appended rows),
    against its plain version (the 2x rule, lse within LSE_ATOL); with
    ``timed``, timed beside its bound, the plain version and SDPA with a
    boolean causal length mask over the cache gathered to the linear
    layout (the gather untimed). Returns the error and the timing (None
    untimed)."""
    from flash_attn_tpu_torch.cache.kvcache import _default_num_splits
    from flash_attn_tpu_torch.dispatch.config import DECODE_BLOCK_K
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
        paged_to_linear,
    )

    kp, vp, table = paged_cache(gen, b, h_k, d, page, ENGINE_MAX_LEN,
                                torch.bfloat16)
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(
        torch.bfloat16)
    if sq == 1:
        seqlens = torch.linspace(PROMPT + 1, PROMPT + NEW_TOKENS, b,
                                 device="cuda").round().to(torch.int32)
    else:
        seqlens = torch.randint(ENGINE_PROMPT + sq, ENGINE_MAX_LEN - 8, (b,),
                                device="cuda", generator=gen,
                                dtype=torch.int32)
    splits = splits or _default_num_splits(q, kp, vp, table, False)
    out, lse = flash_decode.flash_attention_decode(
        q, kp, vp, seqlens, causal=True, num_splits=splits,
        block_table=table)
    ref, ref_lse = flash_decode.flash_attention_decode(
        q.float().cpu(), kp.float().cpu(), vp.float().cpu(), seqlens.cpu(),
        causal=True, num_splits=splits, block_table=table.cpu())
    k_lin, v_lin = (paged_to_linear(x, table, seqlens).transpose(1, 2)
                    for x in (kp, vp))
    keep = torch.arange(k_lin.shape[1], device="cuda")[None] \
        < seqlens[:, None]
    ref_lp, _ = attention_ref(q, k_lin, v_lin, key_padding_mask=keep,
                              causal=True, upcast=False)
    torch.cuda.synchronize()
    desc = (f"b={b} sq={sq} h={h} h_k={h_k} d={d} page={page} lengths "
            f"{int(seqlens.min())}..{int(seqlens.max())} num_splits={splits}")
    err, err_lp = check_against_ref(out, ref, ref_lp,
                                    msg=f"flash_decode_paged {desc}")
    lse_err = (lse.cpu() - ref_lse).abs().max().item()
    require(lse_err <= LSE_ATOL, f"{name} lse error {lse_err}")
    print(f"flash_decode_paged {desc}: out max abs err {err:.3e} (bf16 "
          f"reference {err_lp:.3e}), lse max abs err {lse_err:.3e}")
    if not timed:
        return err, None
    scale = d ** -0.5
    ms = time_ms(lambda: flash_decode.flash_attention_decode_partials(
        q, kp, vp, seqlens, splits, scale, True, block_table=table))
    plain_ms = time_ms(
        lambda: flash_decode.flash_attention_decode_paged_partials_plain(
            q, kp, vp, seqlens, table, splits, DECODE_BLOCK_K, scale, True))
    gathered, sdpa_only = paged_sdpa(q, kp, vp, table, seqlens)
    lib_ms, sdpa_ms = time_ms(gathered), time_ms(sdpa_only)
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "library_call": "the cache gathered through the block table "
                              "to the linear layout, then "
                              "scaled_dot_product_attention with a boolean "
                              "causal length mask (the gather included)",
              "library_sdpa_only_ms": sdpa_ms,
              **decode_bound(seqlens, b, h, h_k, d, splits, table.numel(),
                             sq)}
    print(f"flash_decode_paged time at {name}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, gather + masked scaled_dot_product_attention "
          f"{lib_ms:.4f} ms ({sdpa_ms:.4f} ms without the gather; median of "
          f"25); bound {timing['bound_ms']:.4f} ms ({timing['bound_by']})")
    return err, timing


def check_wide_kernels(gen):
    """B1, B4 (linear, paged and, at WIDE_VERIFY_D, the verify step) and B8
    at head dims 96 and 256, at the shapes WIDE_FAMILIES give them, against
    their plain versions and timed beside their bounds, the plain versions
    and SDPA. Returns errors and timings by row name (B1's non-causal case
    under its causal row's "noncausal")."""
    errs, timings = {}, {}
    for fam, d, h in WIDE_FAMILIES:
        name = f"flash_fwd_d{d}"
        for causal in (True, False):
            case = (BATCH, PROMPT, PROMPT, h, h, d, causal)
            (qt, kt, vt), _, _, err = fwd_case(gen, case)
            t = fwd_timing(qt, kt, vt, case, f"{fam}'s prefill")
            errs[name] = max(errs.get(name, 0.0), err)
            if causal:
                timings[name] = t
            else:
                timings[name]["noncausal"] = t
            del qt, kt, vt
        name = f"flash_decode_d{d}"
        inputs, keep, splits, errs[name] = decode_case(
            gen, BATCH, h, h, d, 640, 0, (PROMPT + 1, PROMPT + NEW_TOKENS))
        timings[name] = decode_timing(*inputs, keep, splits,
                                      f"{fam}'s decode step")
        del inputs, keep
        for sq in (1, SPEC_K + 1) if d == WIDE_VERIFY_D else (1,):
            name = f"flash_decode_paged_d{d}" + ("_verify" if sq > 1 else "")
            errs[name], timings[name] = paged_decode_case(
                gen, BREADTH_SLOTS, h, h, d, ENGINE_PAGE, sq,
                f"{fam}'s engine " + ("verify step" if sq > 1
                                      else "decode step"))
        name = f"flash_varlen_paged_d{d}"
        errs[name], timings[name] = varlen_paged_case(
            gen, ("prefix admission", [256] * 8, [512] * 8, None, h, h, d,
                  ENGINE_PAGE, torch.bfloat16, True),
            with_b6=False, timed=True)
        torch.cuda.empty_cache()
    return errs, timings


def serve_family(name, model, card, rng, rate_runs: int = 3):
    """serve_static and the graphed decode rate of one family; returns its
    launches and measurements."""
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)),
                          device="cuda")
    launches, _, _ = serve_static(model, ids, name)
    ttft, tok_s = static_rates(model, ids, modes=(True,), runs=rate_runs)
    model._decode_state = None  # its caches and graph
    torch.cuda.empty_cache()
    # a decode step reads every weight once at least
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    res = {"params_b": n_params / 1e9, "layers": cfg.n_layer,
           "ttft_ms": ttft * 1e3, "decode_tokens_per_s": tok_s[True][0],
           "decode_step_ms": BATCH / tok_s[True][0] * 1e3,
           "weight_read_ms": weight_bytes / PEAK_BYTES * 1e3}
    print(f"{name} ({n_params / 1e9:.2f}B parameters, {cfg.n_layer} layers, "
          f"width {cfg.n_embd}, {cfg.n_head}/{cfg.n_head_kv or cfg.n_head} "
          f"heads): TTFT {ttft * 1e3:.2f} ms (b={BATCH} x {PROMPT}), decode "
          f"{tok_s[True][0]:.1f} tokens/s graphed, a step "
          f"{res['decode_step_ms']:.3f} ms against {res['weight_read_ms']:.3f} "
          f"ms to read its {weight_bytes / 1e9:.2f} GB of weights once at "
          f"3.35 TB/s, on {card}")
    return launches, res


def run_breadth(card):
    """Serve Llama-3-8B at full width and depth (static decode, graphed and
    eager, then BREADTH_REQUESTS requests through the paged engine, then
    static decode from an fp8 cache, kv_static), then
    Falcon-7B, Pythia-6.9B, OPT-6.7B (also through the prefix-cached
    engine) and StarCoder at full width and BREADTH_LAYERS layers, each
    model built from its published config through the port's adapter and
    freed before the next. Returns the launches of each run and the
    measurements."""
    rng = np.random.default_rng(21)
    launches, out = {}, {}
    t0 = time.perf_counter()
    model, peak = hf_model("llama", LLAMA3_8B, llama_spec, 10)
    print(f"Llama-3-8B built from its config and a seeded HF checkpoint in "
          f"{time.perf_counter() - t0:.1f} s (peak {peak:.2f} GB)")
    launches["Llama-3-8B"], out["Llama-3-8B"] = serve_family(
        "Llama-3-8B", model, card, rng)
    prompts = list(rng.integers(0, model.config.vocab_size,
                                (BREADTH_REQUESTS, ENGINE_PROMPT)))
    paged = paged_view(model, BREADTH_SLOTS)
    name = "Llama-3-8B paged engine"
    launches[name], tokens, out[name] = run_engine(
        paged, prompts, False, card, slots=BREADTH_SLOTS, name=name)
    # Llama-3's 128,256 logits of unit scale hold a near-tie (top two
    # within the bf16 noise of 32 layers, ~0.1) at more positions than the
    # 913M model's 50,304: its argmax agreement is held to the static
    # check's MIN_ARGMAX_AGREEMENT, the token's gap to LOGIT_BOUND as ever
    out[name]["agreement"], out[name]["logit_gap"] = engine_agreement(
        paged, prompts, tokens, name, MIN_ARGMAX_AGREEMENT)
    del paged
    # the same weights served from an fp8 cache (a quantized cache)
    ids = torch.as_tensor(np.random.default_rng(22).integers(
        0, model.config.vocab_size, (BATCH, PROMPT)), device="cuda")
    name = "Llama-3-8B fp8 cache"
    launches[name], out[name] = kv_static(model, ids, "Llama-3-8B", card, 1.0)
    del model
    torch.cuda.empty_cache()

    cut = {"falcon": "num_hidden_layers", "gpt_neox": "num_hidden_layers",
           "opt": "num_hidden_layers", "bigcode": "n_layer"}
    for name, hf_cfg, family, spec_fn, seed in (
            ("Falcon-7B", FALCON_7B, "falcon", falcon_spec, 11),
            ("Pythia-6.9B", PYTHIA_6_9B, "gpt_neox", neox_spec, 12),
            ("OPT-6.7B", OPT_6_7B, "opt", opt_spec, 13),
            ("StarCoder", STARCODER, "bigcode", starcoder_spec, 14)):
        hf_cut = SimpleNamespace(**{**vars(hf_cfg),
                                    cut[family]: BREADTH_LAYERS})
        model, _ = hf_model(family, hf_cut, spec_fn, seed)
        launches[name], out[name] = serve_family(name, model, card, rng)
        if family == "opt":
            # learned positions from the prefix length: the suffix of a
            # prompt after its cached pages
            shared = rng.integers(0, model.config.vocab_size, PREFIX_SHARED)
            px = [np.concatenate([shared, rng.integers(
                0, model.config.vocab_size, ENGINE_PROMPT - PREFIX_SHARED)])
                for _ in range(BREADTH_REQUESTS)]
            paged = paged_view(model, BREADTH_SLOTS)
            ename = "OPT-6.7B prefix-cache engine"
            launches[ename], tokens, out[ename] = run_engine(
                paged, px, True, card, slots=BREADTH_SLOTS, name=ename)
            out[ename]["agreement"], out[ename]["logit_gap"] = \
                engine_agreement(paged, px, tokens, ename)
            del paged
        del model
        torch.cuda.empty_cache()
    return launches, out


def run_wide_families(card):
    """GPT-NeoX-20B (64 heads of 96, SERVE_LAYERS of its 44 layers) and
    GPT-J-6B (16 heads of 256, all 28) at full width from their published
    configs with seeded HF
    checkpoints loaded through the port's remap (hf_model), each served as
    Llama-3-8B is (serve_family: graphed and eager, the teacher-forced
    check, TTFT and the graphed decode rate), then through the engines on
    BREADTH_SLOTS slots: GPT-NeoX through the paged engine
    (BREADTH_REQUESTS prompts) and the prefix-cached one, GPT-J through
    the prefix-cached one (BREADTH_REQUESTS prompts sharing PREFIX_SHARED
    tokens, admissions through B8), each engine's tokens held to a
    teacher-forced static decode (engine_agreement at
    MIN_ARGMAX_AGREEMENT, as Llama-3-8B's); each model freed before the
    next. Returns the launches of each run and the measurements."""
    rng = np.random.default_rng(22)
    launches, out = {}, {}
    for name, hf_cfg, family, spec_fn, seed, engines in (
            ("GPT-NeoX-20B", NEOX_20B, "gpt_neox", neox_spec, 15,
             (False, True)),
            ("GPT-J-6B", GPTJ_6B, "gptj", gptj_spec, 16, (True,))):
        if name in SERVE_LAYERS:
            hf_cfg = SimpleNamespace(
                **{**vars(hf_cfg), "num_hidden_layers": SERVE_LAYERS[name]})
        t0 = time.perf_counter()
        model, peak = hf_model(family, hf_cfg, spec_fn, seed)
        build_s = time.perf_counter() - t0
        print(f"{name} built from its config and a seeded HF checkpoint, "
              f"remapped a layer at a time, in {build_s:.1f} s; peak "
              f"{peak:.2f} GB while building (max_memory_allocated) on "
              f"{card}")
        launches[name], out[name] = serve_family(name, model, card, rng)
        out[name].update(build_s=build_s, build_peak_gb=peak)
        vocab = model.config.vocab_size
        paged = paged_view(model, BREADTH_SLOTS)
        for prefix in engines:
            if prefix:
                shared = rng.integers(0, vocab, PREFIX_SHARED)
                prompts = [np.concatenate([shared, rng.integers(
                    0, vocab, ENGINE_PROMPT - PREFIX_SHARED)])
                    for _ in range(BREADTH_REQUESTS)]
            else:
                prompts = list(rng.integers(
                    0, vocab, (BREADTH_REQUESTS, ENGINE_PROMPT)))
            ename = f"{name} {'prefix-cache' if prefix else 'paged'} engine"
            torch.cuda.reset_peak_memory_stats()
            launches[ename], tokens, out[ename] = run_engine(
                paged, prompts, prefix, card, slots=BREADTH_SLOTS,
                name=ename)
            out[ename]["agreement"], out[ename]["logit_gap"] = \
                engine_agreement(paged, prompts, tokens, ename,
                                 MIN_ARGMAX_AGREEMENT)
            out[ename]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            print(f"{ename}: peak {out[ename]['peak_gb']:.2f} GB "
                  f"(max_memory_allocated) with the agreement check")
            torch.cuda.empty_cache()
        del model, paged
        torch.cuda.empty_cache()
    return launches, out


def plain_bwd_refs(qt, kt, vt, dot, causal, lowprec: bool = True,
                   heads_bytes: float = 1.1e9, alibi_slopes=None, **band):
    """The 2x rule's references of a backward under the causal bound and
    ``band`` (window_size, sink_token_length, attention_chunk; softcap),
    each chunk with its rows' and heads' ``alibi_slopes``, a batch row
    and as many KV heads at a time as keep each fp32 score matrix within
    ``heads_bytes`` (64 heads' 2048 x 2048 fit at once; Mistral-7B's 8192 x
    8192 take a KV head's group): the plain fp32 forward (out) and backward
    (dq, dk, dv) from fp32 copies of the inputs, and with ``lowprec`` the
    low-precision ones (attention_ref and autograd through it in the
    inputs' type). Inputs (b, h, s, d) views; returns (out32, out_lp,
    grads32, grads_lp) with out32 and grads32 (b, h, s, d), out_lp and
    grads_lp (b, s, h, d) (left empty without ``lowprec``)."""
    from flash_attn_tpu_torch.dispatch.score import slopes_bh
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        attention_ref_grads,
    )

    b, h, sq, d = qt.shape
    h_k, sk = kt.shape[1], kt.shape[2]
    group = h // h_k
    per = max(1, int(heads_bytes // (group * sq * sk * 4)))
    sl = slopes_bh(alibi_slopes, b, h)
    out32 = torch.empty(qt.shape, device="cuda")
    g32 = [torch.empty(x.shape, device="cuda") for x in (qt, kt, vt)]
    out_lp = torch.empty_like(qt.transpose(1, 2))
    glp = [torch.empty_like(x.transpose(1, 2)) for x in (qt, kt, vt)]
    for bi in range(b):
        for k0 in range(0, h_k, per):
            ks = slice(k0, min(k0 + per, h_k))
            qs = slice(ks.start * group, ks.stop * group)
            chunk = [x[bi:bi + 1, hs] for x, hs in
                     ((qt, qs), (kt, ks), (vt, ks), (dot, qs))]
            part = dict(band) if sl is None else dict(
                band, alibi_slopes=sl[bi:bi + 1, qs])
            f32 = [x.float() for x in chunk[:3]]
            o, l = flash_fwd.flash_attention_fwd_plain(*f32, causal=causal,
                                                       **part)
            r = flash_bwd.flash_attention_bwd_plain(chunk[3].float(), *f32, o,
                                                    l, causal=causal, **part)
            out32[bi:bi + 1, qs] = o
            for i, hs in enumerate((qs, ks, ks)):
                g32[i][bi:bi + 1, hs] = r[i]
            del f32, o, l, r
            if lowprec:
                bshd = [x.transpose(1, 2) for x in chunk]
                out_lp[bi:bi + 1, :, qs] = attention_ref(
                    *bshd[:3], causal=causal, upcast=False, **part)[0]
                lp = attention_ref_grads(*bshd, causal=causal, upcast=False,
                                         **part)
                for i, hs in enumerate((qs, ks, ks)):
                    glp[i][bi:bi + 1, :, hs] = lp[i]
                del lp
    return out32, out_lp, g32, glp


def packed_forwards(qt, kt, vt, causal, **band):
    """B6's forward and B7 over the rows of B1's (b, h, s, d) views packed
    as b sequences (sq != sk allowed), under ``band`` (window_size,
    attention_chunk) when given: [(out, lse) of each] in B1's layout, out
    (b, h, sq, d) and lse (b, h, sq)."""
    from flash_attn_tpu_torch.kernels import flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp

    b, h, sq, d = qt.shape
    sk = kt.shape[2]
    cu_q, cu_k = (torch.arange(b + 1, dtype=torch.int32, device="cuda") * n
                  for n in (sq, sk))
    packed = [x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
              for x in (qt, kt, vt)]
    res = []
    for fwd in (flash_varlen.flash_attention_varlen_fwd,
                fvp.flash_attention_varlen_fwd_persistent):
        out, lse = fwd(*packed, cu_q, cu_k, sq, sk, causal=causal, **band)
        res.append((out.reshape(b, sq, h, d).transpose(1, 2),
                    lse.reshape(h, b, sq).transpose(0, 1)))
    return res


def kernel_resources(lib, marks):
    """Registers, stack and local (spilled) bytes a thread of each kernel of
    the built library whose mangled name holds every string of one entry of
    ``marks`` (label -> strings), read by cuobjdump -res-usage."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-res-usage", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    found = {}
    for name, usage in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", text):
        for label, parts in marks.items():
            if all(p in name for p in parts):
                fields = dict(re.findall(r"(REG|STACK|LOCAL):(\d+)", usage))
                found.setdefault(label, []).append(
                    {k: int(v) for k, v in fields.items()})
    require(set(found) == set(marks),
            f"cuobjdump found no kernel for {sorted(set(marks) - set(found))}")
    return found


def wide_bwd_timing(qt, kt, vt, dot, out, lse, causal, case):
    """At a family's training shape: B3, B2 and the preprocess, B6's forward,
    B7 and B6's backward (its three kernels by the profiler) over the same
    rows packed, each beside its bound, its plain version and a library
    call (SDPA's backward; SDPA's forward and backward over nested tensors
    for the packed ones). Returns the timings by row suffix."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp

    b, h, sq, d = qt.shape
    h_k, sk = kt.shape[1], kt.shape[2]
    pairs = b * attended_pairs([sq], [sk], causal)

    def bwd(det):
        return lambda: flash_bwd.flash_attention_bwd(
            dot, qt, kt, vt, out, lse, causal=causal, deterministic=det)
    ms, fused_ms = time_ms(bwd(True), runs=10), time_ms(bwd(False), runs=10)
    split = kernel_split_ms(bwd(True), ["preprocess_kernel", "dkdv_kernel",
                                        "dq_kernel"])
    plain_ms = time_ms(lambda: flash_bwd.flash_attention_bwd_plain(
        dot, qt, kt, vt, out, lse, causal=causal), runs=3, batch=1)
    pre_ms = time_ms(lambda: flash_bwd.bwd_preprocess(dot, out, lse))
    pre_plain_ms = time_ms(lambda: flash_bwd.bwd_preprocess_plain(
        dot, out, lse, 128))
    pre_lib_ms = time_ms(lambda: torch.linalg.vecdot(dot, out))
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, dot, retain_graph=True), runs=10)
    del sdpa_out, leaves
    # as time_bwd: 5 products over the pairs; q, k, v, out, dout read and
    # dq, dk, dv written once, lse read
    esz = qt.element_size()
    bwd_bound = bound(10 * h * d * pairs,
                      esz * (4 * b * sq * h * d + 4 * b * sk * h_k * d)
                      + 4 * b * h * sq)
    sq_pad = -(-sq // 128) * 128
    pre_bound = bound(2 * b * h * sq * d, esz * 2 * b * h * sq * d
                      + 4 * b * h * sq + 2 * 4 * b * h * sq_pad, PEAK_FP32)
    sdpa_bwd = {"library_ms": lib_ms,
                "library_call": "scaled_dot_product_attention backward "
                                "(torch.autograd.grad)"}
    t = {"flash_bwd": {"ms": ms, "plain_ms": plain_ms, **sdpa_bwd,
                       **bwd_bound, "kernel_split_ms": split},
         "flash_bwd_fused": {"ms": fused_ms, "plain_ms": plain_ms,
                             **sdpa_bwd, **bwd_bound},
         "flash_bwd_preprocess": {
             "ms": pre_ms, "plain_ms": pre_plain_ms, "library_ms": pre_lib_ms,
             "library_call": "torch.linalg.vecdot(dO, O) (in bf16)",
             **pre_bound}}

    # the same rows packed as b sequences: B6's forward, B7, B6's backward
    cu_q, cu_k = (torch.arange(b + 1, dtype=torch.int32, device="cuda") * n
                  for n in (sq, sk))
    q, k, v, do, o = (x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
                      for x in (qt, kt, vt, dot, out))
    lse_p = lse.permute(1, 0, 2).reshape(h, b * sq)
    args = (cu_q, cu_k, sq, sk)
    b6 = lambda: flash_varlen.flash_attention_varlen_fwd(q, k, v, *args,
                                                         causal=causal)
    b7 = lambda: fvp.flash_attention_varlen_fwd_persistent(q, k, v, *args,
                                                          causal=causal)
    vbwd = lambda: flash_varlen.flash_attention_varlen_bwd(
        do, q, k, v, o, lse_p, *args, causal=causal)
    lib_fwd, lib_bwd, lib_label = sdpa_varlen(
        q, k, v, cu_q, cu_k, [sq] * b, [sk] * b, causal, do)
    tv = {"fwd": time_ms(b6, runs=10), "persistent": time_ms(b7, runs=10),
          "bwd": time_ms(vbwd, runs=10), "lib_fwd": time_ms(lib_fwd, runs=10),
          "lib_bwd": time_ms(lib_bwd, runs=10)}
    vsplit = kernel_split_ms(vbwd, ("varlen_preprocess_kernel",
                                    "varlen_dkdv_kernel", "varlen_dq_kernel"))
    plain_f = wall_ms(lambda: flash_varlen.flash_attention_varlen_fwd_plain(
        q, k, v, *args, causal=causal))
    plain_p = wall_ms(lambda: fvp.flash_attention_varlen_fwd_persistent_plain(
        q, k, v, *args, causal=causal))
    plain_b = wall_ms(lambda: flash_varlen.flash_attention_varlen_bwd_plain(
        do, q, k, v, o, lse_p, *args, causal=causal))
    pre_plain = wall_ms(lambda: flash_varlen.varlen_bwd_preprocess_plain(
        do, o, lse_p, cu_q, None))
    del lib_fwd, lib_bwd
    # the bounds of check_varlen's rows
    rows_q, rows_k = b * sq, b * sk
    fwd_bound = bound(4 * h * d * pairs, esz * (2 * rows_q * h * d
                                                + 2 * rows_k * h_k * d)
                      + 4 * h * rows_q)
    qdo = esz * 2 * rows_q * h * d + 8 * h * rows_q
    kv = esz * 2 * rows_k * h_k * d
    lib_f = {"library_ms": tv["lib_fwd"], "library_call": lib_label}
    lib_b = {"library_ms": tv["lib_bwd"],
             "library_call": f"{lib_label}, backward (the dK/dV and dQ "
                             f"kernels' pair)"}
    t.update({
        "flash_varlen_fwd": {"ms": tv["fwd"], "plain_ms": plain_f, **lib_f,
                             **fwd_bound},
        "flash_varlen_fwd_persistent": {"ms": tv["persistent"],
                                        "plain_ms": plain_p, **lib_f,
                                        **fwd_bound},
        "fa_varlen_bwd_dkdv": {"ms": vsplit["varlen_dkdv_kernel"],
                               "plain_ms": plain_b, **lib_b,
                               **bound(8 * h * d * pairs,
                                       qdo + kv + 2 * esz * rows_k * h_k * d)},
        "fa_varlen_bwd_dq": {"ms": vsplit["varlen_dq_kernel"],
                             "plain_ms": plain_b, **lib_b,
                             **bound(6 * h * d * pairs,
                                     qdo + kv + esz * rows_q * h * d)},
        "flash_varlen_bwd_preprocess": {
            "ms": vsplit["varlen_preprocess_kernel"], "plain_ms": pre_plain,
            "library_ms": pre_lib_ms,
            "library_call": "torch.linalg.vecdot(dO, O) (in bf16)",
            **bound(2 * h * rows_q * d, esz * 2 * rows_q * h * d
                    + 4 * h * rows_q + 2 * 4 * h * rows_q, PEAK_FP32)}})
    for name, r in t.items():
        print(f"{name} d={d} at {case}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%), plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.4f} ms")
    print(f"flash_bwd d={d} profiler split (ms a call): " + ", ".join(
        f"{n} {v:.4f}" for n, v in split.items()) + "; B6 backward "
        f"{tv['bwd']:.4f} ms a call: " + ", ".join(
            f"{n} {v:.4f}" for n, v in vsplit.items()))
    return t


def check_wide_backward(gen, lib):
    """The backward kernels and the packed forwards at head dims 96 and 256
    (WIDE_FAMILIES' heads, WIDE_BWD_CASES): B3 and B2 against the plain fp32
    backward and the preprocess against its plain version (the 2x rule,
    plain_bwd_refs), B1 against the plain forward; B3 bitwise equal over two
    runs, B6's backward over the same rows packed bitwise equal to B3, B6's
    forward and B7 over them bitwise equal to B1, B6's preprocess to the
    dense one's rows. At the training shape: flash_attn_func(...).backward()
    with deterministic True and False (the counted run of B2), the timings
    (wide_bwd_timing), and the kernels' registers and spills. Returns the
    errors and timings by row name and the counted runs' launches."""
    from flash_attn_tpu_torch import flash_attn_func
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd, flash_varlen
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    errs, timings, api = {}, {}, {}
    for fam, d, h in WIDE_FAMILIES:
        for ci, (b, sq, sk, causal) in enumerate(WIDE_BWD_CASES):
            q, k, v, dout = (torch.randn(b, s, h, d, device="cuda",
                                         generator=gen).to(torch.bfloat16)
                             for s in (sq, sk, sk, sq))
            qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, dout))
            out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal)
            out32, out_lp, ref, ref_lp = plain_bwd_refs(qt, kt, vt, dot,
                                                        causal)
            case = (f"{fam}'s b={b} sq={sq} sk={sk} h={h} d={d} "
                    f"causal={causal}")
            err_f, _ = check_against_ref(out.transpose(1, 2),
                                         out32.transpose(1, 2), out_lp,
                                         msg=f"flash_fwd {case}")
            line = []
            for name, det in ((f"flash_bwd_d{d}", True),
                              (f"flash_bwd_fused_d{d}", False)):
                grads = flash_bwd.flash_attention_bwd(
                    dot, qt, kt, vt, out, lse, causal=causal,
                    deterministic=det)
                for gname, got, r, lp in zip("qkv", grads, ref, ref_lp):
                    err, err_lp = check_against_ref(
                        got.transpose(1, 2), r.transpose(1, 2), lp,
                        atol=BWD_ATOL, msg=f"{name} d{gname} {case}")
                    errs[name] = max(errs.get(name, 0.0), err)
                    line.append(f"{'B3' if det else 'B2'} d{gname} {err:.3e} "
                                f"(low-precision {err_lp:.3e})")
                if det:
                    b3 = grads
            again = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                                  causal=causal)
            require(all(torch.equal(a, c) for a, c in zip(b3, again)),
                    f"B3 differs between runs: {case}")
            b6 = packed_b6_backward(dot, qt, kt, vt, out, lse, causal)()
            require(all(torch.equal(a, c) for a, c in zip(b3, b6)),
                    f"B6's backward over the same rows packed differs from "
                    f"B3's: {case}")
            for label, (o, l) in zip(("B6's forward", "B7"),
                                     packed_forwards(qt, kt, vt, causal)):
                require(torch.equal(o, out) and torch.equal(l, lse),
                        f"{label} over the same rows packed differs from "
                        f"B1's: {case}")
            delta, lse2 = flash_bwd.bwd_preprocess(dot, out, lse)
            want_delta, want_lse2 = flash_bwd.bwd_preprocess_plain(
                dot, out, lse, delta.shape[-1])
            fin = torch.isfinite(want_lse2)
            require(torch.equal(torch.isfinite(lse2), fin)
                    and float((lse2[fin] - want_lse2[fin]).abs().max())
                    <= 1e-5, f"preprocess lse2: {case}")
            err = float((delta - want_delta).abs().max())
            require(err <= 1e-3, f"preprocess delta err {err}: {case}")
            # B6's preprocess over the same rows packed: the dense one's rows
            cu_q = torch.arange(b + 1, dtype=torch.int32, device="cuda") * sq
            cu_k = torch.arange(b + 1, dtype=torch.int32, device="cuda") * sk
            pk = [x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
                  for x in (dot, qt, kt, vt, out)]
            lse_p = lse.permute(1, 0, 2).reshape(h, b * sq).contiguous()
            meta = flash_varlen.varlen_meta(pk[1], pk[2], cu_q, cu_k, sq, sk,
                                            None, None, causal, None)
            vdelta, vlse2 = flash_varlen.varlen_bwd_preprocess(
                pk[0], pk[4], lse_p, cu_q, cu_k, meta,
                *(torch.empty_like(x) for x in pk[1:4]))
            for i in range(b):
                p0 = flash_varlen.padded_row(i * sq, i)
                require(torch.equal(vdelta[:, p0:p0 + sq], delta[i, :, :sq])
                        and torch.equal(vlse2[:, p0:p0 + sq],
                                        lse2[i, :, :sq]),
                        f"B6's preprocess differs from the dense one's: "
                        f"{case}")
            for name, e in ((f"flash_bwd_preprocess_d{d}", err),
                            (f"flash_varlen_bwd_preprocess_d{d}", err),
                            (f"fa_varlen_bwd_dkdv_d{d}", errs[f"flash_bwd_d{d}"]),
                            (f"fa_varlen_bwd_dq_d{d}", errs[f"flash_bwd_d{d}"]),
                            (f"flash_varlen_fwd_d{d}", err_f),
                            (f"flash_varlen_fwd_persistent_d{d}", err_f)):
                errs[name] = max(errs.get(name, 0.0), e)
            print(f"{case}: B1 out max abs err {err_f:.3e}; " + ", ".join(line)
                  + f"; B3 bitwise equal over two runs, B6's backward over "
                  f"the same rows packed bitwise equal to B3's, B6's forward "
                  f"and B7 to B1's, B6's preprocess to the dense one's; "
                  f"preprocess delta max abs err {err:.3e}, lse2 within 1e-5")
            if ci == 0:
                api[d] = {}
                for det in (True, False):
                    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                    torch.cuda.synchronize()
                    reset_kernel_counts()
                    flash_attn_func(*leaves, causal=causal,
                                    deterministic=det).backward(dout)
                    torch.cuda.synchronize()
                    got = {"flash_fwd": flash_fwd.launches,
                           "flash_bwd_preprocess":
                               flash_bwd.launches_preprocess,
                           "fa_bwd_dkdv": flash_bwd.launches_dkdv,
                           "fa_bwd_dq": flash_bwd.launches_dq,
                           "flash_bwd_fused": flash_bwd.launches_fused}
                    want = {"flash_fwd": 1, "flash_bwd_preprocess": 1,
                            "fa_bwd_dkdv": int(det), "fa_bwd_dq": int(det),
                            "flash_bwd_fused": int(not det)}
                    require(got == want, f"flash_attn_func backward at d={d} "
                                         f"(deterministic={det}): {got}")
                    if det:
                        require(all(torch.equal(leaf.grad, g.transpose(1, 2))
                                    for leaf, g in zip(leaves, b3)),
                                f"flash_attn_func's gradients at d={d} differ "
                                f"from B3's")
                    api[d][det] = got
                    del leaves
                print(f"flash_attn_func(...).backward() at {case}: launches "
                      f"{api[d][True]} (deterministic, gradients bitwise "
                      f"B3's) and {api[d][False]} (fused)")
                for suffix, r in wide_bwd_timing(qt, kt, vt, dot, out, lse,
                                                 causal, case).items():
                    timings[f"{suffix}_d{d}"] = r
            del q, k, v, dout, qt, kt, vt, dot, out, lse, out32, out_lp
            del ref, ref_lp, b3, b6, again, grads
            torch.cuda.empty_cache()
    marks = {}
    for d in (96, 256):
        for t, ty in (("bf16", "13__nv_bfloat16"), ("fp16", "6__half")):
            marks.update({
                f"dkdv d={d} {t}": ("dense_bwd11dkdv_kernel", ty,
                                    f"Li{d}ELb0ELb0E"),
                f"dkdv fused d={d} {t}": ("dense_bwd11dkdv_kernel", ty,
                                          f"Li{d}ELb1ELb0E"),
                f"dq d={d} {t}": ("dense_bwd9dq_kernel", ty, f"Li{d}ELb0E"),
                f"preprocess d={d} {t}": ("dense_bwd17preprocess_kernel", ty,
                                          f"Li{d}E"),
                f"varlen dkdv d={d} {t}": ("varlen_dkdv_kernel", ty,
                                           f"Li{d}ELb0E"),
                f"varlen dq d={d} {t}": ("varlen_dq_kernel", ty,
                                         f"Li{d}ELb0E"),
                f"B6 forward d={d} {t}": ("17varlen_fwd_kernel", ty,
                                          f"Li{d}ELb0E"),
                f"B7 d={d} {t}": ("varlen_fwd_persistent_kernel", ty,
                                  f"Li{d}ELb0E")})
    res = kernel_resources(lib, marks)
    print("registers / stack / local bytes a thread (cuobjdump -res-usage): "
          + "; ".join(f"{label} " + ", ".join(
              f"{u.get('REG')}/{u.get('STACK')}/{u.get('LOCAL')}" for u in us)
              for label, us in res.items()))
    return errs, timings, api, res


def run_packed_wide(gen, card):
    """Packed attention at head dims 96 and 256 on WIDE_FAMILIES' heads: a
    counted run at the training shape packed as TRAIN_BATCH sequences of
    TRAIN_SEQ (bench.py's varlen section's calls: flash_attn_varlen_func's
    B7, B6's forward, the backward from B7's residuals; B6 bitwise B7,
    then flash_attn_varlen_func(...).backward() bitwise that backward),
    then the packed MHA at the family's widths (WIDE_MHA_LENS, rotary as the
    family has it) forward and backward on the card against the same
    module on the CPU (the plain versions; fp32, and bf16 for the 2x rule)
    on its output and the gradients of x and both weights. Returns the
    counted runs' launches and the MHA errors."""
    from flash_attn_tpu_torch import flash_attn_varlen_func
    from flash_attn_tpu_torch.kernels import flash_varlen
    from flash_attn_tpu_torch.modules.mha import MHA
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    launches, errs = {}, {}
    for fam, d, h in WIDE_FAMILIES:
        n = TRAIN_BATCH * TRAIN_SEQ
        cu = torch.arange(TRAIN_BATCH + 1, dtype=torch.int32,
                          device="cuda") * TRAIN_SEQ
        q, k, v, dout = (torch.randn(n, h, d, device="cuda", generator=gen)
                         .to(torch.bfloat16) for _ in range(4))
        args = (cu, cu, TRAIN_SEQ, TRAIN_SEQ)
        torch.cuda.synchronize()
        reset_kernel_counts()
        out_r, lse_r, _ = flash_attn_varlen_func(q, k, v, *args, causal=True,
                                                 return_attn_probs=True)
        out_6, _ = flash_varlen.flash_attention_varlen_fwd(q, k, v, *args,
                                                           causal=True)
        grads = flash_varlen.flash_attention_varlen_bwd(
            dout, q, k, v, out_r, lse_r, *args, causal=True)
        torch.cuda.synchronize()
        got = kernel_counts()
        want = want_counts(flash_varlen_fwd=1, flash_varlen_fwd_persistent=1,
                           fa_varlen_bwd_preprocess=1, fa_varlen_bwd_dkdv=1,
                           fa_varlen_bwd_dq=1)
        require(got == want, f"{fam}'s packed run: launches {got}")
        require(torch.equal(out_6, out_r), f"{fam}: B7 differs from B6")
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        reset_kernel_counts()
        flash_attn_varlen_func(*leaves, *args, causal=True).backward(dout)
        torch.cuda.synchronize()
        api = kernel_counts()
        require(api == want_counts(flash_varlen_fwd_persistent=1,
                                   fa_varlen_bwd_preprocess=1,
                                   fa_varlen_bwd_dkdv=1, fa_varlen_bwd_dq=1),
                f"{fam}'s flash_attn_varlen_func backward launches {api}")
        require(all(torch.equal(leaf.grad, g)
                    for leaf, g in zip(leaves, grads)),
                f"{fam}: flash_attn_varlen_func's gradients differ from the "
                f"backward's on B7's residuals")
        launches[fam] = got
        print(f"{fam}'s heads ({h} of {d}) packed as {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}: launches {got}; B7 bitwise B6's forward; "
              f"flash_attn_varlen_func(...).backward() launches {api}, its "
              f"gradients bitwise those of the backward on B7's residuals")
        del q, k, v, dout, out_r, lse_r, out_6, grads, leaves

        # the packed MHA at the family's widths
        rot = {96: 24, 256: 64}[d]
        kw = dict(num_heads=h, causal=True, rotary_emb_dim=rot,
                  rotary_emb_interleaved=d == 256)
        mods = {dev: MHA(h * d, dtype=dt, device=dev, **kw)
                for dev, dt in (("cuda", torch.bfloat16),
                                ("cpu", torch.float32))}
        mods["cpu_bf16"] = MHA(h * d, dtype=torch.bfloat16, device="cpu",
                               **kw)
        with torch.no_grad():
            for name, prm in mods["cuda"].named_parameters():
                prm.normal_(0.0, 0.02 if name.endswith("bias")
                            else (h * d) ** -0.5, generator=gen)
        for key in ("cpu", "cpu_bf16"):
            mods[key].load_state_dict({n_: t.cpu() for n_, t in
                                       mods["cuda"].state_dict().items()})
        lens = WIDE_MHA_LENS
        cu_m = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                            dtype=torch.int32)
        x = torch.randn(sum(lens), h * d, device="cuda",
                        generator=gen).to(torch.bfloat16)
        g = torch.randn(sum(lens), h * d, device="cuda",
                        generator=gen).to(torch.bfloat16)
        results = {}
        for key, mod in mods.items():
            dev = "cuda" if key == "cuda" else "cpu"
            xi = x.detach().to(dev, mod.Wqkv.weight.dtype).requires_grad_()
            if key == "cuda":
                torch.cuda.synchronize()
                reset_kernel_counts()
            out = mod(xi, cu_seqlens=cu_m.to(dev), max_seqlen=max(lens))
            out.backward(g.to(dev, out.dtype))
            if key == "cuda":
                torch.cuda.synchronize()
                mha_launches = kernel_counts()
                require(mha_launches == want_counts(
                    flash_varlen_fwd_persistent=1, fa_varlen_bwd_preprocess=1,
                    fa_varlen_bwd_dkdv=1, fa_varlen_bwd_dq=1),
                    f"{fam}'s packed MHA launches {mha_launches}")
            results[key] = [out.detach(), xi.grad, mod.Wqkv.weight.grad,
                            mod.out_proj.weight.grad]
        line = []
        for i, what in enumerate(("out", "dx", "dWqkv", "dWout")):
            err, err_lp = check_against_ref(
                results["cuda"][i], results["cpu"][i], results["cpu_bf16"][i],
                atol=BWD_ATOL, msg=f"{fam}'s packed MHA {what}")
            errs[f"{fam} {what}"] = err
            line.append(f"{what} {err:.3e} (bf16 plain {err_lp:.3e})")
        print(f"{fam}'s packed MHA (width {h * d}, {h} heads of {d}, rotary "
              f"{rot}{' interleaved' if d == 256 else ''}, lengths {lens}) on "
              f"{card}: launches {mha_launches}; max abs err against the "
              f"plain fp32 module on the CPU " + ", ".join(line))
        del mods, results, x, g
        torch.cuda.empty_cache()
    return launches, errs


def run_wide_training(card):
    """GPT-J-6B and GPT-NeoX-20B trained at full width from their published
    config.json numbers (GPTJ_6B, NEOX_20B) with the depth cut to
    WIDE_TRAIN_LAYERS, seeded weights (the trainer's initialisation from
    its seed) and bf16 training state, each by fit_checked over a seeded
    token file of its vocabulary and a profile of one step (profile_step),
    then freed. Returns each run's launches and measurements."""
    from flash_attn_tpu_torch.models.hf_adapters import (
        gpt_neox_config_to_gpt_config,
        gptj_config_to_gpt_config,
    )

    launches, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, hf_cfg, convert, depth in (
                ("GPT-J-6B", GPTJ_6B, gptj_config_to_gpt_config, "n_layer"),
                ("GPT-NeoX-20B", NEOX_20B, gpt_neox_config_to_gpt_config,
                 "num_hidden_layers")):
            cut = SimpleNamespace(**{**vars(hf_cfg),
                                     depth: WIDE_TRAIN_LAYERS[name]})
            mcfg = convert(cut, dtype=torch.bfloat16)
            path = os.path.join(tmp, f"{name}.bin")
            write_token_file(path, mcfg.vocab_size)
            label = f"{name} training ({WIDE_TRAIN_LAYERS[name]} of " \
                    f"{getattr(hf_cfg, depth)} layers)"
            launches[name], out[name], trainer, loader = fit_checked(
                label, mcfg, path)
            profile_step(trainer, loader, f"one {label} step")
            r = out[name]
            print(f"{label}: step {r['step_ms']:.1f} ms (median of steps "
                  f"{TRAIN_WARM + 1}-{TRAIN_STEPS}), {r['tokens_per_s']:.0f} "
                  f"tokens/s, {r['tflops_per_s']:.1f} TFLOP/s "
                  f"(model_flops_per_token), peak {r['peak_gb']:.2f} GB "
                  f"(max_memory_allocated) on {card}")
            del trainer, loader
            torch.cuda.empty_cache()
    return launches, out


def run_remat():
    """The 913M GPT's training step (Trainer.train_step, b=4 x 2048, the
    training phase's settings) without remat and with GPTConfig(remat=True)
    under 'full' and 'dots', REMAT_STEPS steps each over the same batches:
    the losses must be bitwise equal across the three (the recompute runs
    the same deterministic kernels on the same inputs), the recompute must
    launch B1 once more a layer (32 a step, 16 without remat), and the peak
    memory (max_memory_allocated over the steps) must fall under both
    policies. Then one more forward reads what remat cuts: the memory the
    forward leaves held for the backward (its saved activations), and the
    peak over that forward and its backward, both above the memory held
    before it (the weights, masters and moments). Returns the readings."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.models.gpt import gpt_913m

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens.bin")
        write_token_file(path, gpt_913m().vocab_size)
        for label, fields in (("off", {}),
                              ("full", dict(remat=True, remat_policy="full")),
                              ("dots", dict(remat=True, remat_policy="dots"))):
            torch.cuda.empty_cache()
            tr = make_trainer(model=dataclasses.replace(gpt_913m(), **fields))
            it = iter(make_loader(path))
            batches = [tuple(map(tr._batch, next(it)))
                       for _ in range(REMAT_STEPS)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = (flash_fwd.launches, flash_bwd.launches_dkdv,
                      flash_bwd.launches_dq)
            losses, times = [], []
            for inp, lab in batches:
                t0 = time.perf_counter()
                losses.append(tr.train_step(inp, lab)[0].item())
                times.append(time.perf_counter() - t0)
            n_fwd, n_dkdv, n_dq = (a - b for a, b in zip(
                (flash_fwd.launches, flash_bwd.launches_dkdv,
                 flash_bwd.launches_dq), before))
            step_peak = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss = tr.compute_loss(*batches[0])
            held = (torch.cuda.memory_allocated() - base) / 1e9
            loss.backward()
            torch.cuda.synchronize()
            fwd_bwd_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            for p in tr.params.values():
                p.grad = None
            del loss
            res[label] = {
                "losses": losses,
                "step_ms": statistics.median(times[1:]) * 1e3,
                "peak_gb": step_peak, "activations_gb": held,
                "fwd_bwd_peak_gb": fwd_bwd_peak,
                "launches_per_step": {
                    "flash_fwd": n_fwd / REMAT_STEPS,
                    "fa_bwd_dkdv": n_dkdv / REMAT_STEPS,
                    "fa_bwd_dq": n_dq / REMAT_STEPS}}
            print(f"remat {label}: losses " + " ".join(
                f"{x:.6f}" for x in losses) + f"; step "
                f"{res[label]['step_ms']:.1f} ms (median of steps 2-"
                f"{REMAT_STEPS}); peak {res[label]['peak_gb']:.2f} GB "
                f"(max_memory_allocated); a forward holds "
                f"{held:.2f} GB for its backward, which peak "
                f"{fwd_bwd_peak:.2f} GB above the weights and optimizer "
                f"state; launches a step {res[label]['launches_per_step']}")
            del tr, it, batches
    n = gpt_913m().n_layer
    for label, fwd in (("off", n), ("full", 2 * n), ("dots", 2 * n)):
        require(res[label]["launches_per_step"] == {
            "flash_fwd": fwd, "fa_bwd_dkdv": n, "fa_bwd_dq": n},
            f"remat {label}: launches {res[label]['launches_per_step']}")
    for label in ("full", "dots"):
        require(res[label]["losses"] == res["off"]["losses"],
                f"remat {label}: losses {res[label]['losses']} differ from "
                f"the step without remat's {res['off']['losses']}")
        require(res[label]["peak_gb"] < res["off"]["peak_gb"],
                f"remat {label}: peak {res[label]['peak_gb']:.2f} GB not "
                f"below {res['off']['peak_gb']:.2f} GB without remat")
    return res


def run_dwconv(gen):
    """MHA(dwconv=True) at the 913M GPT's attention widths (2048, 16 heads
    of 128, full rotary, bf16, seeded weights and conv) on the card: a
    5-token prefill then 7 decode steps (B1, then B4 over the linear cache
    with the conv state rolled in place) against the module's train mode
    over the same 12 tokens (JAX tests/test_models_misc.py:187), both held
    to an fp32 copy of the module on the CPU by the 2x rule: the served
    outputs' error within twice train mode's (plus 1e-5). Returns the
    errors."""
    import copy

    from flash_attn_tpu_torch.kernels import flash_decode, flash_fwd
    from flash_attn_tpu_torch.models.gpt import reset_flax_defaults
    from flash_attn_tpu_torch.modules.mha import MHA, KVCache
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    b, s, t0 = 2, 12, 5
    mha = MHA(2048, 16, causal=True, rotary_emb_dim=128, dwconv=True,
              max_decode_seqlen=64, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    reset_flax_defaults(mha, g, lambda name: False)
    with torch.no_grad():
        mha.dwconv_kernel.normal_(0.0, 0.02, generator=g)
        mha.dwconv_bias.normal_(0.0, 0.02, generator=g)
    ref_mha = copy.deepcopy(mha).to("cpu", torch.float32)
    x = torch.randn(b, s, 2048, device="cuda", generator=gen).to(
        torch.bfloat16)
    f0, d0 = flash_fwd.launches, flash_decode.launches
    with torch.inference_mode():
        train = mha(x)
        cache = KVCache()
        outs = [mha(x[:, :t0], mode="prefill", cache=cache)]
        outs += [mha(x[:, t:t + 1], mode="decode", cache=cache)
                 for t in range(t0, s)]
        served = torch.cat(outs, 1)
        ref = ref_mha(x.float().cpu())
    torch.cuda.synchronize()
    require((flash_fwd.launches - f0, flash_decode.launches - d0)
            == (2, s - t0), "dwconv MHA: launches")
    err, err_train = check_against_ref(served, ref, train,
                                       msg="dwconv MHA prefill + decode")
    diff = (served - train).abs().max().item()
    print(f"dwconv MHA (2048 wide, 16 heads of 128, bf16): prefill {t0} + "
          f"decode {s - t0} tokens against the fp32 module: max abs err "
          f"{err:.3e}, train mode's {err_train:.3e} (2x rule); served vs "
          f"train mode max abs diff {diff:.3e}")
    return {"max_abs_err": err, "train_max_abs_err": err_train,
            "served_vs_train": diff}


@contextlib.contextmanager
def plain_vit_attention():
    """models/vit.py's attention through B1's plain version (fp32 products
    on the card) instead of the kernel: the plain run of the model."""
    from flash_attn_tpu_torch.kernels.flash_fwd import (
        flash_attention_fwd_plain,
    )
    from flash_attn_tpu_torch.models import vit

    def plain(q, k, v, causal=False):
        out, _ = flash_attention_fwd_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal)
        return out.transpose(1, 2)

    saved = vit.flash_attn_func
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    vit.flash_attn_func = plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        vit.flash_attn_func = saved
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def run_vit(gen, card):
    """ViT-L/16 at full depth on VIT_BATCH seeded 224 x 224 images: one
    forward through the kernels (depth B1 launches, none else), its logits
    held to the 2x rule against the same model in fp32 run on the plain
    versions, with the bf16 model on the plain versions as the
    low-precision reference; then the forward's device time and the
    host's time to enqueue it."""
    from flash_attn_tpu_torch.models import vit
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    cfg = vit.vit_config_from_hf(VIT_L16, VIT_CLASSES, dtype=torch.bfloat16)
    model = vit.VisionTransformer(cfg, device="cuda")
    sd = hf_weights(vit_spec(VIT_L16, VIT_CLASSES), 15)
    model.load_state_dict(vit.remap_state_dict_hf_vit(sd, cfg))
    del sd
    model.requires_grad_(False)
    n = cfg.img_size
    imgs = torch.randn(VIT_BATCH, n, n, cfg.in_chans, device="cuda",
                       generator=gen)

    def forward(m):
        with torch.inference_mode():
            return m(imgs)

    reset_kernel_counts()
    logits = forward(model)
    torch.cuda.synchronize()
    launches = kernel_counts()
    require(launches == want_counts(flash_fwd=cfg.depth),
            f"ViT-L/16 launch counts {launches}")
    require(logits.shape == (VIT_BATCH, VIT_CLASSES)
            and bool(torch.isfinite(logits).all()), "ViT-L/16 logits")
    ref_model = vit.VisionTransformer(
        dataclasses.replace(cfg, dtype=torch.float32), device="cuda")
    ref_model.load_state_dict(model.state_dict())
    with plain_vit_attention():
        lowp, ref = forward(model), forward(ref_model)
    err, err_lp = check_against_ref(logits, ref, lowp, msg="ViT-L/16 logits")
    del ref_model
    # one forward a batch: its ~400 launches and the next run's would
    # overflow the launch queue under the held stream
    ms = time_ms(lambda: forward(model), runs=10, batch=1)
    # the host's time to enqueue one forward, the stream held by a sleep
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    t0 = time.perf_counter()
    forward(model)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"ViT-L/16 ({n_params / 1e6:.1f}M parameters, {cfg.depth} layers, "
          f"{(n // cfg.patch_size) ** 2 + 1} tokens): b={VIT_BATCH} forward "
          f"{ms:.3f} ms ({VIT_BATCH / ms * 1e3:.0f} images/s, median of 10), "
          f"host enqueue {enqueue_ms:.2f} ms; "
          f"logits max abs err {err:.3e} against fp32 on the plain versions "
          f"(bf16 on the plain versions {err_lp:.3e}); launches {launches} on "
          f"{card}")
    return launches, {"forward_ms": ms, "images_per_s": VIT_BATCH / ms * 1e3,
                      "host_enqueue_ms": enqueue_ms,
                      "logit_err": err, "logit_err_bf16_plain": err_lp}


def band_fwd_refs(q, k, v, causal, band, heads_bytes: float = 2e9):
    """The fp32 plain forward (out, lse) and the bf16 reference
    (attention_ref, upcast=False) of (b, s, h, d) q, k, v under ``band``,
    computed a batch row and a few KV heads at a time so that no score
    matrix passes ``heads_bytes``. Returns (ref (b, h, sq, d), lse (b, h,
    sq), ref_lp (b, sq, h, d))."""
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import attention_ref

    b, sq, h, d = q.shape
    sk, h_k = k.shape[1], k.shape[2]
    group = h // h_k
    per = max(1, int(heads_bytes // (group * sq * sk * 4)))
    ref = torch.empty(b, h, sq, d, device="cuda")
    lse = torch.empty(b, h, sq, device="cuda")
    ref_lp = torch.empty_like(q)
    for bi in range(b):
        for k0 in range(0, h_k, per):
            ks, qs = slice(k0, k0 + per), slice(k0 * group,
                                                (k0 + per) * group)
            qc, kc, vc = (x[bi:bi + 1, :, hs] for x, hs in
                          ((q, qs), (k, ks), (v, ks)))
            o, l = flash_fwd.flash_attention_fwd_plain(
                *(x.transpose(1, 2).float() for x in (qc, kc, vc)),
                causal=causal, **band)
            ref[bi, qs], lse[bi, qs] = o[0], l[0]
            o_lp, _ = attention_ref(qc, kc, vc, causal=causal, upcast=False,
                                    **band)
            ref_lp[bi, :, qs] = o_lp[0]
            del o, l, o_lp
    return ref, lse, ref_lp


def band_fwd_case(gen, case, timed: bool):
    """B1's band instantiation on one BAND_FWD_CASES case against its plain
    version (the 2x rule against the fp32 plain forward with a bf16
    reference, lse within LSE_ATOL on the rows that see a key and -inf on
    the same rows), its launch counted as the band's, the same bits twice;
    timed beside the band-free kernel at the same shape, SDPA with the same
    boolean mask and a bound that counts only the pairs inside the band
    (with ``timed``, also the plain version). Returns the error and the
    timing."""
    from flash_attn_tpu_torch.dispatch.config import normalize_window
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    name, b, sq, sk, h, h_k, d, causal, window, chunk, sink = case
    band = dict(window_size=normalize_window(window), sink_token_length=sink,
                attention_chunk=chunk)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    q, k, v = randn(b, sq, h, d), randn(b, sk, h_k, d), randn(b, sk, h_k, d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    before = flash_fwd.launches_band
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal, **band)
    again = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal, **band)
    torch.cuda.synchronize()
    require(flash_fwd.launches_band == before + 2,
            f"flash_fwd {name}: the band instantiation did not run")
    ref, ref_lse, ref_lp = band_fwd_refs(q, k, v, causal, band)
    err, err_lp = check_against_ref(out.transpose(1, 2), ref.transpose(1, 2),
                                    ref_lp, msg=f"flash_fwd band {name}")
    fin = torch.isfinite(ref_lse)
    require(torch.equal(torch.isfinite(lse), fin),
            f"flash_fwd {name}: the rows that see no key differ")
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item()
    require(lse_err <= LSE_ATOL, f"flash_fwd {name}: lse error {lse_err}")
    require(torch.equal(again[0], out) and torch.equal(again[1], lse),
            f"flash_fwd {name}: two runs differ")
    no_key = int((~fin).sum())
    del ref, ref_lse, ref_lp, again
    mask = band_mask(sq, sk, causal, band["window_size"], sink, chunk)
    pairs = b * int(mask.sum())
    full = b * attended_pairs([sq], [sk], causal)
    ms = time_ms(lambda: flash_fwd.flash_attention_fwd(
        qt, kt, vt, causal=causal, **band))
    free_ms = time_ms(lambda: flash_fwd.flash_attention_fwd(
        qt, kt, vt, causal=causal))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=h != h_k), runs=10)
    timing = {"ms": ms, "band_free_ms": free_ms, "library_ms": lib_ms,
              "library_call": "scaled_dot_product_attention with the band "
                              "as a boolean mask"
                              + ", enable_gqa=True" * (h != h_k),
              "band_pairs": pairs, "causal_pairs": full,
              **bound(4 * h * d * pairs,
                      2 * (2 * b * sq * h * d + 2 * b * sk * h_k * d)
                      + 4 * b * h * sq)}
    if timed:
        timing["plain_ms"] = time_ms(
            lambda: flash_fwd.flash_attention_fwd_plain(
                qt, kt, vt, causal=causal, **band), runs=3, batch=1)
    print(f"flash_fwd band {name} (b={b}, sq={sq}, sk={sk}, {h}/{h_k} heads "
          f"of {d}, causal={causal}, window {band['window_size']}, chunk "
          f"{chunk}, sinks {sink}): out max abs err {err:.3e} (bf16 "
          f"reference {err_lp:.3e}), lse max abs err {lse_err:.3e}, "
          f"{no_key} rows with no key, bitwise equal twice; "
          f"{ms:.4f} ms, band-free kernel {free_ms:.4f} ms ("
          f"{'causal' if causal else 'all'} pairs: the band holds "
          f"{pairs / full:.3f} of them), masked "
          f"scaled_dot_product_attention {lib_ms:.4f} ms"
          + (f", plain {timing['plain_ms']:.2f} ms" if timed else "")
          + f"; bound {timing['bound_ms']:.4f} ms ({timing['bound_by']})")
    return err, timing


def band_decode_case(gen, case, timed: bool):
    """B4's d = dv route under the band on one BAND_DECODE_CASES case,
    linear or paged, against its plain version (the 2x rule against the
    fp32 plain decode run on the CPU with a bf16 reference, lse within
    LSE_ATOL), the split partials' lse -inf on the same (split, row)s as
    the plain version's, the same bits twice and the launch counted as the
    band's; timed beside
    the band-free kernel at the same lengths, SDPA with the band as a
    boolean mask over the (gathered) cache and a bound that counts only the
    keys and pairs inside the band (with ``timed``, also the plain
    version). Returns the error, the timing and the splits whose lse is
    -inf for some rows and finite for others."""
    from flash_attn_tpu_torch.cache.kvcache import _default_num_splits
    from flash_attn_tpu_torch.dispatch.band import band_span
    from flash_attn_tpu_torch.dispatch.config import (
        DECODE_BLOCK_K,
        normalize_window,
    )
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
        paged_to_linear,
    )

    name, b, sq, h, h_k, d, page, keys, window, chunk, splits = case
    window = normalize_window(window)
    band = dict(window_size=window, attention_chunk=chunk)
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(
        torch.bfloat16)
    if page:
        kc, vc, table = paged_cache(gen, b, h_k, d, page, keys,
                                    torch.bfloat16)
    else:
        s_max = -(-keys // 128) * 128
        kc, vc = (torch.randn(b, h_k, s_max, d, device="cuda",
                              generator=gen).to(torch.bfloat16)
                  for _ in range(2))
        table = None
    seqlens = torch.full((b,), keys, dtype=torch.int32, device="cuda")
    splits = splits or _default_num_splits(
        q, kc, vc, table, False, band_span(True, window, chunk, sq))
    counter = "launches_paged_band" if page else "launches_band"
    before = getattr(flash_decode, counter)
    out, lse = flash_decode.flash_attention_decode(
        q, kc, vc, seqlens, causal=True, num_splits=splits,
        block_table=table, **band)
    cpu = dict(block_table=None if table is None else table.cpu())
    ref, ref_lse = flash_decode.flash_attention_decode(
        q.float().cpu(), kc.float().cpu(), vc.float().cpu(), seqlens.cpu(),
        causal=True, num_splits=splits, **cpu, **band)
    scale = d ** -0.5
    part = flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, True, block_table=table, **band)
    again = flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, True, block_table=table, **band)
    part_ref = flash_decode.flash_attention_decode_partials(
        q.float().cpu(), kc.float().cpu(), vc.float().cpu(), seqlens.cpu(),
        splits, scale, True, **cpu, **band)
    torch.cuda.synchronize()
    require(getattr(flash_decode, counter) == before + 3,
            f"{name}: the band did not run")
    require(torch.equal(part[0], again[0]) and torch.equal(part[1], again[1]),
            f"{name}: two runs differ")
    empty = torch.isneginf(part[1]).cpu()
    require(torch.equal(empty, torch.isneginf(part_ref[1])),
            f"{name}: the splits without keys differ from the plain "
            "version's")
    lin = [x if table is None else
           paged_to_linear(x, table, seqlens) for x in (kc, vc)]
    keep = torch.arange(lin[0].shape[2], device="cuda")[None] \
        < seqlens[:, None]
    ref_lp, _ = attention_ref(q, lin[0].transpose(1, 2),
                              lin[1].transpose(1, 2), key_padding_mask=keep,
                              causal=True, upcast=False, **band)
    err, err_lp = check_against_ref(out, ref, ref_lp,
                                    msg=f"flash_decode band {name}")
    lse_err = (lse.cpu() - ref_lse).abs().max().item()
    require(lse_err <= LSE_ATOL, f"{name}: lse error {lse_err}")
    # (split, batch row, KV head) items with lse -inf on some rows only
    partial = int((empty.any(-1) & ~empty.all(-1)).sum())
    mask = band_mask(sq, keys, True, window, chunk=chunk, chunk_upper=False)
    pairs, read = b * int(mask.sum()), b * int(mask.any(0).sum())
    call = dict(block_table=table)
    ms = time_ms(lambda: flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, True, **call, **band))
    free_ms = time_ms(lambda: flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, True, **call))
    if table is None:
        qh = q.transpose(1, 2)
        lib_mask = (keep[:, None, None, :]
                    & band_mask(sq, kc.shape[2], True, window, chunk=chunk,
                                chunk_upper=False,
                                shift=keys - sq)[None, None])
        lib = lambda: F.scaled_dot_product_attention(
            qh, kc, vc, attn_mask=lib_mask, enable_gqa=h != h_k)
        lib_call = ("scaled_dot_product_attention with the band and the "
                    "lengths as a boolean mask over the linear cache")
    else:
        lib, _ = paged_sdpa(q, kc, vc, table, seqlens, True, None, window,
                            chunk)
        lib_call = ("the cache gathered through the block table to the "
                    "linear layout, then scaled_dot_product_attention with "
                    "the band and the lengths as a boolean mask (the gather "
                    "included)")
    timing = {"ms": ms, "band_free_ms": free_ms, "library_ms": time_ms(lib),
              "library_call": lib_call + ", enable_gqa=True" * (h != h_k),
              "num_splits": splits, "band_keys_read": read,
              **bound(4 * h * d * pairs,
                      2 * 2 * read * h_k * d + 2 * b * sq * h * d
                      + 4 * splits * b * sq * h * (d + 1)
                      + 4 * (b + (0 if table is None else table.numel())))}
    if timed:
        plain = (flash_decode.flash_attention_decode_partials_plain
                 if table is None else
                 flash_decode.flash_attention_decode_paged_partials_plain)
        extra = () if table is None else (table,)
        # host clock between synchronisations: under time_ms's held stream
        # the device caught up with this many small ops at every sleep
        timing["plain_ms"] = wall_ms(lambda: plain(
            q, kc, vc, seqlens, *extra, splits, DECODE_BLOCK_K, scale, True,
            **band), runs=5)
        timing["plain_clock"] = "host, between synchronisations"
    print(f"flash_decode{'_paged' if page else ''} band {name} (b={b}, "
          f"sq={sq}, {h}/{h_k} heads of {d}, {keys} keys, window {window}, "
          f"chunk {chunk}, {splits} splits): out max abs err {err:.3e} (bf16 "
          f"reference {err_lp:.3e}), lse max abs err {lse_err:.3e}, the "
          f"partials bitwise equal twice; "
          f"{int(empty.all(-1).sum())} split items without keys, {partial} "
          f"with keys for some rows only; {ms:.4f} ms, band-free kernel "
          f"{free_ms:.4f} ms, {timing['library_ms']:.4f} ms the yardstick"
          + (f", plain {timing['plain_ms']:.4f} ms" if timed else "")
          + f"; reads {read // b} of {keys} keys a row; bound "
          f"{timing['bound_ms']:.4f} ms ({timing['bound_by']})")
    return err, timing, partial


def check_band_kernels(gen):
    """The band masks on the card: B1 on BAND_FWD_CASES, B4 (linear, paged
    and the verify step) on BAND_DECODE_CASES and B8 at Mistral-7B's
    prefix-cached admission (BAND_VARLEN_CASE, whose window edge falls
    inside the shared pages) against their plain versions, each timed
    beside the band-free kernel, SDPA with the band's mask and a bound of
    the band's pairs. Returns errors and timings by kernels-line name."""
    from flash_attn_tpu_torch.utils.cases import (
        BAND_DECODE_CASES,
        BAND_FWD_CASES,
        BAND_VARLEN_CASE,
        MISTRAL_WINDOW,
    )

    errs, timings = {"flash_fwd_band": 0.0}, {"flash_fwd_band": {}}
    for i, case in enumerate(BAND_FWD_CASES):
        err, t = band_fwd_case(gen, case, timed=i == 0)
        errs["flash_fwd_band"] = max(errs["flash_fwd_band"], err)
        if i == 0:
            timings["flash_fwd_band"].update(t)
        else:
            timings["flash_fwd_band"].setdefault("cases", {})[case[0]] = t
        torch.cuda.empty_cache()
    timed = {"Mistral-7B decode step": "flash_decode_band",
             "Mistral-7B engine decode step": "flash_decode_paged_band",
             "Mistral-7B engine verify step":
                 "flash_decode_paged_band_verify"}
    below = 0
    for case in BAND_DECODE_CASES:
        row = timed.get(case[0], "flash_decode_paged_band" if case[6]
                        else "flash_decode_band")
        err, t, partial = band_decode_case(gen, case, case[0] in timed)
        errs[row] = max(errs.get(row, 0.0), err)
        if case[0] in timed:
            timings.setdefault(row, {}).update(t)
        else:
            timings.setdefault(row, {}).setdefault("cases", {})[case[0]] = t
        if case[0].startswith("a split below"):
            below = partial
    require(below > 0, "no split lay wholly below a later token's window")
    errs["flash_varlen_paged_band"], timings["flash_varlen_paged_band"] = \
        varlen_paged_case(gen, BAND_VARLEN_CASE, with_b6=False, timed=True,
                          window=MISTRAL_WINDOW)
    torch.cuda.empty_cache()
    return errs, timings


def run_mistral(card):
    """Mistral-7B-v0.1 at full width and SERVE_LAYERS of its 32 layers
    (MISTRAL_7B, its published config.json numbers), a seeded checkpoint
    in the HF names remapped a
    layer at a time through the port's Llama adapter, its window set on the
    adapter's config as the JAX package sets it (window_size = (4095, 0)):
    static serving of MISTRAL_BATCH x MISTRAL_PROMPT tokens to
    MISTRAL_NEW new ones, graphed and eager (serve_static: bitwise equal
    tokens, the teacher-forced check, every launch the band's), TTFT and
    the decode rate beside the weights' read; the window in force (the
    same weights without it give last-position logits that differ by more
    than the decode's own bf16 noise, both TTFTs printed); then the paged
    engine (MISTRAL_SLOTS requests of MISTRAL_ENGINE_PROMPT tokens on as
    many slots), the prefix-cached engine (prompts sharing MISTRAL_PREFIX
    tokens: admissions through B8 with the window's edge inside the shared
    pages) and the speculative engine with the target as its own draft,
    each held to a teacher-forced static decode (engine_agreement) or to
    the plain engine (spec_vs_plain). Returns launches and measurements."""
    from flash_attn_tpu_torch.utils.cases import MISTRAL_WINDOW

    rng = np.random.default_rng(23)
    launches, out = {}, {}
    window = (MISTRAL_7B.sliding_window - 1, 0)
    require(window == MISTRAL_WINDOW, "Mistral-7B's window")
    t0 = time.perf_counter()
    cut = SimpleNamespace(**{**vars(MISTRAL_7B),
                             "num_hidden_layers": SERVE_LAYERS["Mistral-7B"]})
    model, peak = hf_model("llama", cut, llama_spec, 17,
                           max_decode_seqlen=MISTRAL_PROMPT + MISTRAL_NEW,
                           window_size=window)
    build_s = time.perf_counter() - t0
    cfg = model.config
    print(f"Mistral-7B built from its config (the Llama adapter, window "
          f"{cfg.window_size}) and a seeded HF checkpoint in {build_s:.1f} s "
          f"(peak {peak:.2f} GB) on {card}")
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (MISTRAL_BATCH, MISTRAL_PROMPT)),
                          device="cuda")
    name = "Mistral-7B"
    launches[name], _, noise = serve_static(model, ids, name, MISTRAL_NEW,
                                            band=True)
    ttft, tok_s = static_rates(model, ids, modes=(True, False),
                               new_tokens=MISTRAL_NEW)
    model._decode_state = None
    full = model_view(model, window_size=(-1, -1))
    ttft_full, _ = static_rates(full, ids, modes=(), new_tokens=MISTRAL_NEW)
    with torch.inference_mode():
        last = model.logits(model.forward_hidden(ids)[:, -1:]).float()
        last_full = full.logits(full.forward_hidden(ids)[:, -1:]).float()
    gap = (last - last_full).abs().max().item()
    same_top = (last.argmax(-1) == last_full.argmax(-1)).float().mean().item()
    print(f"{name}: the window in force: last-position logits with and "
          f"without it differ by {gap:.4f} at most (the decode's own bf16 "
          f"noise against the teacher-forced forward: {noise:.4f}), the same "
          f"top token in {same_top:.2f} of the rows; TTFT {ttft * 1e3:.2f} ms "
          f"with the window (the band kernel), {ttft_full * 1e3:.2f} ms "
          f"without (b={MISTRAL_BATCH} x {MISTRAL_PROMPT})")
    require(gap > noise, f"{name}: the window changes the logits by no more "
            "than the bf16 noise")
    del full
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    out[name] = {"params_b": n_params / 1e9, "layers": cfg.n_layer,
                 "build_s": build_s, "build_peak_gb": peak,
                 "ttft_ms": ttft * 1e3, "ttft_without_window_ms":
                     ttft_full * 1e3,
                 "decode_tokens_per_s": tok_s[True][0],
                 "decode_tokens_per_s_eager": tok_s[False][0],
                 "decode_step_ms": MISTRAL_BATCH / tok_s[True][0] * 1e3,
                 "weight_read_ms": weight_bytes / PEAK_BYTES * 1e3,
                 "window_logit_gap": gap, "decode_noise": noise}
    print(f"{name} ({n_params / 1e9:.2f}B parameters, {cfg.n_layer} layers, "
          f"width {cfg.n_embd}, {cfg.n_head}/{cfg.n_head_kv} heads, window "
          f"{window}): TTFT {ttft * 1e3:.2f} ms, decode "
          f"{tok_s[True][0]:.1f} tokens/s graphed ({tok_s[False][0]:.1f} "
          f"eager), a step {out[name]['decode_step_ms']:.3f} ms against "
          f"{out[name]['weight_read_ms']:.3f} ms to read its "
          f"{weight_bytes / 1e9:.2f} GB of weights once at 3.35 TB/s, on "
          f"{card}")
    torch.cuda.empty_cache()

    vocab = cfg.vocab_size
    paged = paged_view(model, MISTRAL_SLOTS, MISTRAL_ENGINE_MAX_LEN)
    kw = dict(slots=MISTRAL_SLOTS, max_len=MISTRAL_ENGINE_MAX_LEN,
              new_tokens=MISTRAL_ENGINE_NEW,
              admit_tokens=MISTRAL_SLOTS * 8192,
              warm_prompt=MISTRAL_ENGINE_PROMPT, band=True)
    prompts = list(rng.integers(0, vocab,
                                (MISTRAL_SLOTS, MISTRAL_ENGINE_PROMPT)))
    shared = rng.integers(0, vocab, MISTRAL_PREFIX)
    px = [np.concatenate([shared, rng.integers(
        0, vocab, MISTRAL_ENGINE_PROMPT - MISTRAL_PREFIX)])
        for _ in range(MISTRAL_SLOTS)]
    tokens = {}
    for ename, trace, prefix in (("paged engine", prompts, False),
                                 ("prefix-cache engine", px, True)):
        ename = f"{name} {ename}"
        torch.cuda.reset_peak_memory_stats()
        launches[ename], tokens[ename], out[ename] = run_engine(
            paged, trace, prefix, card, name=ename, **kw)
        out[ename]["agreement"], out[ename]["logit_gap"] = engine_agreement(
            paged, trace, tokens[ename], ename, MIN_ARGMAX_AGREEMENT)
        out[ename]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
    ename = f"{name} speculative engine"
    launches[ename], spec, out[ename] = run_engine(
        paged, prompts, False, card, name=ename, draft=linear_view(paged),
        **kw)
    out[ename]["equal_to_plain"] = spec_vs_plain(
        paged, prompts, spec, tokens[f"{name} paged engine"], ename)
    del model, paged
    torch.cuda.empty_cache()
    return launches, out


def plain_band_chunks(qt, kt, vt, dot, out, lse, causal, band,
                      heads_bytes: float = 4.4e9):
    """Functions running the plain fp32 band forward and backward over (b,
    h, s, d) views a few KV heads at a time (no fp32 score matrix past
    ``heads_bytes``): the plain versions' work at a shape whose whole
    score matrices would not fit beside one another, for timing. ``band``
    may hold softcap, alibi_slopes and learnable_sink too (each chunk takes
    its heads')."""
    from flash_attn_tpu_torch.dispatch.score import slopes_bh
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd

    b, h, sq, d = qt.shape
    h_k, sk = kt.shape[1], kt.shape[2]
    group = h // h_k
    per = max(1, int(heads_bytes // (b * group * sq * sk * 4)))
    sl = slopes_bh(band.get("alibi_slopes"), b, h)
    sink = band.get("learnable_sink")
    parts = [(slice(k0 * group, min(k0 + per, h_k) * group),
              slice(k0, min(k0 + per, h_k))) for k0 in range(0, h_k, per)]

    def kw(qs):
        return dict(band, alibi_slopes=None if sl is None else sl[:, qs],
                    learnable_sink=None if sink is None else sink[qs])

    def fwd():
        for qs, ks in parts:
            flash_fwd.flash_attention_fwd_plain(qt[:, qs], kt[:, ks],
                                                vt[:, ks], causal=causal,
                                                **kw(qs))

    def bwd():
        for qs, ks in parts:
            flash_bwd.flash_attention_bwd_plain(
                dot[:, qs], qt[:, qs], kt[:, ks], vt[:, ks], out[:, qs],
                lse[:, qs], causal=causal, **kw(qs))
    return fwd, bwd, len(parts)


def band_bwd_timing(qt, kt, vt, dot, out, lse, causal, band, case):
    """At Mistral-7B's training shape: B3's and B2's band instantiations
    beside the band-free pair at the same shape, and B6's band forward, B7's
    and B6's band backward (its kernels by the profiler) over the same rows
    packed, each beside its bound (counting only the pairs inside the band),
    its plain version (a KV head's group at a time) and SDPA with the band
    as a boolean mask (K and V repeated to the query heads). Returns the
    timings by kernels-line row."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd, flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp

    b, h, sq, d = qt.shape
    h_k, sk = kt.shape[1], kt.shape[2]
    group = h // h_k
    esz = qt.element_size()
    mask = band_mask(sq, sk, causal, band["window_size"],
                     band["sink_token_length"], band["attention_chunk"])
    pairs = b * int(mask.sum())
    causal_pairs = b * attended_pairs([sq], [sk], causal)

    def bwd(det):
        return lambda: flash_bwd.flash_attention_bwd(
            dot, qt, kt, vt, out, lse, causal=causal, deterministic=det,
            **band)
    ms, fused_ms = time_ms(bwd(True), runs=10), time_ms(bwd(False), runs=10)
    split = kernel_split_ms(bwd(True), ["preprocess_kernel", "dkdv_kernel",
                                        "dq_kernel"])
    fused_split = kernel_split_ms(bwd(False), ["preprocess_kernel",
                                               "dkdv_kernel"])
    out_f, lse_f = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal)
    free_ms = time_ms(lambda: flash_bwd.flash_attention_bwd(
        dot, qt, kt, vt, out_f, lse_f, causal=causal), runs=10)
    free_split = kernel_split_ms(lambda: flash_bwd.flash_attention_bwd(
        dot, qt, kt, vt, out_f, lse_f, causal=causal),
        ["preprocess_kernel", "dkdv_kernel", "dq_kernel"])
    del out_f, lse_f
    plain_fwd, plain_bwd, n_parts = plain_band_chunks(qt, kt, vt, dot, out,
                                                      lse, causal, band)
    plain_ms = time_ms(plain_bwd, runs=3, batch=1)
    plain_fwd_ms = time_ms(plain_fwd, runs=3, batch=1)
    plain_label = (f"the plain fp32 band version, {n_parts} calls of "
                   f"{h // n_parts} query heads")
    rep = [x.repeat_interleave(group, dim=1) for x in (kt, vt)]
    leaves = [x.detach().requires_grad_() for x in (qt, *rep)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, dot, retain_graph=True), runs=10)
    del sdpa_out, leaves
    lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, *rep, attn_mask=mask), runs=10)
    del rep
    lib = ("scaled_dot_product_attention with the band as a boolean mask, "
           "K and V repeated to the query heads")
    # 5 products over the band's pairs; q, k, v, out, dout read and dq, dk,
    # dv written once, lse read
    bwd_bound = bound(10 * h * d * pairs,
                      esz * (4 * b * sq * h * d + 4 * b * sk * h_k * d)
                      + 4 * b * h * sq)
    common = {"plain_ms": plain_ms, "plain_call": plain_label,
              "library_ms": lib_ms, "library_call": lib + ", backward "
              "(torch.autograd.grad)", "band_pairs": pairs,
              "causal_pairs": causal_pairs, **bwd_bound}
    t = {"flash_bwd_band": {"ms": ms, "band_free_ms": free_ms,
                            "kernel_split_ms": split,
                            "band_free_kernel_split_ms": free_split,
                            **common},
         "flash_bwd_fused_band": {"ms": fused_ms, "kernel_split_ms":
                                  fused_split, **common}}

    # the same rows packed as b sequences
    cu_q, cu_k = (torch.arange(b + 1, dtype=torch.int32, device="cuda") * n
                  for n in (sq, sk))
    q, k, v, do, o = (x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
                      for x in (qt, kt, vt, dot, out))
    lse_p = lse.permute(1, 0, 2).reshape(h, b * sq).contiguous()
    args = (cu_q, cu_k, sq, sk)
    vband = dict(window_size=band["window_size"],
                 attention_chunk=band["attention_chunk"])
    b6 = lambda: flash_varlen.flash_attention_varlen_fwd(
        q, k, v, *args, causal=causal, **vband)
    b7 = lambda: fvp.flash_attention_varlen_fwd_persistent(
        q, k, v, *args, causal=causal, **vband)
    vbwd = lambda: flash_varlen.flash_attention_varlen_bwd(
        do, q, k, v, o, lse_p, *args, causal=causal, **vband)
    vsplit = kernel_split_ms(vbwd, ("varlen_preprocess_kernel",
                                    "varlen_dkdv_kernel", "varlen_dq_kernel"))
    fwd_bound = bound(4 * h * d * pairs,
                      esz * (2 * b * sq * h * d + 2 * b * sk * h_k * d)
                      + 4 * b * h * sq)
    qdo = esz * 2 * b * sq * h * d + 8 * b * h * sq
    kv = esz * 2 * b * sk * h_k * d
    lib_f = {"library_ms": lib_fwd_ms, "library_call": lib,
             "plain_ms": plain_fwd_ms, "plain_call": plain_label,
             "band_pairs": pairs}
    lib_b = {"library_ms": lib_ms, "library_call": lib + ", backward (the "
             "dK/dV and dQ kernels' pair)", "plain_ms": plain_ms,
             "plain_call": plain_label, "band_pairs": pairs}
    t.update({
        "flash_varlen_fwd_band": {"ms": time_ms(b6, runs=10), **lib_f,
                                  **fwd_bound},
        "flash_varlen_fwd_persistent_band": {"ms": time_ms(b7, runs=10),
                                             **lib_f, **fwd_bound},
        "fa_varlen_bwd_dkdv_band": {
            "ms": vsplit["varlen_dkdv_kernel"], **lib_b,
            **bound(8 * h * d * pairs, qdo + kv + 2 * esz * b * sk * h_k * d)},
        "fa_varlen_bwd_dq_band": {
            "ms": vsplit["varlen_dq_kernel"], **lib_b,
            **bound(6 * h * d * pairs, qdo + kv + esz * b * sq * h * d)}})
    for name, r in t.items():
        print(f"{name} at {case}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%), plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.4f} ms"
              + (f", band-free pair {r['band_free_ms']:.4f} ms"
                 if "band_free_ms" in r else ""))

    def ms_list(d):
        return ", ".join(f"{n} {x:.4f}" for n, x in d.items())
    print(f"flash_bwd_band profiler split at {case} (ms a call): "
          f"{ms_list(split)}; band-free: {ms_list(free_split)}; the band "
          f"holds {pairs / causal_pairs:.3f} of the causal pairs; B6's band "
          f"backward a call: {ms_list(vsplit)}")
    return t


def band_bwd_case(gen, case, timed: bool):
    """B3's and B2's band instantiations and the preprocess on one
    BAND_BWD_CASES case: dq, dk, dv by the 2x rule against the plain fp32
    band backward (plain_bwd_refs), each launch counted as the band's, B3
    the same bits twice, the preprocess against its plain version; without
    sinks (the varlen route takes none) B6's band backward over the same
    rows packed gives B3's bits and B6's band forward and B7's give B1's.
    With ``timed`` (Mistral-7B's training shape): B3's gradients must lie
    BAND_GAP times farther (L2) from the plain band-free backward's than
    from the plain band backward's, flash_attn_func(...).backward() is
    counted both ways, and
    band_bwd_timing times the kernels. Returns the errors by kernels-line
    row, the timings and the counted runs' launches."""
    from flash_attn_tpu_torch import flash_attn_func
    from flash_attn_tpu_torch.dispatch.config import normalize_window
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    name, b, sq, sk, h, h_k, d, causal, window, chunk, sink = case
    band = dict(window_size=normalize_window(window), sink_token_length=sink,
                attention_chunk=chunk)
    q, k, v, dout = (torch.randn(b, s, n, d, device="cuda",
                                 generator=gen).to(torch.bfloat16)
                     for s, n in ((sq, h), (sk, h_k), (sk, h_k), (sq, h)))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, dout))
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal, **band)
    torch.cuda.synchronize()
    reset_kernel_counts()
    b3 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                       causal=causal, **band)
    again = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                          causal=causal, **band)
    b2 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                       causal=causal, deterministic=False,
                                       **band)
    torch.cuda.synchronize()
    got = bwd_counts()
    require(got == {"flash_fwd": 0, "flash_fwd_band": 0,
                    "flash_bwd_preprocess": 3, "fa_bwd_dkdv": 2,
                    "fa_bwd_dq": 2, "flash_bwd_fused": 1,
                    "fa_bwd_dkdv_band": 2, "fa_bwd_dq_band": 2,
                    "flash_bwd_fused_band": 1, **NO_SCORE},
            f"band backward launches at {name}: {got}")
    require(all(torch.equal(a, c) for a, c in zip(b3, again)),
            f"B3's band instantiation differs between runs: {name}")
    _, _, ref, ref_lp = plain_bwd_refs(qt, kt, vt, dot, causal, **band)
    errs, line = {}, []
    for row, grads in (("flash_bwd_band", b3), ("flash_bwd_fused_band", b2)):
        for gname, g, r, lp in zip("qkv", grads, ref, ref_lp):
            err, err_lp = check_against_ref(
                g.transpose(1, 2), r.transpose(1, 2), lp, atol=BWD_ATOL,
                msg=f"{row} d{gname} {name}")
            errs[row] = max(errs.get(row, 0.0), err)
            line.append(f"{'B3' if row == 'flash_bwd_band' else 'B2'} "
                        f"d{gname} {err:.3e} (bf16 {err_lp:.3e})")
    del ref_lp, b2, again
    delta, lse2 = flash_bwd.bwd_preprocess(dot, out, lse)
    want_delta, want_lse2 = flash_bwd.bwd_preprocess_plain(
        dot, out, lse, delta.shape[-1])
    fin = torch.isfinite(want_lse2)
    require(torch.equal(torch.isfinite(lse2), fin)
            and float((lse2[fin] - want_lse2[fin]).abs().max()) <= 1e-5,
            f"preprocess lse2 at {name}")
    pre_err = float((delta - want_delta).abs().max())
    require(pre_err <= 1e-3, f"preprocess delta err {pre_err} at {name}")
    no_key = int((~torch.isfinite(lse)).sum())
    extra = ""
    if timed:
        _, _, free, _ = plain_bwd_refs(qt, kt, vt, dot, causal,
                                       lowprec=False)

        def l2(refs):
            return math.sqrt(sum(float((g.float() - r).square().sum())
                                 for g, r in zip(b3, refs)))
        gap, own = l2(free), l2(ref)
        gap_max = max(float((g - r).abs().max()) for g, r in zip(b3, free))
        require(gap > BAND_GAP * own,
                f"{name}: B3's band gradients differ from the plain band-free "
                f"backward's by {gap} (L2), not {BAND_GAP}x their "
                f"difference {own} from the plain band backward's")
        extra = (f"; L2 distance to the plain band-free backward {gap:.3e}, "
                 f"{gap / own:.1f}x its distance to the plain band backward "
                 f"{own:.3e} (max abs {gap_max:.3e} against "
                 f"{errs['flash_bwd_band']:.3e}): the window is in force")
        del free
    del ref
    if sink == 0:
        vband = dict(window_size=band["window_size"], attention_chunk=chunk)
        reset_kernel_counts()
        b6 = packed_b6_backward(dot, qt, kt, vt, out, lse, causal, **vband)()
        require(all(torch.equal(a, c) for a, c in zip(b3, b6)),
                f"B6's band backward over the same rows packed differs from "
                f"B3's: {name}")
        for label, (o, l) in zip(("B6's band forward", "B7's"),
                                 packed_forwards(qt, kt, vt, causal,
                                                 **vband)):
            require(torch.equal(o, out) and torch.equal(l, lse),
                    f"{label} over the same rows packed differs from B1's "
                    f"band instantiation: {name}")
        torch.cuda.synchronize()
        packed = got = kernel_counts()
        require(got == want_counts(
            flash_varlen_fwd=1, flash_varlen_fwd_band=1,
            flash_varlen_fwd_persistent=1,
            flash_varlen_fwd_persistent_band=1, fa_varlen_bwd_preprocess=1,
            fa_varlen_bwd_dkdv=1, fa_varlen_bwd_dkdv_band=1,
            fa_varlen_bwd_dq=1, fa_varlen_bwd_dq_band=1),
            f"packed band launches at {name}: {got}")
        ref_f, _, ref_f_lp = band_fwd_refs(q, k, v, causal, band)
        err_f, _ = check_against_ref(out.transpose(1, 2),
                                     ref_f.transpose(1, 2), ref_f_lp,
                                     msg=f"flash_fwd band {name}")
        del ref_f, ref_f_lp, b6
        for row, e in (("fa_varlen_bwd_dkdv_band", errs["flash_bwd_band"]),
                       ("fa_varlen_bwd_dq_band", errs["flash_bwd_band"]),
                       ("flash_varlen_fwd_band", err_f),
                       ("flash_varlen_fwd_persistent_band", err_f)):
            errs[row] = e
        extra += ("; B6's band backward over the same rows packed bitwise "
                  "B3's, B6's band forward and B7's bitwise B1's")
    print(f"band backward {name} (b={b}, sq={sq}, sk={sk}, {h}/{h_k} heads "
          f"of {d}, causal={causal}, window {band['window_size']}, chunk "
          f"{chunk}, sinks {sink}; {no_key} rows with no key): "
          + ", ".join(line) + f"; B3 bitwise equal twice; preprocess delta "
          f"max abs err {pre_err:.3e}, lse2 within 1e-5" + extra)
    timings, api = {}, {}
    if timed:
        api["packed"] = packed
        for det in (True, False):
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            torch.cuda.synchronize()
            reset_kernel_counts()
            flash_attn_func(*leaves, causal=causal, deterministic=det,
                            **band).backward(dout)
            torch.cuda.synchronize()
            got = bwd_counts()
            require(got == {"flash_fwd": 1, "flash_fwd_band": 1,
                            "flash_bwd_preprocess": 1,
                            "fa_bwd_dkdv": int(det), "fa_bwd_dq": int(det),
                            "flash_bwd_fused": int(not det),
                            "fa_bwd_dkdv_band": int(det),
                            "fa_bwd_dq_band": int(det),
                            "flash_bwd_fused_band": int(not det),
                            **NO_SCORE},
                    f"flash_attn_func band backward at {name} "
                    f"(deterministic={det}): {got}")
            if det:
                require(all(torch.equal(leaf.grad, g.transpose(1, 2))
                            for leaf, g in zip(leaves, b3)),
                        f"flash_attn_func's band gradients at {name} differ "
                        f"from B3's")
            api[det] = got
            del leaves
        print(f"flash_attn_func(..., window_size={window}).backward() at "
              f"{name}: launches {api[True]} (deterministic, gradients "
              f"bitwise B3's) and {api[False]} (fused)")
        timings = band_bwd_timing(qt, kt, vt, dot, out, lse, causal, band,
                                  name)
    return errs, timings, api


def band_reach_check(gen):
    """A window that reaches every key masks nothing: the dense backward
    (both modes), B6's forward, B7 and B6's backward run their band-free
    kernels (no band launch counted) and give the bits of the call
    without a window."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd

    b, s, h, d = 2, 1000, 16, 128
    q, k, v, dout = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                     .to(torch.bfloat16) for _ in range(4))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, dout))
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=True)

    def calls(window):
        res = [flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                             causal=True, deterministic=det,
                                             window_size=window)
               for det in (True, False)]
        res += packed_forwards(qt, kt, vt, True, window_size=window)
        res.append(packed_b6_backward(dot, qt, kt, vt, out, lse, True,
                                      window_size=window)())
        return res

    base = calls((None, None))
    torch.cuda.synchronize()
    reset_kernel_counts()
    wide = calls((s - 1, 0))
    torch.cuda.synchronize()
    counts = {**kernel_counts(), **bwd_counts()}
    bands = {n: c for n, c in counts.items() if "band" in n and c}
    require(not bands and counts["fa_bwd_dkdv"] == 1 and
            counts["flash_bwd_fused"] == 1 and
            counts["flash_varlen_fwd_persistent"] == 1,
            f"a window that reaches every key launched {bands or counts}")
    for i, (x, y) in enumerate(zip(base, wide)):
        same = [torch.equal(a, c) for a, c in zip(x, y)]
        # B2's dq sums with atomics: its bits may vary from run to run
        require(all(same if i != 1 else same[1:]),
                f"a window that reaches every key changed call {i}'s bits")
    print(f"window ({s - 1}, 0) over {s} keys (b={b}, {h} heads of {d}): the "
          f"band-free kernels ran (B3, B2, B6's forward, B7, B6's backward; "
          f"no band launch) with the bits of the call without a window")


def check_band_backward(gen, lib):
    """The band masks in training on the card: band_bwd_case on every
    BAND_BWD_CASES case (Mistral-7B's training shape timed), a window that
    reaches every key (band_reach_check), and the band instantiations'
    registers and spills (cuobjdump -res-usage). Returns the errors and
    timings by kernels-line row, the counted flash_attn_func runs'
    launches and the registers."""
    from flash_attn_tpu_torch.utils.cases import BAND_BWD_CASES

    errs, timings, api = {}, {}, {}
    for i, case in enumerate(BAND_BWD_CASES):
        e, t, a = band_bwd_case(gen, case, timed=i == 0)
        for row, x in e.items():
            errs[row] = max(errs.get(row, 0.0), x)
        timings.update(t)
        api.update(a)
        torch.cuda.empty_cache()
    band_reach_check(gen)
    marks = {}
    for d in (64, 96, 128, 256):
        ty = "13__nv_bfloat16"
        # the band instantiations (BAND without SCORE: the last flag 0)
        marks.update({
            f"band dkdv d={d}": ("dense_bwd11dkdv_kernel", ty,
                                 f"Li{d}ELb0ELb1ELb0E"),
            f"band dkdv fused d={d}": ("dense_bwd11dkdv_kernel", ty,
                                       f"Li{d}ELb1ELb1ELb0E"),
            f"band dq d={d}": ("dense_bwd9dq_kernel", ty, f"Li{d}ELb1ELb0E"),
            f"band varlen dkdv d={d}": ("varlen_dkdv_kernel", ty,
                                        f"Li{d}ELb1ELb0E"),
            f"band varlen dq d={d}": ("varlen_dq_kernel", ty,
                                      f"Li{d}ELb1ELb0E"),
            f"band B6 forward d={d}": ("17varlen_fwd_kernel", ty,
                                       f"Li{d}ELb1ELb0E"),
            f"band B7 d={d}": ("varlen_fwd_persistent_kernel", ty,
                               f"Li{d}ELb1ELb0E")})
    res = kernel_resources(lib, marks)
    print("band instantiations' registers / stack / local bytes a thread "
          "(bf16; cuobjdump -res-usage): " + "; ".join(
              f"{label} " + ", ".join(
                  f"{u.get('REG')}/{u.get('STACK')}/{u.get('LOCAL')}"
                  for u in us) for label, us in res.items()))
    return errs, timings, api, res


def run_band_mha(gen, card):
    """The windowed MHA at Mistral-7B's widths (BAND_MHA_WINDOW), unpacked
    (BAND_MHA_BATCH rows: B1's band forward, B3's band backward) and packed
    (BAND_MHA_LENS: B7's band forward, B6's band backward), forward and
    backward on the card against the same module on the CPU (the plain
    versions; fp32, and bf16 for the 2x rule) on its output and the
    gradients of x and both weights, each run's launches counted (every
    attention launch the band's). Returns the launches and the errors."""
    from flash_attn_tpu_torch.modules.mha import MHA
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    h, h_k, d = (MISTRAL_7B.num_attention_heads,
                 MISTRAL_7B.num_key_value_heads,
                 MISTRAL_7B.hidden_size // MISTRAL_7B.num_attention_heads)
    width = h * d
    kw = dict(num_heads=h, num_heads_kv=h_k, causal=True, rotary_emb_dim=d,
              window_size=BAND_MHA_WINDOW, qkv_proj_bias=False,
              out_proj_bias=False)
    mods = {"cuda": MHA(width, dtype=torch.bfloat16, device="cuda", **kw),
            "cpu": MHA(width, dtype=torch.float32, device="cpu", **kw),
            "cpu_bf16": MHA(width, dtype=torch.bfloat16, device="cpu", **kw)}
    with torch.no_grad():
        for prm in mods["cuda"].parameters():
            prm.normal_(0.0, width ** -0.5, generator=gen)
    for key in ("cpu", "cpu_bf16"):
        mods[key].load_state_dict({n: t.cpu() for n, t in
                                   mods["cuda"].state_dict().items()})
    lens = BAND_MHA_LENS
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      dtype=torch.int32)
    launches, errs = {}, {}
    for form in ("unpacked", "packed"):
        shape = ((BAND_MHA_BATCH, max(lens), width) if form == "unpacked"
                 else (sum(lens), width))
        x = torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        g = torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        results = {}
        for key, mod in mods.items():
            dev = "cuda" if key == "cuda" else "cpu"
            xi = x.detach().to(dev, mod.Wqkv.weight.dtype).requires_grad_()
            if key == "cuda":
                torch.cuda.synchronize()
                reset_kernel_counts()
            extra = ({} if form == "unpacked" else
                     dict(cu_seqlens=cu.to(dev), max_seqlen=max(lens)))
            out = mod(xi, **extra)
            out.backward(g.to(dev, out.dtype))
            if key == "cuda":
                torch.cuda.synchronize()
                got = {**kernel_counts(), **bwd_counts()}
                launches[form] = {n: c for n, c in got.items() if c}
                want = ({"flash_fwd": 1, "flash_fwd_band": 1,
                         "flash_bwd_preprocess": 1, "fa_bwd_dkdv": 1,
                         "fa_bwd_dkdv_band": 1, "fa_bwd_dq": 1,
                         "fa_bwd_dq_band": 1} if form == "unpacked" else
                        {"flash_varlen_fwd_persistent": 1,
                         "flash_varlen_fwd_persistent_band": 1,
                         "fa_varlen_bwd_preprocess": 1,
                         "fa_varlen_bwd_dkdv": 1,
                         "fa_varlen_bwd_dkdv_band": 1, "fa_varlen_bwd_dq": 1,
                         "fa_varlen_bwd_dq_band": 1})
                require(launches[form] == want,
                        f"windowed MHA ({form}) launches {launches[form]}")
            results[key] = [out.detach(), xi.grad, mod.Wqkv.weight.grad,
                            mod.out_proj.weight.grad]
            for prm in mod.parameters():
                prm.grad = None
        line = []
        for i, what in enumerate(("out", "dx", "dWqkv", "dWout")):
            err, err_lp = check_against_ref(
                results["cuda"][i], results["cpu"][i],
                results["cpu_bf16"][i], atol=BWD_ATOL,
                msg=f"windowed MHA ({form}) {what}")
            errs[f"{form} {what}"] = err
            line.append(f"{what} {err:.3e} (bf16 plain {err_lp:.3e})")
        rows = (f"lengths {lens}" if form == "packed"
                else f"b={BAND_MHA_BATCH} x {max(lens)}")
        print(f"windowed MHA at Mistral-7B's widths ({width} wide, {h}/{h_k} "
              f"heads of {d}, window {BAND_MHA_WINDOW}, {form}: {rows}"
              f") on {card}: launches {launches[form]}; max abs err against "
              f"the plain fp32 module on the CPU " + ", ".join(line))
        del results, x, g
    del mods
    torch.cuda.empty_cache()
    return launches, errs


def run_mistral_training(card):
    """Mistral-7B-v0.1 trained at full width from its config.json numbers
    (MISTRAL_7B through the Llama adapter, window_size = (4095, 0) set on
    its config as the JAX package sets it) with the depth cut to
    MISTRAL_TRAIN_LAYERS, seeded weights (the trainer's initialisation) and
    bf16 training state, by fit_checked at MISTRAL_TRAIN_BATCH x
    MISTRAL_TRAIN_SEQ with band=True (per step and layer one band forward,
    one preprocess, one band dK/dV and one band dQ, no band-free launch)
    and a profile of one step. Returns the launches and measurements."""
    from flash_attn_tpu_torch.models.llama import llama_config_to_gpt_config
    from flash_attn_tpu_torch.utils.cases import MISTRAL_WINDOW

    cut = SimpleNamespace(**{**vars(MISTRAL_7B),
                             "num_hidden_layers": MISTRAL_TRAIN_LAYERS})
    mcfg = dataclasses.replace(
        llama_config_to_gpt_config(cut, dtype=torch.bfloat16),
        window_size=MISTRAL_WINDOW)
    label = (f"Mistral-7B training ({MISTRAL_TRAIN_LAYERS} of "
             f"{MISTRAL_7B.num_hidden_layers} layers, window "
             f"{MISTRAL_WINDOW})")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mistral.bin")
        write_token_file(path, mcfg.vocab_size)
        launches, res, trainer, loader = fit_checked(
            label, mcfg, path, MISTRAL_TRAIN_BATCH, MISTRAL_TRAIN_SEQ,
            band=True)
        profile_step(trainer, loader, f"one {label} step",
                     MISTRAL_TRAIN_BATCH, MISTRAL_TRAIN_SEQ)
        print(f"{label}: step {res['step_ms']:.1f} ms (median of steps "
              f"{TRAIN_WARM + 1}-{TRAIN_STEPS}), {res['tokens_per_s']:.0f} "
              f"tokens/s, {res['tflops_per_s']:.1f} TFLOP/s "
              f"(model_flops_per_token, which counts all causal pairs), peak "
              f"{res['peak_gb']:.2f} GB (max_memory_allocated) on {card}")
        del trainer, loader
    torch.cuda.empty_cache()
    return launches, res


# ---- softcap and ALiBi in serving (B1, B4, B8's score map) ----------------

# Baichuan-13B-Base (baichuan-inc/Baichuan-13B-Base config.json): a Llama
# body with a fused W_pack QKV, 40 heads of 128, ALiBi (the adapter infers
# it from the width, >= 5000, as the reference does) and no rotary; served
# at full width and depth from a seeded checkpoint in HF's names
BAICHUAN_13B = SimpleNamespace(
    vocab_size=64000, hidden_size=5120, num_hidden_layers=40,
    num_attention_heads=40, intermediate_size=13696, rms_norm_eps=1e-6,
    tie_word_embeddings=False, model_max_length=4096)
# The MUFU's rate: 16 special-function operations (ex2, tanh) a clock on
# each SM (the H100's SM has four SFU quadrants of 4 lanes each)
MUFU_PER_SM_CLOCK = 16
# softcap and ALiBi in training: Baichuan-13B-Base (BAICHUAN_13B) trained at
# full width through the port's adapter with the depth cut to
# BAICHUAN_TRAIN_LAYERS of 40 at BAICHUAN_TRAIN_BATCH x BAICHUAN_TRAIN_SEQ
# (Mistral-7B's 8,192 tokens a step, at the model's own 4096 positions).
# Reckoned before the run: 8 layers and both embeddings are 3.18B
# parameters, about 38 GB of bf16 weights, fp32 masters, bf16 moments and
# gradients, and about 17 GB of activations (Mistral-7B's share at 2.0B
# parameters, 37.94 GB in all, scaled by the width): under the 70 GB at
# which the depth would be cut to 6.
BAICHUAN_TRAIN_LAYERS, BAICHUAN_TRAIN_BATCH, BAICHUAN_TRAIN_SEQ = 4, 2, 4096
# The trained models' causality check (causal_check): the earlier
# positions' logits may move by at most this when later tokens change (rows
# of a product over other rows' inputs; a read of a later token moves them
# by whole units)
CAUSAL_GAP = 0.05
# The packed score MHAs' sequences (run_score_mha): short enough for the
# CPU reference at Baichuan-13B's widths, one past a 128-row tile
SCORE_MHA_LENS = [300, 129, 183]


@functools.lru_cache(maxsize=None)
def mufu_rate() -> float:
    """Special-function operations a second at the card's largest SM clock
    (nvidia-smi clocks.max.sm) over all its SMs."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return MUFU_PER_SM_CLOCK * sms * mhz * 1e6


def score_bound(flops: float, nbytes: float, mufu_ops: float) -> dict:
    """bound() with a third floor: the special-function operations (an ex2
    a score, and a tanh a score under a cap) at mufu_rate(); the largest of
    the matmul's, the MUFU's and the bytes' times, each kept."""
    parts = {"matmul_ms": flops / PEAK_FLOPS * 1e3,
             "mufu_ms": mufu_ops / mufu_rate() * 1e3,
             "bytes_ms": nbytes / PEAK_BYTES * 1e3}
    largest = max(parts, key=parts.get)
    return {"bound_ms": parts[largest],
            "bound_by": "bytes" if largest == "bytes_ms" else "operations",
            "bound_largest": largest[:-3], "bound_parts": parts}


def score_kw(case_softcap, kind, b, h, window=(None, None)):
    from flash_attn_tpu_torch.utils.cases import score_slopes

    return dict(softcap=case_softcap, window_size=window,
                alibi_slopes=score_slopes(kind, b, h, "cuda"))


def score_fwd_refs(q, k, v, causal, kw, heads_bytes: float = 2e9):
    """band_fwd_refs with the score map: the fp32 plain forward and the
    low-precision reference (attention_ref, upcast=False) a batch row and a
    few KV heads at a time, each with its rows' slopes."""
    from flash_attn_tpu_torch.dispatch.score import slopes_bh
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import attention_ref

    b, sq, h, d = q.shape
    sk, h_k = k.shape[1], k.shape[2]
    group = h // h_k
    per = max(1, int(heads_bytes // (group * sq * sk * 4)))
    sl = slopes_bh(kw["alibi_slopes"], b, h)
    ref = torch.empty(b, h, sq, d, device="cuda")
    lse = torch.empty(b, h, sq, device="cuda")
    ref_lp = torch.empty_like(q)
    for bi in range(b):
        for k0 in range(0, h_k, per):
            ks, qs = slice(k0, k0 + per), slice(k0 * group,
                                                (k0 + per) * group)
            qc, kc, vc = (x[bi:bi + 1, :, hs] for x, hs in
                          ((q, qs), (k, ks), (v, ks)))
            part = dict(kw, alibi_slopes=None if sl is None
                        else sl[bi:bi + 1, qs])
            o, l = flash_fwd.flash_attention_fwd_plain(
                *(x.transpose(1, 2).float() for x in (qc, kc, vc)),
                causal=causal, **part)
            ref[bi, qs], lse[bi, qs] = o[0], l[0]
            o_lp, _ = attention_ref(qc, kc, vc, causal=causal, upcast=False,
                                    **part)
            ref_lp[bi, :, qs] = o_lp[0]
            del o, l, o_lp
    return ref, lse, ref_lp


def alibi_sdpa_mask(sl, b, h, sq, sk, causal, window, dtype):
    """SDPA's float mask of ALiBi (bias times slope, -inf outside the
    causal bound and the window), (b, h, sq, sk) in the inputs' type."""
    from flash_attn_tpu_torch.dispatch.score import alibi_bias, slopes_bh

    rows = torch.arange(sq, device="cuda")[:, None]
    cols = torch.arange(sk, device="cuda")[None, :]
    bias = slopes_bh(sl, b, h)[..., None, None] * alibi_bias(
        rows, cols, sq, sk, causal)
    return bias.masked_fill(~band_mask(sq, sk, causal, window),
                            float("-inf")).to(dtype)


def flex_softcap(cap, keep, b, sq, sk):
    """torch.compile(flex_attention) with a tanh score_mod and, where
    ``keep(b, h, q_idx, kv_idx)`` is given, the keys it holds kept (a block
    mask over b batch rows; b None: one mask for every row): a function of
    (q, k, v) in (batch, heads, rows, d), GQA where k has fewer heads."""
    from torch.nn.attention.flex_attention import (
        create_block_mask,
        flex_attention,
    )

    def cap_mod(score, bi, hi, qi, ki):
        return torch.tanh(score / cap) * cap

    mask = (None if keep is None else
            create_block_mask(keep, b, None, sq, sk, device="cuda"))
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda q, k, v: fn(q, k, v, score_mod=cap_mod, block_mask=mask,
                              enable_gqa=q.shape[1] != k.shape[1])


def flex_row(make_call, ref, err_lp, what):
    """The library keys of a row under the cap: make_call() gives a call of
    flex_softcap's function on the kernel's inputs, its output in the
    layout of ``ref``, the fp32 plain output; held to ref by the 2x rule of
    the kernel's own check (err_lp: the low-precision reference's error),
    then timed. Where flex_attention does not run here or misses that rule,
    no time and the reason."""
    try:
        call = make_call()
        got = call().float().to(ref.device)
    except Exception as e:  # the yardstick is optional; the reason is kept
        return {"library_ms": None, "library_call": (
            f"none: flex_attention did not run here ({type(e).__name__}: "
            f"{str(e)[:200]})")}
    diff = (got - ref.float()).abs().max().item()
    del got
    if not diff <= 2 * err_lp + 1e-5:
        return {"library_ms": None, "library_max_abs_err": diff,
                "library_call": (
                    f"none: flex_attention's output is {diff:.3e} off the "
                    f"fp32 plain version, beyond twice the low-precision "
                    f"reference's {err_lp:.3e}")}
    return {"library_ms": time_ms(call, runs=10), "library_max_abs_err": diff,
            "library_call": "torch.compile(flex_attention) with a tanh "
                            f"score_mod and {what}"}


def score_fwd_case(gen, case, timed: bool, scale=None):
    """B1's score instantiation on one SCORE_FWD_CASES case (at softmax
    scale ``scale``, None: 1/sqrt(d)) against its
    plain version (the 2x rule against the fp32 plain forward with a
    low-precision reference, lse within LSE_ATOL on the rows that see a key
    and -inf on the same rows; the lse of causal ALiBi relative to the last
    key), its launches counted as the score's, the same bits twice; with
    ``timed``, timed beside the kernel without the map at the same shape,
    the plain version, a library call (SDPA with ALiBi as a float mask;
    flex_attention with a tanh score_mod for the cap) and a bound that
    reckons the MUFU (an ex2 a score, a tanh a score under the cap)."""
    from flash_attn_tpu_torch.dispatch.config import normalize_window
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    name, b, sq, sk, h, h_k, d, causal, cap, kind, window, dtype = case
    window = normalize_window(window)
    kw = score_kw(cap, kind, b, h, window)
    if scale is not None:
        kw["softmax_scale"] = scale

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    q, k, v = randn(b, sq, h, d), randn(b, sk, h_k, d), randn(b, sk, h_k, d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    before = flash_fwd.launches_score
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal, **kw)
    again = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal, **kw)
    torch.cuda.synchronize()
    require(flash_fwd.launches_score == before + 2,
            f"flash_fwd {name}: the score instantiation did not run")
    ref, ref_lse, ref_lp = score_fwd_refs(q, k, v, causal, kw)
    err, err_lp = check_against_ref(out.transpose(1, 2), ref.transpose(1, 2),
                                    ref_lp, msg=f"flash_fwd score {name}")
    fin = torch.isfinite(ref_lse)
    require(torch.equal(torch.isfinite(lse), fin),
            f"flash_fwd {name}: the rows that see no key differ")
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item()
    require(lse_err <= LSE_ATOL, f"flash_fwd {name}: lse error {lse_err}")
    require(torch.equal(again[0], out) and torch.equal(again[1], lse),
            f"flash_fwd {name}: two runs differ")
    del ref_lse, ref_lp, again
    print(f"flash_fwd score {name} (b={b}, sq={sq}, sk={sk}, {h}/{h_k} heads "
          f"of {d}, {str(dtype)[6:]}, causal={causal}, softcap {cap}, slopes "
          f"{kind}, window {window}): out max abs err {err:.3e} (low-"
          f"precision reference {err_lp:.3e}), lse max abs err "
          f"{lse_err:.3e}, {int((~fin).sum())} rows with no key, bitwise "
          f"equal twice")
    if not timed:
        return err, None
    pairs = b * int(band_mask(sq, sk, causal, window).sum())
    ms = time_ms(lambda: flash_fwd.flash_attention_fwd(
        qt, kt, vt, causal=causal, **kw))
    plain_kernel_ms = time_ms(lambda: flash_fwd.flash_attention_fwd(
        qt, kt, vt, causal=causal, window_size=window, softmax_scale=scale))
    plain_ms = time_ms(lambda: flash_fwd.flash_attention_fwd_plain(
        qt, kt, vt, causal=causal, **kw), runs=3, batch=1)
    timing = {"ms": ms, "plain_ms": plain_ms,
              "without_map_ms": plain_kernel_ms,
              **score_bound(4 * h * d * pairs,
                            2 * (2 * b * sq * h * d + 2 * b * sk * h_k * d)
                            + 4 * b * h * sq, h * pairs * (1 + (cap > 0)))}
    if kw["alibi_slopes"] is not None and cap == 0:
        mask = alibi_sdpa_mask(kw["alibi_slopes"], b, h, sq, sk, causal,
                               window, dtype)
        timing["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=h != h_k,
                scale=scale), runs=10)
        timing["library_call"] = ("scaled_dot_product_attention with ALiBi's "
                                  "bias and the causal bound as a float mask"
                                  + ", enable_gqa=True" * (h != h_k)
                                  + f", scale={scale}" * (scale is not None))
    else:
        def keep(bi, hi, qi, ki):
            return ki <= qi + (sk - sq)

        def make_call():
            run = flex_softcap(cap, keep if causal else None, None, sq, sk)
            return lambda: run(qt, kt, vt)
        timing.update(flex_row(make_call, ref, err_lp,
                               "the causal block mask" if causal else
                               "no mask"))
    del ref
    lib = timing["library_ms"]
    print(f"flash_fwd score time at {name}: {ms:.4f} ms, the kernel without "
          f"the map {plain_kernel_ms:.4f} ms, plain {plain_ms:.2f} ms, "
          + (f"library {lib:.4f} ms" if lib is not None else "no library "
             "time") + f" ({timing['library_call']}); bound "
          f"{timing['bound_ms']:.4f} ms (largest: {timing['bound_largest']};"
          f" matmul {timing['bound_parts']['matmul_ms']:.4f}, MUFU "
          f"{timing['bound_parts']['mufu_ms']:.4f}, bytes "
          f"{timing['bound_parts']['bytes_ms']:.4f})")
    return err, timing


def score_decode_case(gen, case, timed: bool, scale=None):
    """B4's d = dv route with softcap or ALiBi on one SCORE_DECODE_CASES
    case (at softmax scale ``scale``, None: 1/sqrt(d)), linear or paged,
    against its plain version (the 2x rule against
    the fp32 plain decode on the CPU with a bf16 reference, lse within
    LSE_ATOL: the lse of causal ALiBi relative to each row's own last key,
    which every split partial keeps), the partials bitwise equal twice and
    the launches counted as the score's; with ``timed``, beside the kernel
    without the map at the same lengths, the plain version, a library call
    over the linear cache, or the cache gathered first: SDPA with ALiBi as
    a float mask, compiled flex_attention with a tanh score_mod and a block
    mask of the lengths for the cap) and a bound that reckons the MUFU."""
    from flash_attn_tpu_torch.cache.kvcache import _default_num_splits
    from flash_attn_tpu_torch.dispatch.config import DECODE_BLOCK_K
    from flash_attn_tpu_torch.dispatch.score import alibi_bias, slopes_bh
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
        paged_to_linear,
    )

    name, b, sq, h, h_k, d, page, keys, cap, kind, splits, causal = case
    kw = score_kw(cap, kind, b, h)
    del kw["window_size"]
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(
        torch.bfloat16)
    if page:
        kc, vc, table = paged_cache(gen, b, h_k, d, page, keys,
                                    torch.bfloat16)
    else:
        s_max = -(-keys // 128) * 128
        kc, vc = (torch.randn(b, h_k, s_max, d, device="cuda",
                              generator=gen).to(torch.bfloat16)
                  for _ in range(2))
        table = None
    seqlens = (keys - 37 * torch.arange(b, device="cuda")).clamp(
        min=sq).to(torch.int32)
    splits = splits or _default_num_splits(q, kc, vc, table, False)
    counter = "launches_paged_score" if page else "launches_score"
    before = getattr(flash_decode, counter)
    scale = d ** -0.5 if scale is None else scale
    out, lse = flash_decode.flash_attention_decode(
        q, kc, vc, seqlens, causal=causal, num_splits=splits,
        block_table=table, softmax_scale=scale, **kw)
    cpu = dict(block_table=None if table is None else table.cpu(),
               softcap=cap, alibi_slopes=None if kw["alibi_slopes"] is None
               else kw["alibi_slopes"].cpu())
    ref, ref_lse = flash_decode.flash_attention_decode(
        q.float().cpu(), kc.float().cpu(), vc.float().cpu(), seqlens.cpu(),
        softmax_scale=scale, causal=causal, num_splits=splits, **cpu)
    call = dict(block_table=table, **kw)
    part = flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, causal, **call)
    again = flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, causal, **call)
    torch.cuda.synchronize()
    require(getattr(flash_decode, counter) == before + 3,
            f"{name}: the score map did not run")
    require(torch.equal(part[0], again[0]) and torch.equal(part[1], again[1]),
            f"{name}: two runs differ")
    lin = [x if table is None else
           paged_to_linear(x, table, seqlens) for x in (kc, vc)]
    keep = torch.arange(lin[0].shape[2], device="cuda")[None] \
        < seqlens[:, None]
    # ALiBi with each row's own length: attention_ref's key padding
    # measures it (non-causal), and under causal masking its bias is a
    # per-row constant away from the kernel's (the outputs agree)
    ref_lp, _ = attention_ref(q, lin[0].transpose(1, 2),
                              lin[1].transpose(1, 2), key_padding_mask=keep,
                              causal=causal, upcast=False,
                              softmax_scale=scale, **kw)
    err, err_lp = check_against_ref(out, ref, ref_lp,
                                    msg=f"flash_decode score {name}")
    lse_err = (lse.cpu() - ref_lse).abs().max().item()
    require(lse_err <= LSE_ATOL, f"{name}: lse error {lse_err}")
    print(f"flash_decode{'_paged' if page else ''} score {name} (b={b}, "
          f"sq={sq}, {h}/{h_k} heads of {d}, lengths {int(seqlens.min())}.."
          f"{keys}, softcap {cap}, slopes {kind}, {splits} splits, causal="
          f"{causal}): out max abs err {err:.3e} (bf16 reference "
          f"{err_lp:.3e}), lse max abs err {lse_err:.3e}, the partials "
          f"bitwise equal twice")
    if not timed:
        return err, None
    ms = time_ms(lambda: flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, causal, **call))
    free_ms = time_ms(lambda: flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, causal, block_table=table))
    plain = (flash_decode.flash_attention_decode_partials_plain
             if table is None else
             flash_decode.flash_attention_decode_paged_partials_plain)
    extra = () if table is None else (table,)
    plain_ms = wall_ms(lambda: plain(
        q, kc, vc, seqlens, *extra, splits, DECODE_BLOCK_K, scale, causal,
        **kw), runs=5)
    n_keys = int(seqlens.sum())
    pairs = sq * n_keys - b * sq * (sq - 1) // 2 if causal else sq * n_keys
    timing = {"ms": ms, "without_map_ms": free_ms, "plain_ms": plain_ms,
              "plain_clock": "host, between synchronisations",
              "num_splits": splits,
              **score_bound(4 * h * d * pairs,
                            2 * 2 * n_keys * h_k * d + 2 * b * sq * h * d
                            + 4 * splits * b * sq * h * (d + 1)
                            + 4 * (b + (0 if table is None else
                                        table.numel())) + 4 * b * h,
                            h * pairs * (1 + (cap > 0)))}
    if kw["alibi_slopes"] is not None and cap == 0:
        width = lin[0].shape[2]
        rows = torch.arange(sq, device="cuda")[:, None]
        cols = torch.arange(width, device="cuda")[None, :]
        sk = seqlens.long()[:, None, None, None]
        bias = slopes_bh(kw["alibi_slopes"], b, h)[..., None, None] \
            * alibi_bias(rows, cols, sq, sk, causal)
        valid = keep[:, None, None, :] & (
            (cols <= rows + sk - sq) if causal else True)
        mask = bias.masked_fill(~valid, float("-inf")).to(torch.bfloat16)
        qh = q.transpose(1, 2)
        if table is None:
            lib = lambda: F.scaled_dot_product_attention(
                qh, kc, vc, attn_mask=mask, enable_gqa=h != h_k, scale=scale)
            what = "over the linear cache"
        else:
            lib = lambda: F.scaled_dot_product_attention(
                qh, *(paged_to_linear(x, table, seqlens) for x in (kc, vc)),
                attn_mask=mask, enable_gqa=h != h_k, scale=scale)
            what = ("over the cache gathered through the block table (the "
                    "gather included)")
        timing["library_ms"] = time_ms(lib)
        timing["library_call"] = ("scaled_dot_product_attention with ALiBi's "
                                  "bias, the lengths and the causal bound as "
                                  f"a float mask {what}"
                                  + ", enable_gqa=True" * (h != h_k))
    else:
        def keep(bi, hi, qi, ki):
            inside = ki < seqlens[bi]
            return (inside & (ki <= qi + seqlens[bi] - sq) if causal
                    else inside)

        def make_call():
            run = flex_softcap(cap, keep, b, sq, lin[0].shape[2])
            qh = q.transpose(1, 2)
            if table is None:
                return lambda: run(qh, kc, vc).transpose(1, 2)
            return lambda: run(qh, *(paged_to_linear(x, table, seqlens)
                                     for x in (kc, vc))).transpose(1, 2)
        timing.update(flex_row(
            make_call, ref, err_lp,
            "a block mask of the lengths" + " and the causal bound" * causal
            + (" over the linear cache" if table is None else " over the "
               "cache gathered through the block table (the gather "
               "included)")))
    lib_ms = timing["library_ms"]
    print(f"flash_decode score time at {name}: {ms:.4f} ms, without the map "
          f"{free_ms:.4f} ms, plain {plain_ms:.4f} ms (host clock), "
          + (f"library {lib_ms:.4f} ms" if lib_ms is not None else
             "no library time") + f"; bound {timing['bound_ms']:.4f} ms "
          f"(largest: {timing['bound_largest']})")
    return err, timing


def check_score_kernels(gen):
    """softcap and ALiBi on the card: B1 on SCORE_FWD_CASES, B4 (linear,
    paged, the verify step) on SCORE_DECODE_CASES and B8 with the cap on
    SCORE_VARLEN_CASES against their plain versions, the timed shapes
    (the first two of each list and B8's first) beside the kernel without
    the map, the plain version, a library call and a bound that reckons the
    MUFU. Returns errors and timings by kernels-line name."""
    from flash_attn_tpu_torch.utils.cases import (
        SCORE_DECODE_CASES,
        SCORE_FWD_CASES,
        SCORE_VARLEN_CASES,
    )

    rows = {"Baichuan-13B prefill": "flash_fwd_alibi",
            "913M softcap prefill": "flash_fwd_softcap",
            "Baichuan-13B decode step": "flash_decode_alibi",
            "Baichuan-13B engine decode step": "flash_decode_paged_alibi",
            "Baichuan-13B engine verify step":
                "flash_decode_paged_alibi_verify",
            "913M softcap decode step": "flash_decode_softcap",
            "913M softcap engine decode step": "flash_decode_paged_softcap"}
    errs, timings = {}, {}

    def keep(name, row, err, t):
        errs[row] = max(errs.get(row, 0.0), err)
        if t is not None:
            timings.setdefault(row, {}).update(t)

    for case in SCORE_FWD_CASES:
        row = rows.get(case[0], "flash_fwd_alibi" if case[9] else
                       "flash_fwd_softcap")
        err, t = score_fwd_case(gen, case, case[0] in rows)
        keep(case[0], row, err, t)
        torch.cuda.empty_cache()
    for case in SCORE_DECODE_CASES:
        paged, verify = case[6] > 0, case[2] > 1
        row = rows.get(case[0], "flash_decode" + "_paged" * paged
                       + ("_alibi" if case[9] else "_softcap")
                       + "_verify" * (paged and verify and bool(case[9])))
        err, t = score_decode_case(gen, case, case[0] in rows)
        keep(case[0], row, err, t)
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp

    for i, (case, cap, window) in enumerate(SCORE_VARLEN_CASES):
        before = fvp.launches_score
        err, t = varlen_paged_case(gen, case, with_b6=False, timed=i == 0,
                                   window=tuple(None if x < 0 else x
                                                for x in window),
                                   softcap=cap)
        require(fvp.launches_score - before >= 2,
                f"flash_varlen_paged {case[0]}: the score map did not run")
        keep(case[0], "flash_varlen_paged_softcap", err, t)
    torch.cuda.empty_cache()
    from flash_attn_tpu_torch.kernels import _build

    ty, marks = "13__nv_bfloat16", {}
    for d in (64, 96, 128, 256):
        for band in (0, 1):
            form = f"Li{d}ELb{band}ELb1E"
            tag = f"d={d}" + " with the band" * band
            marks[f"B1 score {tag}"] = ("9dense_fwd10fwd_kernel", ty, form)
            marks[f"B8 score {tag}"] = (
                "12varlen_paged19varlen_paged_kernel", ty, form)
        marks[f"B4 d={d}"] = ("13decode_kernel", f"{ty}Li{d}E")
    res = kernel_resources(_build.library_path(), marks)
    print("score instantiations' and B4's registers / stack / local bytes a "
          "thread (bf16; cuobjdump -res-usage; B4 every row and ring form): "
          + "; ".join(f"{label} " + ", ".join(
              f"{u.get('REG')}/{u.get('STACK')}/{u.get('LOCAL')}" for u in us)
              for label, us in res.items()))
    timings["kernel_resources"] = res
    return errs, timings


def baichuan_spec(c) -> HFSpec:
    e, i_f = c.hidden_size, c.intermediate_size
    spec = HFSpec()
    spec.embedding("model.embed_tokens", c.vocab_size, e)
    for i in range(c.num_hidden_layers):
        p = f"model.layers.{i}."
        spec.norm(p + "input_layernorm", e, bias=False)
        spec.norm(p + "post_attention_layernorm", e, bias=False)
        spec.linear(p + "self_attn.W_pack", 3 * e, e)
        spec.linear(p + "self_attn.o_proj", e, e)
        spec.linear(p + "mlp.gate_proj", i_f, e)
        spec.linear(p + "mlp.up_proj", i_f, e)
        spec.linear(p + "mlp.down_proj", e, i_f)
    spec.norm("model.norm", e, bias=False)
    spec.linear("lm_head", c.vocab_size, e)
    return spec


def effect_gap(model, other, ids):
    """Largest difference of the last position's logits of two models over
    the same prompts, and the share of rows with the same top token."""
    with torch.inference_mode():
        a = model.logits(model.forward_hidden(ids)[:, -1:]).float()
        b = other.logits(other.forward_hidden(ids)[:, -1:]).float()
    return ((a - b).abs().max().item(),
            (a.argmax(-1) == b.argmax(-1)).float().mean().item())


def run_baichuan(card):
    """Baichuan-13B-Base at full width and depth (BAICHUAN_13B, its
    published config.json numbers), a seeded checkpoint in HF's names
    (W_pack) remapped a layer at a time through the port's adapter: static
    serving of BATCH x PROMPT tokens to NEW_TOKENS new ones, graphed and
    eager (serve_static with every launch the score map's: ALiBi in B1 and
    B4), TTFT and the decode rate beside the weights' read; ALiBi in force
    (the same weights with use_alibi=False give last-position logits that
    differ by more than the decode's bf16 noise); then the paged engine
    (BREADTH_REQUESTS prompts on BREADTH_SLOTS slots) and the speculative
    engine with the target as its own draft (SPEC_K: B4's verify step under
    ALiBi), held to a teacher-forced static decode and to the plain engine;
    the prefix-cached engine must refuse the model (ROADMAP.md queue C).
    Returns launches and measurements."""
    from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
    from flash_attn_tpu_torch.serving.generation import GenerationConfig

    rng = np.random.default_rng(24)
    launches, out = {}, {}
    name = "Baichuan-13B"
    t0 = time.perf_counter()
    model, peak = hf_model("baichuan", BAICHUAN_13B, baichuan_spec, 18,
                           max_decode_seqlen=PROMPT + NEW_TOKENS)
    build_s = time.perf_counter() - t0
    cfg = model.config
    require(cfg.use_alibi and cfg.rotary_emb_fraction == 0.0
            and cfg.n_layer == 40 and cfg.n_embd == 5120,
            f"{name}: the adapter's config")
    print(f"{name} built from its config (the Baichuan adapter: ALiBi, no "
          f"rotary) and a seeded HF checkpoint in {build_s:.1f} s (peak "
          f"{peak:.2f} GB) on {card}")
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)),
                          device="cuda")
    launches[name], _, noise = serve_static(model, ids, name, score=True)
    ttft, tok_s = static_rates(model, ids, modes=(True, False))
    model._decode_state = None
    plain = model_view(model, use_alibi=False)
    gap, same_top = effect_gap(model, plain, ids)
    print(f"{name}: ALiBi in force: last-position logits with and without "
          f"the slopes differ by {gap:.4f} at most (the decode's own bf16 "
          f"noise against the teacher-forced forward: {noise:.4f}), the same "
          f"top token in {same_top:.2f} of the rows")
    require(gap > noise, f"{name}: ALiBi changes the logits by no more than "
            "the bf16 noise")
    del plain
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    out[name] = {"params_b": n_params / 1e9, "layers": cfg.n_layer,
                 "build_s": build_s, "build_peak_gb": peak,
                 "ttft_ms": ttft * 1e3,
                 "decode_tokens_per_s": tok_s[True][0],
                 "decode_tokens_per_s_eager": tok_s[False][0],
                 "decode_step_ms": BATCH / tok_s[True][0] * 1e3,
                 "weight_read_ms": weight_bytes / PEAK_BYTES * 1e3,
                 "alibi_logit_gap": gap, "decode_noise": noise}
    print(f"{name} ({n_params / 1e9:.2f}B parameters, {cfg.n_layer} layers, "
          f"width {cfg.n_embd}, {cfg.n_head} heads, ALiBi): TTFT "
          f"{ttft * 1e3:.2f} ms (b={BATCH} x {PROMPT}), decode "
          f"{tok_s[True][0]:.1f} tokens/s graphed ({tok_s[False][0]:.1f} "
          f"eager), a step {out[name]['decode_step_ms']:.3f} ms against "
          f"{out[name]['weight_read_ms']:.3f} ms to read its "
          f"{weight_bytes / 1e9:.2f} GB of weights once at 3.35 TB/s, on "
          f"{card}")
    torch.cuda.empty_cache()

    paged = paged_view(model, BREADTH_SLOTS)
    prompts = list(rng.integers(0, cfg.vocab_size,
                                (BREADTH_REQUESTS, ENGINE_PROMPT)))
    ename = f"{name} paged engine"
    torch.cuda.reset_peak_memory_stats()
    launches[ename], tokens, out[ename] = run_engine(
        paged, prompts, False, card, slots=BREADTH_SLOTS, name=ename,
        score=True)
    out[ename]["agreement"], out[ename]["logit_gap"] = engine_agreement(
        paged, prompts, tokens, ename, MIN_ARGMAX_AGREEMENT)
    out[ename]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    sname = f"{name} speculative engine"
    launches[sname], spec, out[sname] = run_engine(
        paged, prompts, False, card, slots=BREADTH_SLOTS, name=sname,
        draft=linear_view(paged), score=True)
    # 40 layers hold more bf16 noise than the 913M's 16 (TIE_STEPS): the
    # parted tokens are held to this model's own measured decode noise, and
    # every token to the teacher-forced decode as the paged engine's are
    out[sname]["equal_to_plain"] = spec_vs_plain(paged, prompts, spec, tokens,
                                                 sname, tie_bound=noise)
    out[sname]["agreement"], out[sname]["logit_gap"] = engine_agreement(
        paged, prompts, spec, sname, MIN_ARGMAX_AGREEMENT)
    try:
        InferenceEngine(paged, BREADTH_SLOTS, GenerationConfig(top_k=1),
                        page_pool=PagePool(paged.config.paged_kv_num_pages,
                                           ENGINE_PAGE, 3, BREADTH_SLOTS),
                        prefix_cache=True)
        refused = None
    except ValueError as e:
        refused = str(e)
    require(refused is not None and "queue C" in refused,
            f"{name}: the prefix-cached engine took an ALiBi model")
    print(f"{name}: the prefix-cached engine refuses the model: {refused}")
    out[name]["prefix_cache_refused"] = refused
    del model, paged
    torch.cuda.empty_cache()
    return launches, out


def run_softcap_gpt(card):
    """The 913M GPT with softcap = GEMMA2_SOFTCAP (Gemma-2's
    attn_logit_softcapping), random weights from a seed: static serving
    (serve_static, every launch the score map's), the cap in force (its
    last-position logits against the same weights with softcap = 0, the gap
    printed beside the decode's bf16 noise and required nonzero; a cap of
    2, which bites at these scores, required past the noise), then the
    paged engine on bench.py's trace and the prefix-cached engine (B8 with
    the cap) over shared-prefix prompts, each held to a teacher-forced
    static decode. Returns launches and measurements."""
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel, gpt_913m
    from flash_attn_tpu_torch.utils.cases import GEMMA2_SOFTCAP

    rng = np.random.default_rng(25)
    launches, out = {}, {}
    name = "913M softcap"
    cfg = dataclasses.replace(gpt_913m(max_decode_seqlen=ENGINE_MAX_LEN),
                              softcap=GEMMA2_SOFTCAP)
    model = GPTLMHeadModel(cfg, device="cuda")
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(3))
    model.requires_grad_(False)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)),
                          device="cuda")
    launches[name], _, noise = serve_static(model, ids, name, score=True)
    ttft, tok_s = static_rates(model, ids, modes=(True,))
    model._decode_state = None
    gap, same_top = effect_gap(model, model_view(model, softcap=0.0), ids)
    gap2, _ = effect_gap(model_view(model, softcap=2.0),
                         model_view(model, softcap=0.0), ids)
    print(f"{name}: the cap in force: last-position logits with softcap "
          f"{GEMMA2_SOFTCAP} and without differ by {gap:.4f} at most (the "
          f"same top token in {same_top:.2f} of the rows); with softcap 2 by "
          f"{gap2:.4f}; the decode's bf16 noise {noise:.4f}")
    require(gap > 0, f"{name}: the cap changes no logit")
    require(gap2 > noise, f"{name}: a cap of 2 changes the logits by no more "
            "than the bf16 noise")
    out[name] = {"ttft_ms": ttft * 1e3, "decode_tokens_per_s": tok_s[True][0],
                 "cap_logit_gap": gap, "cap2_logit_gap": gap2,
                 "decode_noise": noise}
    print(f"{name} (913M, softcap {GEMMA2_SOFTCAP}): TTFT {ttft * 1e3:.2f} ms"
          f" (b={BATCH} x {PROMPT}), decode {tok_s[True][0]:.1f} tokens/s "
          f"graphed on {card}")
    width = -(-ENGINE_MAX_LEN // ENGINE_PAGE)
    paged = model_view(model, paged_kv_num_pages=ENGINE_SLOTS * width + 1,
                       paged_kv_page_size=ENGINE_PAGE)
    vocab = cfg.vocab_size
    plain_prompts = list(rng.integers(0, vocab, (ENGINE_REQUESTS,
                                                 ENGINE_PROMPT)))
    shared = rng.integers(0, vocab, PREFIX_SHARED)
    px = [np.concatenate([shared, rng.integers(
        0, vocab, ENGINE_PROMPT - PREFIX_SHARED)])
        for _ in range(PREFIX_REQUESTS)]
    for prefix, prompts in ((False, plain_prompts), (True, px)):
        ename = f"{name} {'prefix-cache' if prefix else 'paged'} engine"
        launches[ename], tokens, out[ename] = run_engine(
            paged, prompts, prefix, card, name=ename, score=True)
        out[ename]["agreement"], out[ename]["logit_gap"] = engine_agreement(
            paged, prompts, tokens, ename)
        torch.cuda.empty_cache()
    del model, paged
    torch.cuda.empty_cache()
    return launches, out


# ---- softcap and ALiBi in training (B3, B2, B6's pair; B6's and B7's
# forwards) ------------------------------------------------------------------


def flex_bwd_row(make_call, refs, errs_lp, what):
    """flex_row for a backward: make_call() gives a call of compiled
    flex_attention's forward and backward on the kernel's inputs that
    returns (dq, dk, dv) in the layout of ``refs``, the fp32 plain
    gradients; each is held to its ref by the 2x rule of the kernel's own
    check (errs_lp: the low-precision reference's error of each), then the
    call is timed. Where flex_attention does not run here or misses that
    rule, no time and the reason."""
    try:
        call = make_call()
        got = call()
        diffs = [(g.float() - r.float()).abs().max().item()
                 for g, r in zip(got, refs)]
    except Exception as e:  # the yardstick is optional; the reason is kept
        return {"library_ms": None, "library_call": (
            f"none: flex_attention's backward did not run here "
            f"({type(e).__name__}: {str(e)[:200]})")}
    del got
    bad = [(n, x, lp) for n, x, lp in zip("qkv", diffs, errs_lp)
           if not x <= 2 * lp + BWD_ATOL]
    if bad:
        return {"library_ms": None, "library_max_abs_err": max(diffs),
                "library_call": "none: flex_attention's gradients are off the "
                "fp32 plain version beyond twice the low-precision "
                "reference's: " + ", ".join(
                    f"d{n} {x:.3e} > 2 x {lp:.3e}" for n, x, lp in bad)}
    return {"library_ms": time_ms(call, runs=10),
            "library_max_abs_err": max(diffs),
            "library_call": "torch.compile(flex_attention) with a tanh "
                            f"score_mod and {what}, forward and backward "
                            "(torch.autograd.grad)"}


def score_bwd_timing(qt, kt, vt, dot, out, lse, causal, kw, name, refs):
    """At a SCORE_BWD_CASES timed shape: B3's and B2's score
    instantiations beside the kernels without the map at the same shape,
    and B6's and B7's score forwards and B6's score backward (its kernels
    by the profiler) over the same rows packed as b sequences, each beside
    a bound that reckons the MUFU (score_bound: an ex2 a score and, under
    the cap, a tanh, for the pairs the call attends), its plain version (a
    few KV heads at a time) and a library call: SDPA with ALiBi as a float
    mask (K and V repeated to the query heads), or compiled flex_attention
    with a tanh score_mod and the causal block mask for the cap, held to
    the fp32 plain gradients (refs: out32, grads32 and the low-precision
    errors of out and of each gradient) first. Returns the timings by
    kernels-line row (without the _alibi / _softcap suffix)."""
    from flash_attn_tpu_torch.dispatch.score import slopes_bh
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd, flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp

    b, h, sq, d = qt.shape
    h_k, sk = kt.shape[1], kt.shape[2]
    group = h // h_k
    esz = qt.element_size()
    cap, sl, window = kw["softcap"], kw["alibi_slopes"], kw["window_size"]
    out32, grads32, err_out_lp, errs_lp = refs
    pairs = b * int(band_mask(sq, sk, causal, window).sum())
    mufu = h * pairs * (1 + (cap > 0))

    def bwd(det):
        return lambda: flash_bwd.flash_attention_bwd(
            dot, qt, kt, vt, out, lse, causal=causal, deterministic=det, **kw)
    ms, fused_ms = time_ms(bwd(True), runs=10), time_ms(bwd(False), runs=10)
    names3 = ["preprocess_kernel", "dkdv_kernel", "dq_kernel"]
    split = kernel_split_ms(bwd(True), names3)
    fused_split = kernel_split_ms(bwd(False), names3[:2])
    out_f, lse_f = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal,
                                                 window_size=window)

    def free():
        return flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out_f, lse_f,
                                             causal=causal, window_size=window)
    free_ms = time_ms(free, runs=10)
    free_split = kernel_split_ms(free, names3)
    del out_f, lse_f
    plain_fwd, plain_bwd, n_parts = plain_band_chunks(
        qt, kt, vt, dot, out, lse, causal, dict(kw), heads_bytes=2.2e9)
    plain_ms = time_ms(plain_bwd, runs=3, batch=1)
    plain_fwd_ms = time_ms(plain_fwd, runs=3, batch=1)
    plain_label = (f"the plain fp32 score version, {n_parts} calls of "
                   f"{-(-h // n_parts)} query heads")
    if sl is not None and cap == 0:
        mask = alibi_sdpa_mask(sl, b, h, sq, sk, causal, window, qt.dtype)
        rep = [x.repeat_interleave(group, dim=1) for x in (kt, vt)]
        leaves = [x.detach().requires_grad_() for x in (qt, *rep)]
        scale = kw.get("softmax_scale")
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                  scale=scale)
        what = ("scaled_dot_product_attention with ALiBi's bias and the causal "
                "bound as a float mask, K and V repeated to the query heads"
                + ("" if scale is None else f", scale {scale:g}"))
        lib_b = {"library_ms": time_ms(lambda: torch.autograd.grad(
            sdpa_out, leaves, dot, retain_graph=True), runs=10),
            "library_call": what + ", backward (torch.autograd.grad)"}
        del sdpa_out, leaves
        lib_f = {"library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, *rep, attn_mask=mask, scale=scale), runs=10),
            "library_call": what}
        del mask, rep
    else:
        def keep(bi, hi, qi, ki):
            return ki <= qi + (sk - sq)
        mask_what = "the causal block mask" if causal else "no mask"

        def make_bwd():
            run = flex_softcap(cap, keep if causal else None, None, sq, sk)
            leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
            return lambda: torch.autograd.grad(run(*leaves), leaves, dot)

        def make_fwd():
            run = flex_softcap(cap, keep if causal else None, None, sq, sk)
            return lambda: run(qt, kt, vt)
        lib_b = flex_bwd_row(make_bwd, grads32, errs_lp, mask_what)
        lib_f = flex_row(make_fwd, out32, err_out_lp, mask_what)
    common = {"plain_ms": plain_ms, "plain_call": plain_label, **lib_b,
              "score_pairs": pairs}
    t = {"flash_bwd": {"ms": ms, "without_map_ms": free_ms,
                       "kernel_split_ms": split,
                       "without_map_kernel_split_ms": free_split, **common,
                       **score_bound(10 * h * d * pairs,
                                     esz * (4 * b * sq * h * d
                                            + 4 * b * sk * h_k * d)
                                     + 4 * b * h * sq, mufu)},
         "flash_bwd_fused": {"ms": fused_ms, "kernel_split_ms": fused_split,
                             **common,
                             **score_bound(10 * h * d * pairs,
                                           esz * (4 * b * sq * h * d
                                                  + 4 * b * sk * h_k * d)
                                           + 4 * b * h * sq, mufu)}}

    # the same rows packed as b sequences, each with its row's slopes
    cu_q, cu_k = (torch.arange(b + 1, dtype=torch.int32, device="cuda") * n
                  for n in (sq, sk))
    q, k, v, do, o = (x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
                      for x in (qt, kt, vt, dot, out))
    lse_p = lse.permute(1, 0, 2).reshape(h, b * sq).contiguous()
    args = (cu_q, cu_k, sq, sk)
    vkw = dict(kw, alibi_slopes=slopes_bh(sl, b, h))
    b6 = lambda: flash_varlen.flash_attention_varlen_fwd(
        q, k, v, *args, causal=causal, **vkw)
    b7 = lambda: fvp.flash_attention_varlen_fwd_persistent(
        q, k, v, *args, causal=causal, **vkw)
    vbwd = lambda: flash_varlen.flash_attention_varlen_bwd(
        do, q, k, v, o, lse_p, *args, causal=causal, **vkw)
    vsplit = kernel_split_ms(vbwd, ("varlen_preprocess_kernel",
                                    "varlen_dkdv_kernel", "varlen_dq_kernel"))
    # the forwards with their work lists built beforehand (a call builds
    # them with torch ops) beside B1's score instantiation over the same
    # rows
    meta = flash_varlen.varlen_meta(q, k, cu_q, cu_k, sq, sk, None, None,
                                    causal, None, window_size=window)
    b6_kernel = time_ms(lambda: flash_varlen.flash_attention_varlen_fwd(
        q, k, v, *args, causal=causal, meta=meta, **vkw), runs=10)
    b7_kernel = time_ms(lambda: fvp.flash_attention_varlen_fwd_persistent(
        q, k, v, *args, causal=causal, meta=meta, **vkw), runs=10)
    b1_kernel = time_ms(lambda: flash_fwd.flash_attention_fwd(
        qt, kt, vt, causal=causal, **kw), runs=10)
    fwd_b = score_bound(4 * h * d * pairs,
                        esz * (2 * b * sq * h * d + 2 * b * sk * h_k * d)
                        + 4 * b * h * sq, mufu)
    qdo = esz * 2 * b * sq * h * d + 8 * b * h * sq
    kv = esz * 2 * b * sk * h_k * d
    packed = " (the dense call over the same rows)"
    lib_pf = {**lib_f, "library_call": (lib_f["library_call"] + packed
                                        if lib_f["library_ms"] is not None
                                        else lib_f["library_call"]),
              "plain_ms": plain_fwd_ms, "plain_call": plain_label,
              "score_pairs": pairs}
    lib_pb = {**lib_b, "library_call": (lib_b["library_call"] + packed
                                        if lib_b["library_ms"] is not None
                                        else lib_b["library_call"]),
              "plain_ms": plain_ms, "plain_call": plain_label + " (the pair)",
              "score_pairs": pairs}
    t.update({
        "flash_varlen_fwd": {"ms": time_ms(b6, runs=10),
                             "with_lists_ms": b6_kernel,
                             "dense_ms": b1_kernel, **lib_pf, **fwd_b},
        "flash_varlen_fwd_persistent": {"ms": time_ms(b7, runs=10),
                                        "with_lists_ms": b7_kernel,
                                        "dense_ms": b1_kernel, **lib_pf,
                                        **fwd_b},
        "fa_varlen_bwd_dkdv": {
            "ms": vsplit["varlen_dkdv_kernel"], **lib_pb,
            **score_bound(8 * h * d * pairs,
                          qdo + kv + 2 * esz * b * sk * h_k * d, mufu)},
        "fa_varlen_bwd_dq": {
            "ms": vsplit["varlen_dq_kernel"], **lib_pb,
            **score_bound(6 * h * d * pairs,
                          qdo + kv + esz * b * sq * h * d, mufu)}})
    for row, r in t.items():
        lib = r["library_ms"]
        print(f"{row} score at {name}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_largest']}; matmul "
              f"{r['bound_parts']['matmul_ms']:.4f}, MUFU "
              f"{r['bound_parts']['mufu_ms']:.4f}, bytes "
              f"{r['bound_parts']['bytes_ms']:.4f}; "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%), plain "
              f"{r['plain_ms']:.3f} ms, "
              + (f"library {lib:.4f} ms" if lib is not None else "no library "
                 "time") + f" ({r['library_call']})"
              + (f", the pair without the map {r['without_map_ms']:.4f} ms"
                 if "without_map_ms" in r else "")
              + (f"; with its work lists built beforehand "
                 f"{r['with_lists_ms']:.4f} ms against B1's score "
                 f"instantiation over the same rows {r['dense_ms']:.4f}"
                 if "with_lists_ms" in r else ""))

    def ms_list(x):
        return ", ".join(f"{n} {v:.4f}" for n, v in x.items())
    print(f"flash_bwd score profiler split at {name} (ms a call): "
          f"{ms_list(split)}; without the map: {ms_list(free_split)}; B2: "
          f"{ms_list(fused_split)}; B6's score backward a call: "
          f"{ms_list(vsplit)}")
    return t


def score_bwd_case(gen, case, timed: bool, scale=None):
    """B3's (and, where the case asks, B2's) score instantiations and the
    preprocess on one SCORE_BWD_CASES case (at softmax scale ``scale``,
    None: 1/sqrt(d)): dq, dk, dv by the 2x rule
    against the plain fp32 score backward (plain_bwd_refs, each chunk with
    its rows' slopes), each launch counted as the score map's (and the
    band's under a window), B3 the same bits twice; a requires_grad slopes
    tensor gets exact zeros through flash_attn_func, whose gradients are
    B3's bits; B6's score backward over the same rows packed (a sequence a
    row, each with its row's slopes) gives B3's bits and B6's and B7's
    score forwards give B1's. With ``timed`` (the training shapes of
    Baichuan-13B and the softcap GPT), flash_attn_func(...).backward() is
    counted both ways and score_bwd_timing times the kernels. Returns the
    errors by kernels-line row (without the suffix), the timings and the
    counted runs' launches."""
    from flash_attn_tpu_torch import flash_attn_func
    from flash_attn_tpu_torch.dispatch.band import has_band, reach_window
    from flash_attn_tpu_torch.dispatch.config import normalize_window
    from flash_attn_tpu_torch.dispatch.score import slopes_bh
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    name, b, sq, sk, h, h_k, d, causal, cap, kind, window, dtype, fused = case
    window = normalize_window(window)
    kw = score_kw(cap, kind, b, h, window)
    if scale is not None:
        kw["softmax_scale"] = scale
    band = int(has_band(causal, reach_window(window, causal, sq, sk), 0))

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    q, k, v, dout = (randn(b, sq, h, d), randn(b, sk, h_k, d),
                     randn(b, sk, h_k, d), randn(b, sq, h, d))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, dout))
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal, **kw)
    torch.cuda.synchronize()
    reset_kernel_counts()
    b3 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                       causal=causal, **kw)
    again = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                          causal=causal, **kw)
    b2 = (flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                        causal=causal, deterministic=False,
                                        **kw) if fused else None)
    torch.cuda.synchronize()
    got = bwd_counts()
    f = int(fused)
    require(got == {"flash_fwd": 0, "flash_fwd_band": 0,
                    "flash_fwd_score": 0, "flash_bwd_preprocess": 2 + f,
                    "fa_bwd_dkdv": 2, "fa_bwd_dq": 2, "flash_bwd_fused": f,
                    "fa_bwd_dkdv_band": 2 * band, "fa_bwd_dq_band": 2 * band,
                    "flash_bwd_fused_band": f * band,
                    "fa_bwd_dkdv_score": 2, "fa_bwd_dq_score": 2,
                    "flash_bwd_fused_score": f},
            f"score backward launches at {name}: {got}")
    require(all(torch.equal(a, c) for a, c in zip(b3, again)),
            f"B3's score instantiation differs between runs: {name}")
    del again
    out32, out_lp, ref, ref_lp = plain_bwd_refs(qt, kt, vt, dot, causal,
                                                **kw)
    err_f, err_f_lp = check_against_ref(
        out.transpose(1, 2), out32.transpose(1, 2), out_lp,
        msg=f"flash_fwd score {name}")
    errs, line, errs_lp = {}, [], []
    for row, grads in (("flash_bwd", b3), ("flash_bwd_fused", b2)):
        if grads is None:
            continue
        for gname, g, r, lp in zip("qkv", grads, ref, ref_lp):
            err, err_lp = check_against_ref(
                g.transpose(1, 2), r.transpose(1, 2), lp, atol=BWD_ATOL,
                msg=f"{row} score d{gname} {name}")
            errs[row] = max(errs.get(row, 0.0), err)
            if row == "flash_bwd":
                errs_lp.append(err_lp)
            line.append(f"{'B3' if row == 'flash_bwd' else 'B2'} d{gname} "
                        f"{err:.3e} (low precision {err_lp:.3e})")
    del ref_lp, b2, out_lp
    extra = ""
    if kw["alibi_slopes"] is not None:
        sl = kw["alibi_slopes"].detach().clone().requires_grad_()
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        flash_attn_func(*leaves, causal=causal, softcap=cap, alibi_slopes=sl,
                        window_size=window,
                        softmax_scale=kw.get("softmax_scale")).backward(dout)
        require(torch.equal(sl.grad, torch.zeros_like(sl)),
                f"{name}: the slopes' gradient is not zero")
        require(all(torch.equal(leaf.grad, g.transpose(1, 2))
                    for leaf, g in zip(leaves, b3)),
                f"{name}: flash_attn_func's score gradients differ from B3's")
        extra = ("; a requires_grad slopes tensor gets exact zeros, "
                 "flash_attn_func's gradients bitwise B3's")
        del leaves, sl
    vkw = dict(kw, alibi_slopes=slopes_bh(kw["alibi_slopes"], b, h))
    reset_kernel_counts()
    b6 = packed_b6_backward(dot, qt, kt, vt, out, lse, causal, **vkw)()
    require(all(torch.equal(a, c) for a, c in zip(b3, b6)),
            f"B6's score backward over the same rows packed differs from "
            f"B3's: {name}")
    for label, (o, l) in zip(("B6's score forward", "B7's"),
                             packed_forwards(qt, kt, vt, causal, **vkw)):
        require(torch.equal(o, out) and torch.equal(l, lse),
                f"{label} over the same rows packed differs from B1's score "
                f"instantiation: {name}")
    torch.cuda.synchronize()
    packed = got = kernel_counts()
    require(got == want_counts(
        flash_varlen_fwd=1, flash_varlen_fwd_score=1,
        flash_varlen_fwd_band=band, flash_varlen_fwd_persistent=1,
        flash_varlen_fwd_persistent_score=1,
        flash_varlen_fwd_persistent_band=band, fa_varlen_bwd_preprocess=1,
        fa_varlen_bwd_dkdv=1, fa_varlen_bwd_dkdv_score=1,
        fa_varlen_bwd_dkdv_band=band, fa_varlen_bwd_dq=1,
        fa_varlen_bwd_dq_score=1, fa_varlen_bwd_dq_band=band),
        f"packed score launches at {name}: {got}")
    del b6
    errs.update({"fa_varlen_bwd_dkdv": errs["flash_bwd"],
                 "fa_varlen_bwd_dq": errs["flash_bwd"],
                 "flash_varlen_fwd": err_f,
                 "flash_varlen_fwd_persistent": err_f})
    no_key = int((~torch.isfinite(lse)).sum())
    print(f"score backward {name} (b={b}, sq={sq}, sk={sk}, {h}/{h_k} heads "
          f"of {d}, {str(dtype)[6:]}, causal={causal}, softcap {cap}, slopes "
          f"{kind}, window {window}; {no_key} rows with no key): "
          + ", ".join(line) + f"; B3 bitwise equal twice; B1's out "
          f"{err_f:.3e} (low precision {err_f_lp:.3e}); B6's score backward "
          f"over the same rows packed bitwise B3's, B6's score forward and "
          f"B7's bitwise B1's" + extra)
    timings, api = {}, {}
    if timed:
        api["packed"] = packed
        for det in (True, False):
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            torch.cuda.synchronize()
            reset_kernel_counts()
            flash_attn_func(*leaves, causal=causal, deterministic=det,
                            **kw).backward(dout)
            torch.cuda.synchronize()
            got = bwd_counts()
            require(got == {"flash_fwd": 1, "flash_fwd_band": band,
                            "flash_fwd_score": 1, "flash_bwd_preprocess": 1,
                            "fa_bwd_dkdv": int(det), "fa_bwd_dq": int(det),
                            "flash_bwd_fused": int(not det),
                            "fa_bwd_dkdv_band": int(det) * band,
                            "fa_bwd_dq_band": int(det) * band,
                            "flash_bwd_fused_band": int(not det) * band,
                            "fa_bwd_dkdv_score": int(det),
                            "fa_bwd_dq_score": int(det),
                            "flash_bwd_fused_score": int(not det)},
                    f"flash_attn_func score backward at {name} "
                    f"(deterministic={det}): {got}")
            api[det] = got
            del leaves
        print(f"flash_attn_func(..., softcap={cap}, alibi_slopes {kind})"
              f".backward() at {name}: launches {api[True]} (deterministic) "
              f"and {api[False]} (fused)")
        timings = score_bwd_timing(qt, kt, vt, dot, out, lse, causal, kw,
                                   name, (out32, ref, err_f_lp, errs_lp))
    del ref, out32
    return errs, timings, api


def check_score_backward(gen, lib):
    """softcap and ALiBi in training on the card: score_bwd_case on every
    SCORE_BWD_CASES case (the first two, Baichuan-13B's and the softcap
    GPT's training shapes, timed), and the score instantiations' registers
    and spills (cuobjdump -res-usage). Returns the errors and timings by
    kernels-line row (_alibi for the cases with slopes, _softcap for those
    with a cap), the counted flash_attn_func runs' launches by the timed
    case's kind, and the registers."""
    from flash_attn_tpu_torch.utils.cases import SCORE_BWD_CASES

    errs, timings, api = {}, {}, {}
    for i, case in enumerate(SCORE_BWD_CASES):
        kinds = ["alibi"] * (case[9] is not None) + ["softcap"] * (case[8] > 0)
        e, t, a = score_bwd_case(gen, case, timed=i < 2)
        for kind in kinds:
            for row, x in e.items():
                key = f"{row}_{kind}"
                errs[key] = max(errs.get(key, 0.0), x)
        if t:
            timings.update({f"{row}_{kinds[0]}": r for row, r in t.items()})
            api[kinds[0]] = a
        torch.cuda.empty_cache()
    marks = {}
    for d in (64, 96, 128, 256):
        ty = "13__nv_bfloat16"
        marks.update({
            f"score dkdv d={d}": ("dense_bwd11dkdv_kernel", ty,
                                  f"Li{d}ELb0ELb1ELb1E"),
            f"score dkdv fused d={d}": ("dense_bwd11dkdv_kernel", ty,
                                        f"Li{d}ELb1ELb1ELb1E"),
            f"score dq d={d}": ("dense_bwd9dq_kernel", ty, f"Li{d}ELb1ELb1E"),
            f"score varlen dkdv d={d}": ("varlen_dkdv_kernel", ty,
                                         f"Li{d}ELb1ELb1E"),
            f"score varlen dq d={d}": ("varlen_dq_kernel", ty,
                                       f"Li{d}ELb1ELb1E"),
            f"score B6 forward d={d}": ("17varlen_fwd_kernel", ty,
                                        f"Li{d}ELb1ELb1E"),
            f"score B7 d={d}": ("varlen_fwd_persistent_kernel", ty,
                                f"Li{d}ELb1ELb1E")})
    res = kernel_resources(lib, marks)
    print("score instantiations' registers / stack / local bytes a thread "
          "(bf16; cuobjdump -res-usage): " + "; ".join(
              f"{label} " + ", ".join(
                  f"{u.get('REG')}/{u.get('STACK')}/{u.get('LOCAL')}"
                  for u in us) for label, us in res.items()))
    return errs, timings, api, res


def run_score_mha(gen, card, forms=None):
    """Packed input (SCORE_MHA_LENS, cu_seqlens) through an MHA with ALiBi
    at Baichuan-13B's widths (5120 wide, 40 heads of 128, no rotary: B6's
    score forward, as JAX routes ALiBi) and one with the cap at the 913M
    GPT's (2048 wide, 16 heads of 128, rotary: B7's score forward), or the
    MHA arguments of ``forms`` (form -> MHA keywords and its "width"), forward
    and backward (B6's score backward) on the card against the same module
    on the CPU (the plain versions; fp32, and bf16 for the 2x rule) on the
    output and the gradients of x and both weights, and against the padded
    dense call of the same module on the card (each sequence alone, B1's
    and B3's score instantiations: the packed output and x's gradient
    within the 2x rule's own bf16 bound); each run's launches counted,
    every attention launch the score map's. Returns the launches and the
    errors."""
    from flash_attn_tpu_torch.modules.mha import MHA
    from flash_attn_tpu_torch.utils.cases import GEMMA2_SOFTCAP
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    forms = forms or {
        "alibi": dict(num_heads=BAICHUAN_13B.num_attention_heads,
                      width=BAICHUAN_13B.hidden_size, use_alibi=True),
        "softcap": dict(num_heads=16, width=2048, softcap=GEMMA2_SOFTCAP,
                        rotary_emb_dim=128)}
    lens = SCORE_MHA_LENS
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      dtype=torch.int32)
    launches, errs = {}, {}
    for form, spec in forms.items():
        width = spec.pop("width")
        kw = dict(causal=True, qkv_proj_bias=False, out_proj_bias=False,
                  **spec)
        mods = {"cuda": MHA(width, dtype=torch.bfloat16, device="cuda", **kw),
                "cpu": MHA(width, dtype=torch.float32, device="cpu", **kw),
                "cpu_bf16": MHA(width, dtype=torch.bfloat16, device="cpu",
                                **kw)}
        with torch.no_grad():
            for prm in mods["cuda"].parameters():
                prm.normal_(0.0, width ** -0.5, generator=gen)
        for key in ("cpu", "cpu_bf16"):
            mods[key].load_state_dict({n: t.cpu() for n, t in
                                       mods["cuda"].state_dict().items()})
        x = torch.randn(sum(lens), width, device="cuda", generator=gen).to(
            torch.bfloat16)
        g = torch.randn(sum(lens), width, device="cuda", generator=gen).to(
            torch.bfloat16)
        results = {}
        for key, mod in mods.items():
            dev = "cuda" if key == "cuda" else "cpu"
            xi = x.detach().to(dev, mod.Wqkv.weight.dtype).requires_grad_()
            if key == "cuda":
                torch.cuda.synchronize()
                reset_kernel_counts()
            out = mod(xi, cu_seqlens=cu.to(dev), max_seqlen=max(lens))
            out.backward(g.to(dev, out.dtype))
            if key == "cuda":
                torch.cuda.synchronize()
                got = {**kernel_counts(), **bwd_counts()}
                launches[form] = {n: c for n, c in got.items() if c}
                fwd = ({"flash_varlen_fwd": 1, "flash_varlen_fwd_score": 1}
                       if form == "alibi" else
                       {"flash_varlen_fwd_persistent": 1,
                        "flash_varlen_fwd_persistent_score": 1})
                want = {**fwd, "fa_varlen_bwd_preprocess": 1,
                        "fa_varlen_bwd_dkdv": 1,
                        "fa_varlen_bwd_dkdv_score": 1, "fa_varlen_bwd_dq": 1,
                        "fa_varlen_bwd_dq_score": 1}
                require(launches[form] == want,
                        f"packed {form} MHA launches {launches[form]}")
            results[key] = [out.detach(), xi.grad, mod.Wqkv.weight.grad,
                            mod.out_proj.weight.grad]
            for prm in mod.parameters():
                prm.grad = None
        line = []
        for i, what in enumerate(("out", "dx", "dWqkv", "dWout")):
            err, err_lp = check_against_ref(
                results["cuda"][i], results["cpu"][i],
                results["cpu_bf16"][i], atol=BWD_ATOL,
                msg=f"packed {form} MHA {what}")
            errs[f"{form} {what}"] = err
            line.append(f"{what} {err:.3e} (bf16 plain {err_lp:.3e})")
        # the padded dense call on the card: each sequence alone, unpacked
        mod = mods["cuda"]
        dense, dxs = [], []
        for lo, hi in zip(cu[:-1].tolist(), cu[1:].tolist()):
            xi = x[None, lo:hi].detach().requires_grad_()
            o = mod(xi)
            o.backward(g[None, lo:hi])
            dense.append(o.detach()[0])
            dxs.append(xi.grad[0])
        for i, (what, d_) in enumerate((("out", torch.cat(dense)),
                                        ("dx", torch.cat(dxs)))):
            gap = (results["cuda"][i].float() - d_.float()).abs().max().item()
            bound_lp = 2 * (results["cpu_bf16"][i].float().cpu()
                            - results["cpu"][i].float()).abs().max().item()
            require(gap <= bound_lp + BWD_ATOL,
                    f"packed {form} MHA {what}: {gap} off the padded dense "
                    f"call, beyond {bound_lp}")
            line.append(f"{what} against the dense call {gap:.3e}")
        print(f"packed MHA with {form} ({width} wide, {kw['num_heads']} heads "
              f"of {width // kw['num_heads']}, softmax scale "
              f"{kw.get('softmax_scale') or 'the default'}, lengths {lens}) "
              f"on {card}: launches "
              f"{launches[form]}; max abs err against the plain fp32 module on "
              f"the CPU " + ", ".join(line))
        del results, x, g, mods, mod, dense, dxs
        torch.cuda.empty_cache()
    return launches, errs


def causal_check(trainer, loader, label):
    """The trained model's forward is causal: the logits of the positions
    before the middle of a batch of the run's data do not move (within
    CAUSAL_GAP) when every token from the middle on is replaced, while the
    later positions' do. (The run's windows repeat one period of tokens, so
    a model that learned to read a later token would show it here.)
    Returns the two gaps."""
    ids = trainer._batch(next(iter(loader))[0])
    half = ids.shape[1] // 2
    other = ids.clone()
    other[:, half:] = (ids[:, half:] + 1) % trainer.model.config.vocab_size
    with torch.no_grad():
        a, b = (trainer.model(x).float() for x in (ids, other))
    before = (a[:, :half] - b[:, :half]).abs().max().item()
    after = (a[:, half:] - b[:, half:]).abs().max().item()
    del a, b
    require(before <= CAUSAL_GAP,
            f"{label}: the logits before the middle moved by {before} when "
            "the tokens after it changed")
    print(f"{label}: causal: replacing the tokens from the middle on moves "
          f"the earlier positions' logits by {before:.4g} at most and the "
          f"later ones' by {after:.4g}")
    return before, after


def run_baichuan_training(card):
    """Baichuan-13B-Base trained at full width from its config.json numbers
    (BAICHUAN_13B through the port's Baichuan adapter: ALiBi, no rotary, an
    untied head) with the depth cut to BAICHUAN_TRAIN_LAYERS, seeded
    weights (the trainer's initialisation) and bf16 training state, by
    fit_checked at BAICHUAN_TRAIN_BATCH x BAICHUAN_TRAIN_SEQ with
    score=True (per step and layer one score forward, one preprocess, one
    score dK/dV and one score dQ, no launch without the map) and a profile
    of one step. Returns the launches and measurements."""
    from flash_attn_tpu_torch.models.hf_adapters import (
        baichuan_config_to_gpt_config,
    )

    cut = SimpleNamespace(**{**vars(BAICHUAN_13B),
                             "num_hidden_layers": BAICHUAN_TRAIN_LAYERS})
    mcfg = baichuan_config_to_gpt_config(cut, dtype=torch.bfloat16)
    require(mcfg.use_alibi and mcfg.rotary_emb_fraction == 0.0
            and not mcfg.tie_word_embeddings,
            "Baichuan-13B training: the adapter's config")
    label = (f"Baichuan-13B training ({BAICHUAN_TRAIN_LAYERS} of "
             f"{BAICHUAN_13B.num_hidden_layers} layers, ALiBi)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "baichuan.bin")
        write_token_file(path, mcfg.vocab_size)
        launches, res, trainer, loader = fit_checked(
            label, mcfg, path, BAICHUAN_TRAIN_BATCH, BAICHUAN_TRAIN_SEQ,
            score=True)
        profile_step(trainer, loader, f"one {label} step",
                     BAICHUAN_TRAIN_BATCH, BAICHUAN_TRAIN_SEQ)
        res["causal_gaps"] = causal_check(trainer, loader, label)
        print(f"{label}: step {res['step_ms']:.1f} ms (median of steps "
              f"{TRAIN_WARM + 1}-{TRAIN_STEPS}), {res['tokens_per_s']:.0f} "
              f"tokens/s, {res['tflops_per_s']:.1f} TFLOP/s "
              f"(model_flops_per_token), peak {res['peak_gb']:.2f} GB "
              f"(max_memory_allocated) on {card}")
        del trainer, loader
    torch.cuda.empty_cache()
    return launches, res


def run_softcap_training(card):
    """The 913M GPT with softcap = GEMMA2_SOFTCAP trained at the repo's
    training shape (TRAIN_BATCH x TRAIN_SEQ) by fit_checked with
    score=True, and a profile of one step. Returns the launches and
    measurements."""
    from flash_attn_tpu_torch.models.gpt import gpt_913m
    from flash_attn_tpu_torch.utils.cases import GEMMA2_SOFTCAP

    mcfg = dataclasses.replace(gpt_913m(), softcap=GEMMA2_SOFTCAP)
    label = f"913M training with softcap {GEMMA2_SOFTCAP}"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens.bin")
        write_token_file(path, mcfg.vocab_size)
        launches, res, trainer, loader = fit_checked(label, mcfg, path,
                                                     score=True)
        profile_step(trainer, loader, f"one {label} step")
        res["causal_gaps"] = causal_check(trainer, loader, label)
        print(f"{label}: step {res['step_ms']:.1f} ms, "
              f"{res['tokens_per_s']:.0f} tokens/s, "
              f"{res['tflops_per_s']:.1f} TFLOP/s, peak {res['peak_gb']:.2f} "
              f"GB on {card}")
        del trainer, loader
    torch.cuda.empty_cache()
    return launches, res


# ---- Quantized KV caches: B4 and B8 over 1-byte caches with descales, B11's
# conversion, and the 913M and Llama-3-8B served from an fp8 cache ----------

# The logits of a model served from an fp8 cache against the same model
# from a bf16 cache, teacher-forced with the bf16 run's tokens: the largest
# |difference| of a decode step over that step's largest |logit|, below the
# JAX package's own bound (tests/test_fp8.py:133-134).
KV_DRIFT_BOUND = 0.15
KV_SCALES = (1.0, 2.0)
# Share of an fp8-cache engine's tokens that must be the argmax of a
# teacher-forced static decode over the same fp8 cache: JAX's own fp8
# engine test lets a quarter of the tokens part from a bf16 engine's
# (tests/test_engine.py:205-211); where they part, the token stays within
# LOGIT_BOUND of the top logit.
KV_ENGINE_AGREEMENT = 0.75
# The quantized engines serve the first requests of the engine traces over
# as many slots, so that the paged engine's decode block is timed with all
# of them busy.
KV_ENGINE_REQUESTS, KV_SPEC_REQUESTS = 32, 16
# v_descale of the conversion check: a power of two, so that a code's value
# times it is exact in fp32 and bf16.
KV_CODE_VD = 0.5


def kv_dequantized(codes, table, seqlens, descale):
    """The values a 1-byte cache (linear (b, h_k, s, d), or pages with a
    block table) holds under (b, h_k) ``descale``, in the linear layout,
    fp32."""
    from flash_attn_tpu_torch.utils.testing import paged_to_linear

    lin = (codes[:len(seqlens)].float() if table is None else
           paged_to_linear(codes, table, seqlens))
    return lin * descale[:, :, None, None]


def kv_decode_bound(seqlens, b, sq, h, h_k, d, splits, table_entries,
                    kv_bytes):
    """Bound of one decode call over a cache of ``kv_bytes`` an element:
    every cached K and V row read once, q read, the fp32 split partials,
    the lengths, the table and the descales read or written once."""
    keys = int(seqlens.sum())
    pairs = sq * keys - b * sq * (sq - 1) // 2
    return bound(4 * h * d * pairs,
                 2 * kv_bytes * keys * h_k * d + 2 * b * sq * h * d
                 + 4 * splits * b * sq * h * (d + 1)
                 + 4 * (b + table_entries) + 2 * 4 * b * h_k)


def kvquant_decode_case(gen, case, timed: bool):
    """B4's d = dv route over a 1-byte cache (KVQUANT_DECODE_CASES) with
    distinct per-(row, KV head) descales, against its plain version on the
    CPU in fp32 (the 2x rule with a bf16 reference over the dequantized
    values, lse within LSE_ATOL), the partials bitwise equal twice and the
    launches counted as the 1-byte cache's; with ``timed``, beside the
    same kernel over a bf16 cache of the same values without descales, the
    plain version, and the library call: the cache dequantized (gathered
    first when paged), then masked scaled_dot_product_attention."""
    from flash_attn_tpu_torch.cache.kvcache import _default_num_splits
    from flash_attn_tpu_torch.dispatch.config import DECODE_BLOCK_K
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.utils.cases import (
        kv_codes,
        kv_descales,
        score_slopes,
    )
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        check_against_ref,
    )

    name, b, sq, h, h_k, d, page, keys, dt, window, slopes, splits = case
    window = tuple(None if x < 0 else x for x in window)
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(
        torch.bfloat16)
    if page:
        width = -(-keys // page)
        x = torch.randn(2, b * width + 1, h_k, page, d, device="cuda",
                        generator=gen)
        table = (1 + torch.randperm(b * width, device="cuda", generator=gen)
                 ).reshape(b, width).to(torch.int32)
    else:
        x = torch.randn(2, b, h_k, -(-keys // 128) * 128, d, device="cuda",
                        generator=gen)
        table = None
    codes, unit = kv_codes(x, dt)
    kc, vc = codes[0], codes[1]
    del x
    # lengths within 64 below ``keys`` (the engine's slots hold 513..544)
    seqlens = (keys - (37 * torch.arange(b, device="cuda"))
               % max(1, min(keys - sq, 64))).to(torch.int32)
    qd, kd, vd = kv_descales(b, h_k, "cuda")
    qk, vs = (qd * kd * unit).contiguous(), (vd * unit).contiguous()
    al = score_slopes(slopes, b, h, "cuda")
    splits = splits or _default_num_splits(q, kc, vc, table, False)
    kw = dict(window_size=window, alibi_slopes=al)
    counter = "launches_paged_kv8" if page else "launches_kv8"
    before = getattr(flash_decode, counter)
    out, lse = flash_decode.flash_attention_decode(
        q, kc, vc, seqlens, causal=True, num_splits=splits, block_table=table,
        qk_descale=qk, v_descale=vs, **kw)
    cpu = lambda t: None if t is None else t.cpu()
    ref, ref_lse = flash_decode.flash_attention_decode(
        q.float().cpu(), kc.cpu(), vc.cpu(), seqlens.cpu(), causal=True,
        num_splits=splits, block_table=cpu(table), qk_descale=qk.cpu(),
        v_descale=vs.cpu(), window_size=window, alibi_slopes=cpu(al))
    scale = d ** -0.5
    call = dict(block_table=table, qk_descale=qk, v_descale=vs, **kw)
    part = flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, True, **call)
    again = flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, True, **call)
    torch.cuda.synchronize()
    require(getattr(flash_decode, counter) == before + 3,
            f"{name}: the 1-byte cache's kernel did not run")
    require(torch.equal(part[0], again[0]) and torch.equal(part[1], again[1]),
            f"{name}: two runs differ")
    kval = kv_dequantized(kc, table, seqlens, kd * unit)
    vval = kv_dequantized(vc, table, seqlens, vd * unit)
    q_eff = q.float() * qd.repeat_interleave(h // h_k, 1)[:, None, :, None]
    keep = torch.arange(kval.shape[2], device="cuda")[None] < seqlens[:, None]
    ref_lp, _ = attention_ref(
        q_eff.to(torch.bfloat16), kval.transpose(1, 2).to(torch.bfloat16),
        vval.transpose(1, 2).to(torch.bfloat16), key_padding_mask=keep,
        causal=True, upcast=False, **kw)
    err, err_lp = check_against_ref(out, ref, ref_lp,
                                    msg=f"flash_decode 1-byte cache {name}")
    lse_err = (lse.cpu() - ref_lse).abs().max().item()
    require(lse_err <= LSE_ATOL, f"{name}: lse error {lse_err}")
    print(f"flash_decode{'_paged' if page else ''} {str(dt)[6:]} cache "
          f"{name} (b={b}, sq={sq}, {h}/{h_k} heads of {d}, lengths "
          f"{int(seqlens.min())}..{keys}, {splits} splits, window {window}, "
          f"slopes {slopes}): out max abs err {err:.3e} (bf16 reference "
          f"{err_lp:.3e}), lse max abs err {lse_err:.3e}, the partials "
          f"bitwise equal twice")
    if not timed:
        return err, None
    ms = time_ms(lambda: flash_decode.flash_attention_decode_partials(
        q, kc, vc, seqlens, splits, scale, True, **call))
    kb, vb = (x.float().to(torch.bfloat16) for x in (kc, vc))
    bf16_ms = time_ms(lambda: flash_decode.flash_attention_decode_partials(
        q, kb, vb, seqlens, splits, scale, True, block_table=table))
    plain = (flash_decode.flash_attention_decode_partials_plain
             if table is None else
             flash_decode.flash_attention_decode_paged_partials_plain)
    extra = () if table is None else (table,)
    plain_ms = time_ms(lambda: plain(
        q, kc, vc, seqlens, *extra, splits, DECODE_BLOCK_K, scale, True,
        qk_descale=qk, v_descale=vs))
    qdh = qd.repeat_interleave(h // h_k, 1)[:, :, None, None]
    rows = torch.arange(sq, device="cuda")[:, None]
    cols = torch.arange(kval.shape[2], device="cuda")[None, :]
    mask = (keep[:, None, :] & (cols[None] <= rows[None]
                                + seqlens[:, None, None] - sq))[:, None]

    def library():
        k_l = kv_dequantized(kc, table, seqlens, kd * unit).to(torch.bfloat16)
        v_l = kv_dequantized(vc, table, seqlens, vd * unit).to(torch.bfloat16)
        qh = (q.transpose(1, 2).float() * qdh).to(torch.bfloat16)
        return F.scaled_dot_product_attention(qh, k_l, v_l, attn_mask=mask,
                                              enable_gqa=h != h_k)
    lib_ms = time_ms(library)
    timing = {"ms": ms, "bf16_cache_ms": bf16_ms, "plain_ms": plain_ms,
              "library_ms": lib_ms, "num_splits": splits,
              "library_call": "the cache dequantized with its descales ("
              + ("gathered through the block table first, " if page else "")
              + "torch ops), then scaled_dot_product_attention with a "
              "boolean causal length mask (the dequantization included)",
              **kv_decode_bound(seqlens, b, sq, h, h_k, d, splits,
                                0 if table is None else table.numel(), 1)}
    print(f"flash_decode {str(dt)[6:]} cache time at {name}: kernel "
          f"{ms:.4f} ms, over a bf16 cache {bf16_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, dequantize + masked SDPA {lib_ms:.4f} ms; "
          f"bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}, 1-byte "
          f"K/V)")
    return err, timing


def kvquant_varlen_case(gen, case, window, softcap: float, timed: bool):
    """B8 with descales on one KVQUANT_VARLEN_CASES case: over 1-byte pages
    (converted by kv_dequant's kernel first, the pool bitwise equal to the
    plain conversion on every page a row reaches) or over a bf16 cache,
    against its plain version (the 2x rule with a bf16 reference over the
    dequantized values, lse within LSE_ATOL), bitwise equal twice, the
    launches counted as the descales' (and the conversion's); with
    ``timed``, the kernel over the converted pool, the conversion alone,
    the whole call, B8 without descales over a bf16 cache of the same
    values, the plain version and the library call (the cache dequantized,
    then the padded, gathered, masked scaled_dot_product_attention)."""
    from flash_attn_tpu_torch.dispatch.kvquant import is_quantized
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.kernels import kv_dequant
    from flash_attn_tpu_torch.utils.cases import kv_codes, kv_descales
    from flash_attn_tpu_torch.utils.testing import (
        attention_varlen_paged_ref,
        check_against_ref,
    )

    name, lens_q, lens_k, used, h, h_k, d, page, dtype, causal, cdt = case
    window = tuple(None if x < 0 else x for x in window)
    b = len(lens_q)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                      dtype=torch.int32, device="cuda")
    total_q = int(cu[-1])
    q = torch.randn(total_q, h, d, device="cuda", generator=gen).to(dtype)
    width = -(-max(max(lens_k), 1) // page)
    x = torch.randn(2, b * width + 1, h_k, page, d, device="cuda",
                    generator=gen)
    codes, unit = kv_codes(x, cdt)
    kp, vp = codes[0], codes[1]
    del x
    table = (1 + torch.randperm(b * width, device="cuda", generator=gen)
             ).reshape(b, width).to(torch.int32)
    seqlens_k = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    seqused = (None if used is None else
               torch.tensor(used, dtype=torch.int32, device="cuda"))
    qd, kd, vd = kv_descales(b, h_k, "cuda")
    qk, vs = (qd * kd * unit).contiguous(), (vd * unit).contiguous()
    max_q = max(max(lens_q), 1)
    args = (cu, max_q, seqlens_k, table)
    kw = dict(seqused_q=seqused, causal=causal, window_size=window,
              softcap=softcap)
    quant = is_quantized(cdt)
    before = fvp.launches_descale, kv_dequant.launches
    out, lse = fvp.flash_attention_varlen_paged_fwd(
        q, kp, vp, *args, qk_descale=qk, v_descale=vs, **kw)
    ref, ref_lse = fvp.flash_attention_varlen_paged_fwd_plain(
        q.float(), kp, vp, *args, qk_descale=qk, v_descale=vs, **kw)
    # each page is one row's: its values under that row's descales
    page_k = torch.ones(kp.shape[0], h_k, device="cuda")
    page_v = torch.ones(kp.shape[0], h_k, device="cuda")
    page_k[table.long()] = (kd * unit)[:, None, :].expand(b, width, h_k)
    page_v[table.long()] = (vd * unit)[:, None, :].expand(b, width, h_k)
    kval = (kp.float() * page_k[:, :, None, None]).to(dtype)
    vval = (vp.float() * page_v[:, :, None, None]).to(dtype)
    seq = torch.repeat_interleave(torch.arange(b, device="cuda"),
                                  torch.tensor(lens_q, device="cuda"))
    q_eff = (q.float() * qd[seq].repeat_interleave(h // h_k, 1)[:, :, None]
             ).to(dtype)
    ref_lp = attention_varlen_paged_ref(
        q_eff, kval, vval, cu, seqlens_k, table, seqused_q=seqused,
        causal=causal, upcast=False, window_size=window, softcap=softcap)
    again = fvp.flash_attention_varlen_paged_fwd(
        q, kp, vp, *args, qk_descale=qk, v_descale=vs, **kw)
    torch.cuda.synchronize()
    require(fvp.launches_descale == before[0] + 2
            and kv_dequant.launches == before[1] + 2 * quant,
            f"flash_varlen_paged {name}: launches of the descales "
            f"{fvp.launches_descale - before[0]}, of the conversion "
            f"{kv_dequant.launches - before[1]}")
    require(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
            f"flash_varlen_paged {name}: two runs differ")
    err, err_lp = check_against_ref(out, ref, ref_lp,
                                    msg=f"flash_varlen_paged descales {name}")
    fin = torch.isfinite(ref_lse)
    require(torch.equal(torch.isfinite(lse), fin),
            f"flash_varlen_paged {name}: rows without keys differ")
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item() \
        if fin.any() else 0.0
    require(lse_err <= LSE_ATOL, f"flash_varlen_paged {name}: lse error "
            f"{lse_err}")
    if quant:
        pools = kv_dequant.dequant_pages(kp, vp, table, seqlens_k, dtype)
        plain_pools = kv_dequant.dequant_pages_plain(kp, vp, table,
                                                     seqlens_k, dtype)
        reached = kv_dequant.pages_reached(seqlens_k, page, width).reshape(-1)
        require(all(torch.equal(a[reached].view(torch.int16),
                                p[reached].view(torch.int16))
                    for a, p in zip(pools[:2], plain_pools[:2])),
                f"flash_varlen_paged {name}: the converted pages differ from "
                "the plain conversion")
    print(f"flash_varlen_paged descales {name} ({str(cdt)[6:]} cache, "
          f"lens_q {lens_q} lens_k {lens_k} seqused_q {used}, {h}/{h_k} "
          f"heads of {d}, pages of {page}, window {window}, softcap "
          f"{softcap}): out max abs err {err:.3e} (bf16 reference "
          f"{err_lp:.3e}), lse max abs err {lse_err:.3e}; bitwise equal "
          "twice" + ("; the converted pages bitwise equal to the plain "
                     "conversion" if quant else ""))
    if not timed:
        return err, None
    pool_k, pool_v, pool_t = kv_dequant.dequant_pages(kp, vp, table,
                                                      seqlens_k, dtype)
    call = lambda: fvp.flash_attention_varlen_paged_fwd(
        q, kp, vp, *args, qk_descale=qk, v_descale=vs, **kw)
    whole_ms = time_ms(call)
    split = kernel_split_ms(call, ("varlen_paged_kernel", "kv_dequant_kernel"))
    pool_args = (cu, max_q, seqlens_k, pool_t)
    ms = time_ms(lambda: fvp.flash_attention_varlen_paged_fwd(
        q, pool_k, pool_v, *pool_args, qk_descale=qk, v_descale=vs, **kw))
    bf16_ms = time_ms(lambda: fvp.flash_attention_varlen_paged_fwd(
        q, pool_k, pool_v, *pool_args, **kw))
    dq_ms = time_ms(lambda: kv_dequant.dequant_pages(kp, vp, table,
                                                     seqlens_k, dtype))
    dq_plain_ms = time_ms(lambda: kv_dequant.dequant_pages_plain(
        kp, vp, table, seqlens_k, dtype))
    plain_ms = time_ms(lambda: fvp.flash_attention_varlen_paged_fwd_plain(
        q, kp, vp, *args, qk_descale=qk, v_descale=vs, **kw))
    qpad = q.new_zeros(b, max_q, h, d)
    pos = torch.arange(total_q, device="cuda") - cu[seq].long()
    gathered, _ = paged_sdpa(qpad, kval, vval, table, seqlens_k, causal,
                             lens_q, window)

    def library():
        kval.copy_((kp.float() * page_k[:, :, None, None]).to(dtype))
        vval.copy_((vp.float() * page_v[:, :, None, None]).to(dtype))
        qpad.zero_()
        qpad[seq, pos] = (q.float() * qd[seq].repeat_interleave(
            h // h_k, 1)[:, :, None]).to(dtype)
        return gathered().transpose(1, 2)[seq, pos]
    lib_ms = time_ms(library)
    pairs = attended_pairs(used or lens_q, lens_k, causal, window)
    n_keys = band_keys(used or lens_q, lens_k, causal, window)
    esz = 1 if quant else 2
    reached = int(kv_dequant.pages_reached(seqlens_k, page, width).sum())
    timing = {"ms": ms, "whole_call_ms": whole_ms,
              "kernel_ms": split["varlen_paged_kernel"],
              "kv_dequant_kernel_ms": split["kv_dequant_kernel"],
              "kv_dequant_ms": dq_ms, "bf16_cache_ms": bf16_ms,
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "library_call": "the cache dequantized with its descales "
              "(torch ops), the packed rows padded, the cache gathered "
              "through the block table, scaled_dot_product_attention with a "
              "boolean causal length mask, the rows packed again (all "
              "included)",
              **bound(4 * h * d * pairs,
                      2 * 2 * total_q * h * d + 2 * esz * n_keys * h_k * d
                      + 4 * h * total_q + 2 * 4 * b * h_k)}
    # the library's conversion: Tensor.to over the same bytes, the codes of
    # the pages the rows reach gathered beforehand (untimed)
    ids = table.long()[kv_dequant.pages_reached(seqlens_k, page, width)]
    k_r, v_r = kp[ids], vp[ids]
    dq_lib_ms = time_ms(lambda: (k_r.to(dtype), v_r.to(dtype)))
    del k_r, v_r
    dq = {"ms": dq_ms, "plain_ms": dq_plain_ms, "library_ms": dq_lib_ms,
          "library_call": f"Tensor.to({dtype}) of the K and V codes of the "
                          "pages the rows reach, gathered beforehand",
          "pages": reached,
          **bound(0, 2 * reached * h_k * page * d * (1 + 2))}
    print(f"flash_varlen_paged descales time at {name}: B8 over the converted "
          f"pool {ms:.4f} ms (without descales {bf16_ms:.4f} ms), the "
          f"conversion {dq_ms:.4f} ms ({reached} pages; plain "
          f"{dq_plain_ms:.4f} ms, bound {dq['bound_ms']:.4f} ms), the whole "
          f"call {whole_ms:.4f} ms (profiler: B8 "
          f"{split['varlen_paged_kernel']:.4f}, conversion "
          f"{split['kv_dequant_kernel']:.4f}, torch ops "
          f"{split['other']:.4f}); plain {plain_ms:.4f} ms, library "
          f"{lib_ms:.4f} ms; bound {timing['bound_ms']:.4f} ms "
          f"({timing['bound_by']}, 1-byte K/V)")
    return err, (timing, dq)


def kvquant_conversion_check(gen):
    """B11's conversion held bitwise on the card: one key at d = 256 whose V
    row holds every code (the two e4m3 NaN codes, 0x7F and 0xFF, left out:
    the store never writes them), scaled by v_descale KV_CODE_VD, through
    B4 (the fp32 partial) and through B8 (via kv_dequant's kernel; bf16
    out): each output column must be its code's value times KV_CODE_VD
    exactly (-0 as +0: an accumulator from 0). Returns the number of codes
    held for each type."""
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp

    held = {}
    for dt in (torch.float8_e4m3fn, torch.int8):
        c = torch.arange(256, dtype=torch.int32, device="cuda").to(
            torch.uint8)
        keep = torch.ones(256, dtype=torch.bool, device="cuda")
        if dt == torch.float8_e4m3fn:
            keep = (c != 0x7F) & (c != 0xFF)
            c = torch.where(keep, c, torch.zeros_like(c))
        # + 0.0: e4m3's -0 (0x80) sums to +0 in an accumulator from 0
        want = c.view(dt).float() * KV_CODE_VD + 0.0
        vs = torch.full((1, 1), KV_CODE_VD, device="cuda")
        q = torch.randn(1, 1, 1, 256, device="cuda", generator=gen).to(
            torch.bfloat16)
        kc = torch.zeros(1, 1, 128, 256, dtype=torch.uint8, device="cuda")
        vc = kc.clone()
        vc[0, 0, 0] = c
        one = torch.ones(1, dtype=torch.int32, device="cuda")
        out_p, _ = flash_decode.flash_attention_decode_partials(
            q, kc.view(dt), vc.view(dt), one, 1, 1 / 16, True,
            v_descale=vs)
        got = out_p[0, 0, 0, 0]
        b4 = torch.equal(got[keep].view(torch.int32),
                         want[keep].view(torch.int32))
        kp = torch.zeros(2, 1, 16, 256, dtype=torch.uint8, device="cuda")
        vp = kp.clone()
        vp[1, 0, 0] = c
        cu = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
        out, _ = fvp.flash_attention_varlen_paged_fwd(
            q[0], kp.view(dt), vp.view(dt), cu, 1, one,
            torch.ones(1, 1, dtype=torch.int32, device="cuda"), causal=True,
            v_descale=vs)
        b8 = torch.equal(out[0, 0][keep].view(torch.int16),
                         want[keep].to(torch.bfloat16).view(torch.int16))
        held[str(dt)[6:]] = int(keep.sum())
        print(f"B11's conversion ({str(dt)[6:]}): {int(keep.sum())} codes "
              f"through B4 bitwise {b4}, through B8 (kv_dequant) bitwise "
              f"{b8}")
        require(b4 and b8, f"the {dt} conversion is not exact")
    return held


def check_kvquant_kernels(gen):
    """Quantized caches on the card: B11's conversion bitwise, B4 on
    KVQUANT_DECODE_CASES and B8 with descales on KVQUANT_VARLEN_CASES
    against their plain versions, the timed shapes (the 913M's decode,
    engine decode and verify steps and its prefix-cached admission, fp8)
    beside the same kernel over a bf16 cache. Returns errors and timings by
    kernels-line name."""
    from flash_attn_tpu_torch.utils.cases import (
        KVQUANT_DECODE_CASES,
        KVQUANT_VARLEN_CASES,
    )

    held = kvquant_conversion_check(gen)
    timed = {"913M decode step, fp8": "flash_decode_kv8",
             "913M engine decode step, fp8": "flash_decode_paged_kv8",
             "913M engine verify step, fp8": "flash_decode_paged_kv8_verify"}
    errs, timings = {"kv_dequant": 0.0}, {"conversion_codes": held}
    for case in KVQUANT_DECODE_CASES:
        row = timed.get(case[0], "flash_decode_kv8" if not case[6] else
                        "flash_decode_paged_kv8" + "_verify" * (case[2] > 1))
        err, t = kvquant_decode_case(gen, case, case[0] in timed)
        errs[row] = max(errs.get(row, 0.0), err)
        if t is not None:
            timings[row] = t
    torch.cuda.empty_cache()
    for i, (case, window, cap) in enumerate(KVQUANT_VARLEN_CASES):
        err, t = kvquant_varlen_case(gen, case, window, cap, i == 0)
        errs["flash_varlen_paged_descale"] = max(
            errs.get("flash_varlen_paged_descale", 0.0), err)
        if t is not None:
            timings["flash_varlen_paged_descale"], timings["kv_dequant"] = t
    torch.cuda.empty_cache()
    return errs, timings


def kv_static(model, ids, name, card, scale, rate_runs: int = 3):
    """Serve ``ids`` from the model's weights over an fp8 cache of
    ``kv_cache_scale`` ``scale`` (a view of the same weights): graphed and
    eagerly (tokens bitwise equal; launches n_layer B1 and n_layer x steps
    B4, every one over the 1-byte cache), then teacher-forced with the
    bf16-cache run's tokens: each decode step's logits within
    KV_DRIFT_BOUND of the bf16 cache's, relative to their largest, and
    wherever the argmax moves, a near-tie the change can flip; then the
    graphed decode rates of the bf16 and the fp8 cache in turns."""
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    n = model.config.n_layer
    batch, prompt = ids.shape
    steps = NEW_TOKENS - 1
    gcfg = GenerationConfig(max_length=prompt + NEW_TOKENS)
    ref_seqs, _, ref_scores = decode(ids, model, gcfg, output_scores=True)
    model._decode_state = None
    view = model_view(model, kv_cache_dtype=torch.float8_e4m3fn,
                      kv_cache_scale=scale)
    label = f"{name} from an fp8 cache (kv_cache_scale {scale})"
    runs = {}
    for cg in (True, False):
        reset_kernel_counts()
        seqs, length, scores = decode(ids, view, gcfg, output_scores=True,
                                      cg=cg)
        torch.cuda.synchronize()
        launches = kernel_counts()
        runs[cg] = seqs, launches
        print(f"{label} ({'graphed' if cg else 'eager'}): served {batch} x "
              f"{prompt}-token prompts to length {length}; launches "
              f"{launches}")
        require(launches == want_counts(flash_fwd=n, flash_decode=n * steps,
                                        flash_decode_kv8=n * steps),
                f"{label}: launch counts {launches}")
        require(bool(torch.isfinite(scores).all()),
                f"{label}: non-finite decode logits")
    require(torch.equal(runs[True][0], runs[False][0]),
            f"{label}: graphed and eager tokens differ")
    view._decode_state = None
    _, _, tf = decode(ids, view, gcfg, output_scores=True,
                      teacher_outputs=ref_seqs)
    view._decode_state = None
    tf, ref = tf[1:steps + 1], ref_scores[1:steps + 1]  # the decode steps
    drift = [float((tf[t] - ref[t]).abs().max() / ref[t].abs().max())
             for t in range(steps)]
    # where the argmax moves, the fp8 cache's token is a near-tie of the
    # bf16 cache's: its bf16 logit below the top by no more than twice the
    # row's largest logit change (a flip the change itself can make)
    top = tf.argmax(-1)
    same = top == ref.argmax(-1)
    agree = float(same.float().mean())
    gap = ref.max(-1).values - ref.gather(-1, top[..., None])[..., 0]
    moved = (tf - ref).abs().amax(-1)
    tie_ratio = float(torch.where(same, 0.0, gap / (2 * moved)).max())
    print(f"{label}: decode logits teacher-forced with the bf16 cache's "
          f"tokens against the bf16 cache's: relative drift largest "
          f"{max(drift):.4f}, last step {drift[-1]:.4f} (bound "
          f"{KV_DRIFT_BOUND}); argmax agreement {agree:.4f}, where the "
          f"argmax moves the bf16 logit gap at most {tie_ratio:.3f} of "
          f"twice the row's change (bound 1); fp8 tokens equal to the bf16 "
          f"cache's {float((runs[True][0] == ref_seqs).float().mean()):.4f}")
    require(max(drift) < KV_DRIFT_BOUND and tie_ratio <= 1.0,
            f"{label}: logits drift from the bf16 cache's")
    rates = {"bf16": [], "fp8": []}
    for m, key in ((model, "bf16"), (view, "fp8"), (view, "fp8"),
                   (model, "bf16")):
        _, tok_s = static_rates(m, ids, modes=(True,), runs=rate_runs)
        rates[key].append(tok_s[True][0])
    model._decode_state = view._decode_state = None
    torch.cuda.empty_cache()
    res = {"scale": scale, "drift_max": max(drift), "drift_last": drift[-1],
           "argmax_agreement": agree, "tie_ratio": tie_ratio,
           "decode_tokens_per_s": statistics.mean(rates["fp8"]),
           "bf16_decode_tokens_per_s": statistics.mean(rates["bf16"]),
           "rates_in_turns": rates}
    print(f"{label}: decode {res['decode_tokens_per_s']:.1f} tokens/s "
          f"graphed against {res['bf16_decode_tokens_per_s']:.1f} from the "
          f"bf16 cache (in turns: bf16 {rates['bf16'][0]:.1f}, fp8 "
          f"{rates['fp8'][0]:.1f}, fp8 {rates['fp8'][1]:.1f}, bf16 "
          f"{rates['bf16'][1]:.1f}) on {card}")
    return runs[True][1], res


def kv_logit_noise(model, view, prompts) -> float:
    """The largest |logit| the fp8 cache of ``view`` moves from ``model``'s
    bf16 cache (the same weights): static decode of ``prompts`` from the
    bf16 cache, then both teacher-forced over its tokens (linear caches),
    the decode steps' logits compared."""
    from flash_attn_tpu_torch.serving.generation import (
        GenerationConfig,
        decode,
    )

    ids = torch.as_tensor(np.stack(prompts), device="cuda", dtype=torch.long)
    gcfg = GenerationConfig(max_length=ids.shape[1] + NEW_TOKENS)
    bf16, fp8 = linear_view(model), linear_view(view)
    seqs, _, ref = decode(ids, bf16, gcfg, output_scores=True, cg=False)
    _, _, tf = decode(ids, fp8, gcfg, output_scores=True, cg=False,
                      teacher_outputs=seqs)
    noise = float((tf[1:] - ref[1:]).abs().max())
    print(f"the fp8 cache moves the engine model's decode logits by up to "
          f"{noise:.4f} from the bf16 cache's ({len(prompts)} prompts, "
          f"teacher-forced)")
    return noise


def run_kvquant_913m(gen, card):
    """The 913M GPT served from an fp8 cache at kv_cache_scale 1.0 and 2.0:
    static decode (kv_static, run_slice's weights), then the paged, the
    prefix-cached and the speculative engine (the target as its own draft)
    on the first KV_ENGINE_REQUESTS / KV_SPEC_REQUESTS requests of the
    engine traces over KV_ENGINE_REQUESTS slots (engine_model's weights),
    graphed; the engines' tokens
    held to a teacher-forced static decode over the same fp8 cache
    (engine_agreement), the speculative engine's to the plain engine's
    (spec_vs_plain, where they part both within the fp8 cache's measured
    logit movement of the top, kv_logit_noise). Returns the launches of
    each run and the measurements."""
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel, gpt_913m

    launches, out = {}, {}
    cfg = gpt_913m(max_decode_seqlen=PROMPT + NEW_TOKENS + 8)
    model = GPTLMHeadModel(cfg, device="cuda")
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(1))
    model.requires_grad_(False)
    ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda",
                        generator=gen)
    for scale in KV_SCALES:
        key = f"913M fp8 x{scale}"
        launches[key], out[key] = kv_static(model, ids, "913M", card, scale)
    del model
    torch.cuda.empty_cache()

    model = engine_model()
    vocab = model.config.vocab_size
    rng = np.random.default_rng(0)
    prompts = list(rng.integers(0, vocab, (ENGINE_REQUESTS, ENGINE_PROMPT),
                                dtype=np.int64))[:KV_ENGINE_REQUESTS]
    shared = rng.integers(0, vocab, PREFIX_SHARED, dtype=np.int64)
    px = [np.concatenate([shared, rng.integers(
        0, vocab, ENGINE_PROMPT - PREFIX_SHARED, dtype=np.int64)])
        for _ in range(KV_ENGINE_REQUESTS)]
    for scale in KV_SCALES:
        view = model_view(model, kv_cache_dtype=torch.float8_e4m3fn,
                          kv_cache_scale=scale)
        tokens = {}
        for kind, trace, prefix in (("paged", prompts, False),
                                    ("prefix-cache", px, True)):
            key = f"913M fp8 x{scale} {kind} engine"
            launches[key], tokens[kind], out[key] = run_engine(
                view, trace, prefix, card, name=key, kv8=True,
                slots=KV_ENGINE_REQUESTS)
            # the prefix-cached admission attends over the quantized
            # prefix (B8 over the converted pages) where the static
            # prefill attends over bf16 K/V, as JAX's does, so near-ties
            # flip more often than between two bf16 paths: the share is
            # held to KV_ENGINE_AGREEMENT, the token's gap to LOGIT_BOUND
            # as ever
            out[key]["agreement"], out[key]["logit_gap"] = engine_agreement(
                view, trace, tokens[kind], key, KV_ENGINE_AGREEMENT)
        key = f"913M fp8 x{scale} speculative engine"
        spec_prompts = prompts[:KV_SPEC_REQUESTS]
        launches[key], spec, out[key] = run_engine(
            view, spec_prompts, False, card, draft=linear_view(view),
            name=key, kv8=True, slots=KV_ENGINE_REQUESTS)
        # where the two engines part, spec_vs_plain judges the tokens by one
        # bf16 forward, whose logits the fp8 cache moves: the tie bound is
        # that movement, measured on these weights (kv_logit_noise)
        noise = kv_logit_noise(model, view, spec_prompts[:BATCH])
        out[key]["fp8_logit_noise"] = noise
        out[key]["equal_to_plain"] = spec_vs_plain(
            view, spec_prompts, spec, tokens["paged"][:KV_SPEC_REQUESTS], key,
            tie_bound=noise)
        require(out[key]["mean_accepted"] >= MIN_SELF_ACCEPTED,
                f"{key}: proposals rejected ({out[key]['mean_accepted']:.3f} "
                f"accepted of {SPEC_K} a round, bound "
                f"{MIN_SELF_ACCEPTED:.3f})")
        del view
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return launches, out


# ---- head dim 80 in serving (B1, B4 d = dv and B8 at 80) --------------------

# BTLM-3B-8K (cerebras/btlm-3b-8k-base config.json): a GPT-2 body with ALiBi
# positions, a SwiGLU MLP of 6826, muP's scalars (mup_scale_qk_dot_by_d: a
# softmax scale of 1/80) and tied embeddings, 32 heads of 80; served at full
# width and depth from a seeded checkpoint in HF's names (GPT-2's Conv1D
# layouts) through the port's adapter. The attribute names are those the
# HF config answers to (its attribute_map: hidden_size for n_embd, ...).
BTLM_3B = SimpleNamespace(
    vocab_size=50257, n_positions=8192, hidden_size=2560,
    num_hidden_layers=32, num_attention_heads=32, n_inner=6826,
    position_embedding_type="alibi", activation_function="swiglu",
    layer_norm_epsilon=1e-5, mup_width_scale=0.1, mup_embeddings_scale=14.6,
    mup_output_alpha=2.22, mup_scale_qk_dot_by_d=True)


def check_head_dim_80_kernels(gen):
    """Head dim 80 on the card (B1, B4 d = dv and B8, the kernels of
    flash_fwd_80.cu, flash_decode_80.cu and flash_varlen_paged_80.cu):
    B1 with the score map (HD80_SCORE_FWD_CASES, BTLM's prefill at its own
    scale 1/80), without the band or the map (HD80_FWD_CASES) and with the
    band (HD80_BAND_FWD_CASES); B4 linear, paged and at the verify step
    under ALiBi (HD80_SCORE_DECODE_CASES, BTLM's steps at 1/80), under the
    band (HD80_BAND_DECODE_CASES) and over 1-byte caches with descales
    (HD80_KVQUANT_DECODE_CASES); B8 plain, under a window and the cap
    (HD80_VARLEN_CASES) and with descales over 1-byte pages
    (HD80_KVQUANT_VARLEN_CASES): each against its plain version, the timed
    shapes beside their bounds, plain versions and library calls. Then the
    entry points a user calls for B8 and for B4 over a 1-byte cache at 80,
    which no model path at 80 reaches (BTLM's prefix cache is refused,
    ROADMAP.md queue C, and it serves from a bf16 cache), each once at
    BTLM's shape with the counts at 0 just before: flash_attn_varlen_func
    (block_table=) and flash_attn_with_kvcache over an fp8 page pool with
    descales, each bitwise equal to its wrapper's own call. Returns errors,
    timings and those launches by kernels-line name."""
    from flash_attn_tpu_torch import (
        flash_attn_varlen_func,
        flash_attn_with_kvcache,
    )
    from flash_attn_tpu_torch.cache.kvcache import _default_num_splits
    from flash_attn_tpu_torch.dispatch.kvquant import combined_descales
    from flash_attn_tpu_torch.kernels import flash_decode
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.utils.cases import (
        BTLM_SCALE,
        HD80_BAND_DECODE_CASES,
        HD80_BAND_FWD_CASES,
        HD80_FWD_CASES,
        HD80_KVQUANT_DECODE_CASES,
        HD80_KVQUANT_VARLEN_CASES,
        HD80_SCORE_DECODE_CASES,
        HD80_SCORE_FWD_CASES,
        HD80_VARLEN_CASES,
        kv_codes,
        kv_descales,
        score_slopes,
    )

    errs, timings = {}, {}

    def keep(row, err, t=None, case=None):
        errs[row] = max(errs.get(row, 0.0), err)
        if t is not None:
            if case is None:
                timings.setdefault(row, {}).update(t)
            else:
                timings.setdefault(row, {}).setdefault("cases", {})[case] = t

    for case in HD80_SCORE_FWD_CASES:
        btlm = case[0].startswith("BTLM")
        err, t = score_fwd_case(gen, case, btlm, BTLM_SCALE if btlm else None)
        keep("flash_fwd_d80", err, t)
        torch.cuda.empty_cache()
    for i, case in enumerate(HD80_FWD_CASES):
        (qt, kt, vt), _, _, err = fwd_case(gen, case)
        keep("flash_fwd_d80", err,
             fwd_timing(qt, kt, vt, case, "a GQA shape at d=80")
             if i == 0 else None, "without the map, GQA 32/8")
        del qt, kt, vt
    for case in HD80_BAND_FWD_CASES:
        err, t = band_fwd_case(gen, case, timed=False)
        keep("flash_fwd_d80", err, t, case[0])
        torch.cuda.empty_cache()
    rows = {"BTLM-3B-8K decode step": "flash_decode_d80",
            "BTLM-3B-8K engine decode step": "flash_decode_paged_d80",
            "BTLM-3B-8K engine verify step": "flash_decode_paged_d80_verify"}
    for case in HD80_SCORE_DECODE_CASES:
        timed = case[0] in rows
        row = rows.get(case[0], "flash_decode_paged_d80" if case[6]
                       else "flash_decode_d80")
        err, t = score_decode_case(gen, case, timed,
                                   BTLM_SCALE if timed else None)
        keep(row, err, t)
    for case in HD80_BAND_DECODE_CASES:
        err, t, _ = band_decode_case(gen, case, False)
        keep("flash_decode_paged_d80", err, t, case[0])
    for i, case in enumerate(HD80_KVQUANT_DECODE_CASES):
        err, t = kvquant_decode_case(gen, case, i == 0)
        keep("flash_decode_kv8_d80", err, t)
    torch.cuda.empty_cache()
    for i, (case, cap, window) in enumerate(HD80_VARLEN_CASES):
        before = fvp.launches_score
        err, t = varlen_paged_case(gen, case, with_b6=False, timed=i == 0,
                                   window=tuple(None if x < 0 else x
                                                for x in window),
                                   softcap=cap)
        require(fvp.launches_score - before >= 2 * (cap > 0),
                f"flash_varlen_paged {case[0]}: the score map did not run")
        keep("flash_varlen_paged_d80", err, t)
    for case, window, cap in HD80_KVQUANT_VARLEN_CASES:
        err, _ = kvquant_varlen_case(gen, case, window, cap, False)
        keep("flash_varlen_paged_d80", err)
    torch.cuda.empty_cache()

    # the entry points, counted: B8 at BTLM's admission (8 chunks of 256
    # over 512 keys, pages of 256, scale 1/80)
    (_, lens_q, lens_k, _, h, h_k, d, page, dtype, causal), _, _ = \
        HD80_VARLEN_CASES[0]
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                      dtype=torch.int32, device="cuda")
    q = torch.randn(int(cu[-1]), h, d, device="cuda", generator=gen).to(dtype)
    kp, vp, table = paged_cache(gen, len(lens_q), h_k, d, page, max(lens_k),
                                dtype)
    seqlens_k = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    launches = {}
    reset_kernel_counts()
    out = flash_attn_varlen_func(
        q, kp, vp, cu, None, max(lens_q), max(lens_k), causal=causal,
        softmax_scale=BTLM_SCALE, block_table=table, seqused_k=seqlens_k)
    torch.cuda.synchronize()
    launches["flash_varlen_paged_d80"] = got = kernel_counts()
    require(got == want_counts(flash_varlen_paged=1),
            f"flash_attn_varlen_func(block_table=) at d=80: launches {got}")
    want, _ = fvp.flash_attention_varlen_paged_fwd(
        q, kp, vp, cu, max(lens_q), seqlens_k, table, causal=causal,
        softmax_scale=BTLM_SCALE)
    require(torch.equal(out, want) and bool(torch.isfinite(out).all()),
            "flash_attn_varlen_func(block_table=) at d=80 differs from B8's "
            "wrapper")
    del q, kp, vp, table, out, want
    # B4 over an fp8 page pool with descales at BTLM's engine decode step
    # (16 slots of 543 keys, pages of 256, ALiBi, scale 1/80)
    _, b, sq, h, h_k, d, page, keys, cdt, _, _, _ = \
        HD80_KVQUANT_DECODE_CASES[0]
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(
        torch.bfloat16)
    kp, vp, table = paged_cache(gen, b, h_k, d, page, keys, torch.float32)
    (kc, unit), (vc, _) = kv_codes(kp, cdt), kv_codes(vp, cdt)
    qd, kd, vd = (x.cuda() for x in kv_descales(b, h_k))
    kd, vd = kd * unit, vd * unit
    seqlens = torch.full((b,), keys, dtype=torch.int32, device="cuda")
    slopes = score_slopes("1d", b, h, "cuda")
    reset_kernel_counts()
    out = flash_attn_with_kvcache(
        q, kc, vc, cache_seqlens=seqlens, block_table=table,
        softmax_scale=BTLM_SCALE, causal=True, alibi_slopes=slopes,
        q_descale=qd, k_descale=kd, v_descale=vd)
    torch.cuda.synchronize()
    launches["flash_decode_kv8_d80"] = got = kernel_counts()
    require(got == want_counts(flash_decode_paged=1, flash_decode_paged_kv8=1,
                               flash_decode_paged_score=1),
            f"flash_attn_with_kvcache over an fp8 cache at d=80: launches "
            f"{got}")
    qk, vs = combined_descales(b, h_k, qd, kd, vd, q.device)
    want, _ = flash_decode.flash_attention_decode(
        q, kc, vc, seqlens, softmax_scale=BTLM_SCALE, causal=True,
        num_splits=_default_num_splits(q, kc, vc, table, False),
        block_table=table, alibi_slopes=slopes, qk_descale=qk, v_descale=vs)
    require(torch.equal(out, want) and bool(torch.isfinite(out).all()),
            "flash_attn_with_kvcache over an fp8 cache at d=80 differs from "
            "B4's wrapper")
    print(f"head dim 80 entry points, counted: flash_attn_varlen_func("
          f"block_table=) at BTLM's admission: "
          f"{launches['flash_varlen_paged_d80']}; flash_attn_with_kvcache "
          f"over an fp8 page pool with descales at its engine decode step: "
          f"{launches['flash_decode_kv8_d80']}")
    del q, kp, vp, kc, vc, table, out, want
    torch.cuda.empty_cache()
    return errs, timings, launches


def btlm_spec(c) -> HFSpec:
    e, f = c.hidden_size, c.n_inner
    spec = HFSpec()
    spec.embedding("transformer.wte", c.vocab_size, e)
    for i in range(c.num_hidden_layers):
        p = f"transformer.h.{i}."
        spec.norm(p + "ln_1", e)
        spec.norm(p + "ln_2", e)
        # GPT-2's Conv1D weights are (in, out)
        for name, n_in, n_out in (("attn.c_attn", e, 3 * e),
                                  ("attn.c_proj", e, e),
                                  ("mlp.c_fc", e, f), ("mlp.c_fc2", e, f),
                                  ("mlp.c_proj", f, e)):
            spec[p + name + ".weight"] = ((n_in, n_out), n_in ** -0.5)
            spec[p + name + ".bias"] = ((n_out,), 0.02)
    spec.norm("transformer.ln_f", e)
    return spec


def run_btlm(card):
    """BTLM-3B-8K at full width and depth (BTLM_3B, its published
    config.json numbers), a seeded checkpoint in HF's names remapped a
    layer at a time through the port's adapter (every MHA at the softmax
    scale 1/80 that muP's mup_scale_qk_dot_by_d sets): static serving of
    BATCH x PROMPT tokens to NEW_TOKENS new ones, graphed and eager
    (serve_static with every launch the score map's at head dim 80: ALiBi
    in B1 and B4), TTFT, the decode rate beside the weights' read and the
    peak memory; ALiBi in force (the same weights with use_alibi=False
    give last-position logits that differ by more than the decode's bf16
    noise); then the paged engine (BREADTH_REQUESTS prompts on
    BREADTH_SLOTS slots) and the speculative engine with the target as its
    own draft (SPEC_K: B4's verify step at 80 under ALiBi), held to a
    teacher-forced static decode and to the plain engine; the prefix-cached
    engine must refuse the model (ROADMAP.md queue C). Returns launches and
    measurements."""
    from flash_attn_tpu_torch.serving.engine import InferenceEngine, PagePool
    from flash_attn_tpu_torch.serving.generation import GenerationConfig
    from flash_attn_tpu_torch.utils.cases import BTLM_SCALE

    rng = np.random.default_rng(25)
    launches, out = {}, {}
    name = "BTLM-3B-8K"
    t0 = time.perf_counter()
    model, peak = hf_model("btlm", BTLM_3B, btlm_spec, 19,
                           max_decode_seqlen=PROMPT + NEW_TOKENS)
    build_s = time.perf_counter() - t0
    cfg = model.config
    mixers = [layer.mixer for layer in model.transformer.layers]
    require(cfg.use_alibi and cfg.n_layer == 32 and cfg.n_embd == 2560
            and cfg.n_head == 32 and cfg.n_inner == 6826 and cfg.glu_act
            and cfg.tie_word_embeddings
            and all(m.head_dim == 80 and m.softmax_scale == BTLM_SCALE
                    for m in mixers),
            f"{name}: the adapter's config")
    print(f"{name} built from its config (the BTLM adapter: ALiBi, SwiGLU, "
          f"muP, 32 heads of 80 at softmax scale 1/80) and a seeded HF "
          f"checkpoint in {build_s:.1f} s (peak {peak:.2f} GB) on {card}")
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)),
                          device="cuda")
    torch.cuda.reset_peak_memory_stats()
    launches[name], _, noise = serve_static(model, ids, name, score=True)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    ttft, tok_s = static_rates(model, ids, modes=(True, False))
    model._decode_state = None
    plain = model_view(model, use_alibi=False)
    gap, same_top = effect_gap(model, plain, ids)
    print(f"{name}: ALiBi in force: last-position logits with and without "
          f"the slopes differ by {gap:.4f} at most (the decode's own bf16 "
          f"noise against the teacher-forced forward: {noise:.4f}), the same "
          f"top token in {same_top:.2f} of the rows")
    require(gap > noise, f"{name}: ALiBi changes the logits by no more than "
            "the bf16 noise")
    del plain
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    out[name] = {"params_b": n_params / 1e9, "layers": cfg.n_layer,
                 "build_s": build_s, "build_peak_gb": peak,
                 "serve_peak_gb": serve_peak, "ttft_ms": ttft * 1e3,
                 "decode_tokens_per_s": tok_s[True][0],
                 "decode_tokens_per_s_eager": tok_s[False][0],
                 "decode_step_ms": BATCH / tok_s[True][0] * 1e3,
                 "weight_read_ms": weight_bytes / PEAK_BYTES * 1e3,
                 "alibi_logit_gap": gap, "decode_noise": noise}
    print(f"{name} ({n_params / 1e9:.2f}B parameters, {cfg.n_layer} layers, "
          f"width {cfg.n_embd}, {cfg.n_head} heads of 80, ALiBi): TTFT "
          f"{ttft * 1e3:.2f} ms (b={BATCH} x {PROMPT}), decode "
          f"{tok_s[True][0]:.1f} tokens/s graphed ({tok_s[False][0]:.1f} "
          f"eager), a step {out[name]['decode_step_ms']:.3f} ms against "
          f"{out[name]['weight_read_ms']:.3f} ms to read its "
          f"{weight_bytes / 1e9:.2f} GB of weights once at 3.35 TB/s; peak "
          f"{serve_peak:.2f} GB serving, on {card}")
    torch.cuda.empty_cache()

    paged = paged_view(model, BREADTH_SLOTS)
    prompts = list(rng.integers(0, cfg.vocab_size,
                                (BREADTH_REQUESTS, ENGINE_PROMPT)))
    ename = f"{name} paged engine"
    torch.cuda.reset_peak_memory_stats()
    launches[ename], tokens, out[ename] = run_engine(
        paged, prompts, False, card, slots=BREADTH_SLOTS, name=ename,
        score=True)
    out[ename]["agreement"], out[ename]["logit_gap"] = engine_agreement(
        paged, prompts, tokens, ename, MIN_ARGMAX_AGREEMENT)
    out[ename]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    sname = f"{name} speculative engine"
    launches[sname], spec, out[sname] = run_engine(
        paged, prompts, False, card, slots=BREADTH_SLOTS, name=sname,
        draft=linear_view(paged), score=True)
    out[sname]["equal_to_plain"] = spec_vs_plain(paged, prompts, spec, tokens,
                                                 sname, tie_bound=noise)
    out[sname]["agreement"], out[sname]["logit_gap"] = engine_agreement(
        paged, prompts, spec, sname, MIN_ARGMAX_AGREEMENT)
    try:
        InferenceEngine(paged, BREADTH_SLOTS, GenerationConfig(top_k=1),
                        page_pool=PagePool(paged.config.paged_kv_num_pages,
                                           ENGINE_PAGE, 3, BREADTH_SLOTS),
                        prefix_cache=True)
        refused = None
    except ValueError as e:
        refused = str(e)
    require(refused is not None and "queue C" in refused,
            f"{name}: the prefix-cached engine took an ALiBi model")
    print(f"{name}: the prefix-cached engine refuses the model: {refused}")
    out[name]["prefix_cache_refused"] = refused
    del model, paged
    torch.cuda.empty_cache()
    return launches, out


# ---- Head dim 80 in training: B2, B3, B6's backward and their preprocess
# and the packed forwards B6 and B7 at 80 (the *_80.cu sources), and
# BTLM-3B-8K trained at full width ------------------------------------------

# BTLM-3B-8K (BTLM_3B through the port's BTLM adapter: ALiBi, SwiGLU, muP's
# scales, softmax scale 1/80) trained at full width at BTLM_TRAIN_BATCH x
# BTLM_TRAIN_SEQ: its own 8K positions under ALiBi, the 8,192 tokens a step
# of the other training cells. Reckoned before the run: 2.65B parameters at
# ~12 bytes of training state each (bf16 weights and gradients, fp32
# masters, bf16 moments) are ~32 GB; the activations of 8192 tokens ~0.95
# GB a layer (Mistral-7B's ~1.75 GB a layer, scaled by 8 x its width + 3 x
# its MLP's width), ~30 GB at 32 layers; with the ~13 GB by which
# Baichuan-13B's peak passed its reckoning, ~75 GB at 32 layers.
BTLM_TRAIN_LAYERS, BTLM_TRAIN_BATCH, BTLM_TRAIN_SEQ = 8, 1, 8192


def hd80_bwd_case(gen, case):
    """B3, B2 and the preprocess at head dim 80 without the band or the map
    on one HD80_BWD_CASES case: dq, dk, dv by the 2x rule against the plain
    fp32 backward (plain_bwd_refs), every launch counted, B3 the same bits
    twice, the preprocess against its plain version; over the same rows
    packed as b sequences B6's backward gives B3's bits, B6's forward and
    B7 give B1's, and B6's preprocess the dense one's rows. Returns the
    errors by kernels-line row (without the _d80 suffix)."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd, flash_varlen
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    b, sq, sk, h, h_k, d, causal, dtype = case
    q, k, v, dout = (torch.randn(b, s, n, d, device="cuda",
                                 generator=gen).to(dtype)
                     for s, n in ((sq, h), (sk, h_k), (sk, h_k), (sq, h)))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, dout))
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal)
    torch.cuda.synchronize()
    reset_kernel_counts()
    b3 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                       causal=causal)
    again = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                          causal=causal)
    b2 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                       causal=causal, deterministic=False)
    torch.cuda.synchronize()
    got = bwd_counts()
    require(got == {"flash_fwd": 0, "flash_bwd_preprocess": 3,
                    "fa_bwd_dkdv": 2, "fa_bwd_dq": 2, "flash_bwd_fused": 1,
                    "flash_fwd_band": 0, "fa_bwd_dkdv_band": 0,
                    "fa_bwd_dq_band": 0, "flash_bwd_fused_band": 0,
                    **NO_SCORE},
            f"backward launches at d=80 {case}: {got}")
    require(all(torch.equal(a, c) for a, c in zip(b3, again)),
            f"B3 differs between runs at d=80: {case}")
    del again
    out32, out_lp, ref, ref_lp = plain_bwd_refs(qt, kt, vt, dot, causal)
    err_f, _ = check_against_ref(out.transpose(1, 2), out32.transpose(1, 2),
                                 out_lp, msg=f"flash_fwd d=80 {case}")
    errs, line = {}, []
    for row, grads in (("flash_bwd", b3), ("flash_bwd_fused", b2)):
        for gname, g, r, lp in zip("qkv", grads, ref, ref_lp):
            err, err_lp = check_against_ref(
                g.transpose(1, 2), r.transpose(1, 2), lp, atol=BWD_ATOL,
                msg=f"{row} d{gname} d=80 {case}")
            errs[row] = max(errs.get(row, 0.0), err)
            line.append(f"{'B3' if row == 'flash_bwd' else 'B2'} d{gname} "
                        f"{err:.3e} (low precision {err_lp:.3e})")
    del out32, out_lp, ref, ref_lp, b2
    delta, lse2 = flash_bwd.bwd_preprocess(dot, out, lse)
    want_delta, want_lse2 = flash_bwd.bwd_preprocess_plain(
        dot, out, lse, delta.shape[-1])
    fin = torch.isfinite(want_lse2)
    require(torch.equal(torch.isfinite(lse2), fin)
            and float((lse2[fin] - want_lse2[fin]).abs().max()) <= 1e-5,
            f"preprocess lse2 at d=80: {case}")
    pre_err = float((delta - want_delta).abs().max())
    require(pre_err <= 1e-3, f"preprocess delta err {pre_err} at d=80: {case}")
    reset_kernel_counts()
    b6 = packed_b6_backward(dot, qt, kt, vt, out, lse, causal)()
    require(all(torch.equal(a, c) for a, c in zip(b3, b6)),
            f"B6's backward over the same rows packed differs from B3's at "
            f"d=80: {case}")
    for label, (o, l) in zip(("B6's forward", "B7"),
                             packed_forwards(qt, kt, vt, causal)):
        require(torch.equal(o, out) and torch.equal(l, lse),
                f"{label} over the same rows packed differs from B1's at "
                f"d=80: {case}")
    torch.cuda.synchronize()
    got = kernel_counts()
    require(got == want_counts(flash_varlen_fwd=1,
                               flash_varlen_fwd_persistent=1,
                               fa_varlen_bwd_preprocess=1,
                               fa_varlen_bwd_dkdv=1, fa_varlen_bwd_dq=1),
            f"packed launches at d=80 {case}: {got}")
    cu_q, cu_k = (torch.arange(b + 1, dtype=torch.int32, device="cuda") * n
                  for n in (sq, sk))
    pk = [x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
          for x in (dot, qt, kt, vt, out)]
    lse_p = lse.permute(1, 0, 2).reshape(h, b * sq).contiguous()
    meta = flash_varlen.varlen_meta(pk[1], pk[2], cu_q, cu_k, sq, sk, None,
                                    None, causal, None)
    vdelta, vlse2 = flash_varlen.varlen_bwd_preprocess(
        pk[0], pk[4], lse_p, cu_q, cu_k, meta,
        *(torch.empty_like(x) for x in pk[1:4]))
    for i in range(b):
        p0 = flash_varlen.padded_row(i * sq, i)
        require(torch.equal(vdelta[:, p0:p0 + sq], delta[i, :, :sq])
                and torch.equal(vlse2[:, p0:p0 + sq], lse2[i, :, :sq]),
                f"B6's preprocess differs from the dense one's at d=80: "
                f"{case}")
    del b3, b6, pk
    errs.update({"flash_bwd_preprocess": pre_err,
                 "flash_varlen_bwd_preprocess": pre_err,
                 "fa_varlen_bwd_dkdv": errs["flash_bwd"],
                 "fa_varlen_bwd_dq": errs["flash_bwd"],
                 "flash_varlen_fwd": err_f,
                 "flash_varlen_fwd_persistent": err_f})
    print(f"backward at d=80, b={b} sq={sq} sk={sk} {h}/{h_k} heads, "
          f"{str(dtype)[6:]}, causal={causal}: B1 out {err_f:.3e}; "
          + ", ".join(line) + f"; B3 bitwise equal twice, B6's backward "
          f"over the same rows packed bitwise B3's, B6's forward and B7 "
          f"bitwise B1's, B6's preprocess the dense one's rows; preprocess "
          f"delta max abs err {pre_err:.3e}, lse2 within 1e-5")
    return errs


def hd80_preprocess_timing(gen, case):
    """The dense and the packed preprocess at a HD80_SCORE_BWD_CASES case's
    shape (BTLM-3B-8K's training shape: b x sq rows of 32 heads of 80,
    the rows packed as b sequences for B6's), each beside its plain
    version (the packed one, which reads the lengths back, on the host's
    clock), torch.linalg.vecdot(dO, O) and a bound (the bytes of dO, O,
    lse and the two padded outputs, against fp32's rate for the products).
    Returns the timings by kernels-line row."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd, flash_varlen

    _, b, sq, sk, h, h_k, d, causal, _, _, _, dtype, _ = case
    q, k, v, dout = (torch.randn(b, s, n, d, device="cuda",
                                 generator=gen).to(dtype)
                     for s, n in ((sq, h), (sk, h_k), (sk, h_k), (sq, h)))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, dout))
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal)
    esz = qt.element_size()
    lib = {"library_ms": time_ms(lambda: torch.linalg.vecdot(dot, out)),
           "library_call": f"torch.linalg.vecdot(dO, O) (in "
                           f"{str(dtype)[6:]})"}
    sq_pad = -(-sq // 128) * 128
    t = {"flash_bwd_preprocess": {
        "ms": time_ms(lambda: flash_bwd.bwd_preprocess(dot, out, lse)),
        "plain_ms": time_ms(lambda: flash_bwd.bwd_preprocess_plain(
            dot, out, lse, 128)), **lib,
        **bound(2 * b * h * sq * d, esz * 2 * b * h * sq * d + 4 * b * h * sq
                + 2 * 4 * b * h * sq_pad, PEAK_FP32)}}
    cu = torch.arange(b + 1, dtype=torch.int32, device="cuda") * sq
    pk = [x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
          for x in (dot, out, qt, kt, vt)]
    lse_p = lse.permute(1, 0, 2).reshape(h, b * sq).contiguous()
    meta = flash_varlen.varlen_meta(pk[2], pk[3], cu, cu, sq, sk, None, None,
                                    causal, None)
    grads = [torch.empty_like(x) for x in pk[2:]]
    rows = b * sq
    t["flash_varlen_bwd_preprocess"] = {
        "ms": time_ms(lambda: flash_varlen.varlen_bwd_preprocess(
            pk[0], pk[1], lse_p, cu, cu, meta, *grads)),
        "plain_ms": wall_ms(lambda: flash_varlen.varlen_bwd_preprocess_plain(
            pk[0], pk[1], lse_p, cu, None)), **lib,
        **bound(2 * h * rows * d, esz * 2 * rows * h * d + 4 * h * rows
                + 2 * 4 * h * (rows + 132 * b), PEAK_FP32)}
    for row, r in t.items():
        print(f"{row}_d80 at {case[0]}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
              f"({r['library_call']})")
    return t


def check_head_dim_80_backward(gen, lib):
    """Head dim 80 in training on the card (the kernels of flash_bwd_80.cu,
    flash_bwd_score_80.cu, flash_varlen_80.cu, flash_varlen_score_80.cu and
    flash_varlen_fwd_80.cu): B3, B2 and the preprocess without the band or
    the map (HD80_BWD_CASES, hd80_bwd_case), with the band
    (HD80_BAND_BWD_CASES, band_bwd_case) and with the score map
    (HD80_SCORE_BWD_CASES, score_bwd_case; BTLM-3B-8K's training shape at
    its scale 1/80 timed, with the counted
    flash_attn_func(deterministic=False).backward() that is B2's only run
    at 80, since no model path selects it), each against its plain version
    by the 2x rule and the same bits twice, B6's backward over the same
    rows bitwise B3's and B7's and B6's forwards bitwise B1's; the
    preprocess kernels timed at BTLM's shape (hd80_preprocess_timing); no
    kernel reading or writing past column 80 (kept_columns_check in each
    form); and the registers and spills of every kernel at 80
    (cuobjdump -res-usage). Returns the errors and timings by kernels-line
    row, the counted flash_attn_func runs' launches and the registers."""
    from flash_attn_tpu_torch.utils.cases import (
        HD80_BAND_BWD_CASES,
        HD80_BWD_CASES,
        HD80_SCORE_BWD_CASES,
        case_scale,
    )
    from flash_attn_tpu_torch.utils.testing import kept_columns_check

    errs, timings, api = {}, {}, {}

    def keep(row, err):
        key = f"{row}_d80"
        errs[key] = max(errs.get(key, 0.0), err)

    for case in HD80_BWD_CASES:
        for row, e in hd80_bwd_case(gen, case).items():
            keep(row, e)
        torch.cuda.empty_cache()
    for case in HD80_BAND_BWD_CASES:
        e, _, _ = band_bwd_case(gen, case, timed=False)
        for row, x in e.items():
            keep(row.removesuffix("_band"), x)
        torch.cuda.empty_cache()
    for case in HD80_SCORE_BWD_CASES:
        timed = case[0].startswith("BTLM")
        e, t, a = score_bwd_case(gen, case, timed, case_scale(case[0]))
        for row, x in e.items():
            keep(row, x)
        if timed:
            timings.update({f"{row}_d80": r for row, r in t.items()})
            api = a
            timings.update({f"{row}_d80": r for row, r in
                            hd80_preprocess_timing(gen, case).items()})
        torch.cuda.empty_cache()
    for form in ("plain", "band", "score"):
        tails, gap = kept_columns_check(form)
        print(f"head dim 80 ({form}): over inputs whose heads of 80 sit in "
              f"rows of 96 (the last 16 NaN) every kernel gives the bits of "
              f"contiguous inputs; {tails} outputs written into rows of 96 "
              f"with a sentinel past column 80 (and B2's fp32 dQ buffer with "
              f"a sentinel tail) keep every sentinel; B2's dq within "
              f"{gap:.3e} of its contiguous run")
    torch.cuda.empty_cache()
    ty = "13__nv_bfloat16"
    marks = {"preprocess": ("dense_bwd17preprocess_kernel", ty, "Li80E"),
             "varlen preprocess": ("varlen_preprocess_kernel", ty, "Li80E")}
    for form, flags in (("", "Lb0E"), ("band ", "Lb1ELb0E"),
                        ("score ", "Lb1ELb1E")):
        tail = "Lb0E" if not form else ""
        marks.update({
            f"{form}dkdv": ("dense_bwd11dkdv_kernel", ty,
                            f"Li80ELb0E{flags}{tail}"),
            f"{form}dkdv fused": ("dense_bwd11dkdv_kernel", ty,
                                  f"Li80ELb1E{flags}{tail}"),
            f"{form}dq": ("dense_bwd9dq_kernel", ty, f"Li80E{flags}{tail}"),
            f"{form}varlen dkdv": ("varlen_dkdv_kernel", ty, f"Li80E{flags}"),
            f"{form}varlen dq": ("varlen_dq_kernel", ty, f"Li80E{flags}"),
            f"{form}B6 forward": ("17varlen_fwd_kernel", ty, f"Li80E{flags}"),
            f"{form}B7": ("varlen_fwd_persistent_kernel", ty,
                          f"Li80E{flags}")})
    res = kernel_resources(lib, marks)
    print("head dim 80 training kernels' registers / stack / local bytes a "
          "thread (bf16; cuobjdump -res-usage): " + "; ".join(
              f"{label} " + ", ".join(
                  f"{u.get('REG')}/{u.get('STACK')}/{u.get('LOCAL')}"
                  for u in us) for label, us in res.items()))
    return errs, timings, api, res


def run_btlm_training(card):
    """BTLM-3B-8K trained at full width from its config.json numbers
    (BTLM_3B through the port's BTLM adapter: ALiBi, SwiGLU, muP's scales,
    32 heads of 80 at softmax scale 1/80, tied embeddings) with the depth
    at BTLM_TRAIN_LAYERS, seeded weights (the trainer's initialisation) and
    bf16 training state, by fit_checked at BTLM_TRAIN_BATCH x
    BTLM_TRAIN_SEQ with score=True (per step and layer one score forward,
    one preprocess, one score dK/dV and one score dQ at 80, no launch
    without the map), a profile of one step and causal_check; then the
    packed MHAs at BTLM's widths and scale (run_score_mha: B6's score
    forward and backward under ALiBi, as JAX routes ALiBi, and B7 under
    Gemma-2's cap), counted.
    Returns the training's launches and measurements, and the packed
    MHAs' launches and errors."""
    from flash_attn_tpu_torch.models.hf_adapters import (
        btlm_config_to_gpt_config,
    )
    from flash_attn_tpu_torch.utils.cases import BTLM_SCALE, GEMMA2_SOFTCAP

    cut = SimpleNamespace(**{**vars(BTLM_3B),
                             "num_hidden_layers": BTLM_TRAIN_LAYERS})
    mcfg = btlm_config_to_gpt_config(cut, dtype=torch.bfloat16)
    require(mcfg.use_alibi and mcfg.n_embd == 2560 and mcfg.n_head == 32
            and mcfg.glu_act and mcfg.tie_word_embeddings
            and mcfg.n_layer == BTLM_TRAIN_LAYERS,
            "BTLM-3B-8K training: the adapter's config")
    label = (f"BTLM-3B-8K training ({BTLM_TRAIN_LAYERS} of "
             f"{BTLM_3B.num_hidden_layers} layers, 32 heads of 80, ALiBi, "
             f"softmax scale 1/80)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "btlm.bin")
        write_token_file(path, mcfg.vocab_size)
        launches, res, trainer, loader = fit_checked(
            label, mcfg, path, BTLM_TRAIN_BATCH, BTLM_TRAIN_SEQ, score=True)
        require(all(layer.mixer.head_dim == 80
                    and layer.mixer.softmax_scale == BTLM_SCALE
                    for layer in trainer.model.transformer.layers),
                f"{label}: every MHA at head dim 80 and scale 1/80")
        profile_step(trainer, loader, f"one {label} step", BTLM_TRAIN_BATCH,
                     BTLM_TRAIN_SEQ)
        res["causal_gaps"] = causal_check(trainer, loader, label)
        print(f"{label}: step {res['step_ms']:.1f} ms (median of steps "
              f"{TRAIN_WARM + 1}-{TRAIN_STEPS}), {res['tokens_per_s']:.0f} "
              f"tokens/s, {res['tflops_per_s']:.1f} TFLOP/s "
              f"(model_flops_per_token), peak {res['peak_gb']:.2f} GB "
              f"(max_memory_allocated) on {card}")
        del trainer, loader
    torch.cuda.empty_cache()
    widths = dict(num_heads=BTLM_3B.num_attention_heads,
                  width=BTLM_3B.hidden_size, softmax_scale=BTLM_SCALE)
    forms = {"alibi": dict(widths, use_alibi=True),
             "softcap": dict(widths, softcap=GEMMA2_SOFTCAP)}
    mha_launches, mha_errs = run_score_mha(torch.Generator(
        device="cuda").manual_seed(80), card, forms)
    return launches, res, mha_launches, mha_errs


# gpt-oss-20b's attention stack (the openai/gpt-oss-20b config.json and
# model card, arXiv 2508.10925): 24 layers of 64 query heads on 8 KV heads
# of 64, alternately a sliding window of 128 keys (layer_types
# "sliding_attention", window_size (127, 0) under causal masking) and full
# causal attention, a learnable sink logit a head and layer, at its
# initial_context_length of 4,096 tokens. The JAX package has no model with
# a sink, so the phase drives the attention stack with seeded tensors.
GPT_OSS_20B = SimpleNamespace(num_hidden_layers=24, num_attention_heads=64,
                              num_key_value_heads=8, head_dim=64,
                              sliding_window=128,
                              initial_context_length=4096)
GPT_OSS_BATCH = 2
GPT_OSS_DOCS = [1024, 2048, 3072, 2048]  # the packed stack's documents
# dsink, an fp32 sum over every row of a head, against the plain fp32
# backward's by the 2x rule with the low-precision reference's: this floor
DSINK_ATOL = 1e-3


def gpt_oss_window(layer: int):
    """gpt-oss's layer form: even layers slide (127, 0), odd ones attend
    to every earlier key."""
    return (GPT_OSS_20B.sliding_window - 1, 0) if layer % 2 == 0 \
        else (None, None)


def sink_counts():
    """The sink forms' launches since the last reset_kernel_counts()."""
    from flash_attn_tpu_torch.kernels import (
        flash_fwd,
        flash_paged_prefill,
        flash_varlen,
        flash_varlen_paged,
        flash_varlen_persistent,
    )

    return {"flash_fwd_sink": flash_fwd.launches_sink,
            "flash_varlen_fwd_sink": flash_varlen.launches_fwd_sink,
            "flash_varlen_fwd_persistent_sink":
                flash_varlen_persistent.launches_sink,
            "flash_varlen_paged_sink": flash_varlen_paged.launches_sink,
            "flash_paged_prefill_sink": flash_paged_prefill.launches_sink}


# keys the library yardstick appends: the sink's zero key, then zero keys
# masked out, so that the key count stays a multiple of 8
SINK_KEYS = 8


def sink_key_mask(sink, b_mask, dtype):
    """The library yardstick's float mask: the (sq, sk) bool mask of the
    pairs attended as 0 / -inf, then SINK_KEYS columns, the first holding
    each head's sink (the score of an extra zero key), the rest -inf;
    (1, h, sq, sk + SINK_KEYS) in ``dtype``."""
    h, (sq, sk) = sink.shape[0], b_mask.shape[-2:]
    m = torch.full((1, h, sq, sk + SINK_KEYS), float("-inf"), dtype=dtype,
                   device="cuda")
    m[..., :sk].masked_fill_(b_mask, 0.0)
    m[..., sk] = sink.to(dtype)[None, :, None]
    return m


def sink_sdpa(qt, kt, vt, mask, scale=None):
    """scaled_dot_product_attention with the sink as one more key:
    SINK_KEYS zero K and V rows appended to each KV head and ``mask``
    (sink_key_mask) as a float mask, GQA through enable_gqa. Returns
    (forward, backward over dout) functions to time."""
    zero = qt.new_zeros(kt.shape[0], kt.shape[1], SINK_KEYS, kt.shape[3])
    kk = torch.cat([kt, zero], 2)
    vv = torch.cat([vt, zero[..., :1].expand(*zero.shape[:3], vt.shape[3])],
                   2)
    gqa = qt.shape[1] != kt.shape[1]

    def fwd():
        return F.scaled_dot_product_attention(qt, kk, vv, attn_mask=mask,
                                              enable_gqa=gqa, scale=scale)

    def bwd(dot):
        leaves = [x.detach().requires_grad_() for x in (qt, kk, vv)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             enable_gqa=gqa, scale=scale)
        return lambda: torch.autograd.grad(out, leaves, dot,
                                           retain_graph=True)
    return fwd, bwd


def sink_refs(qt, kt, vt, dot, sink, causal, window,
              heads_bytes: float = 1.1e9, scale=None):
    """The 2x rule's references of a sink layer, a batch row and as many KV
    heads at a time as keep each fp32 score matrix within ``heads_bytes``:
    the plain fp32 forward and backward (out, lse, dq, dk, dv, dsink) from
    fp32 copies, and the low-precision ones (attention_ref and autograd
    through it, in the inputs' type; its sink path in fp32 as JAX's), at
    softmax scale ``scale`` (1/sqrt(d) unless given). Inputs (b, h, s, d)
    views (v, dout: dv columns) and the (h,) sink, or None (dsink then 0);
    returns (ref, ref_lp): ref = (out, lse, dq, dk, dv, dsink), out and
    grads (b, h, s, d); ref_lp = (out, dq, dk, dv, dsink), (b, s, h, d)."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref,
        attention_ref_grads,
    )

    b, h, sq, d = qt.shape
    h_k, sk, dv = kt.shape[1], kt.shape[2], vt.shape[3]
    group = h // h_k
    per = max(1, int(heads_bytes // (group * sq * sk * 4)))
    kw = dict(causal=causal, window_size=window, softmax_scale=scale)
    out32 = torch.empty(b, h, sq, dv, device="cuda")
    lse32 = torch.empty(qt.shape[:3], device="cuda")
    g32 = [torch.empty(x.shape, device="cuda") for x in (qt, kt, vt)]
    ds32 = torch.zeros(h, device="cuda")
    out_lp = qt.new_empty(b, sq, h, dv)
    glp = [torch.empty_like(x.transpose(1, 2)) for x in (qt, kt, vt)]
    ds_lp = torch.zeros(h, device="cuda")
    for bi in range(b):
        for k0 in range(0, h_k, per):
            ks = slice(k0, min(k0 + per, h_k))
            qs = slice(ks.start * group, ks.stop * group)
            chunk = [x[bi:bi + 1, hs] for x, hs in
                     ((qt, qs), (kt, ks), (vt, ks), (dot, qs))]
            sk_ = None if sink is None else sink[qs]
            f32 = [x.float() for x in chunk[:3]]
            o, l = flash_fwd.flash_attention_fwd_plain(
                *f32, learnable_sink=sk_, **kw)
            r = flash_bwd.flash_attention_bwd_plain(
                chunk[3].float(), *f32, o, l, learnable_sink=sk_, **kw)
            out32[bi:bi + 1, qs], lse32[bi:bi + 1, qs] = o, l
            for i, hs in enumerate((qs, ks, ks)):
                g32[i][bi:bi + 1, hs] = r[i]
            if sink is not None:
                ds32[qs] += r[3]
            del f32, o, l, r
            bshd = [x.transpose(1, 2) for x in chunk]
            out_lp[bi:bi + 1, :, qs] = attention_ref(
                *bshd[:3], upcast=False, learnable_sink=sk_, **kw)[0]
            lp = attention_ref_grads(*bshd, upcast=False,
                                     learnable_sink=sk_, **kw)
            for i, hs in enumerate((qs, ks, ks)):
                glp[i][bi:bi + 1, :, hs] = lp[i]
            if sink is not None:
                ds_lp[qs] += lp[3]
            del lp
    return (out32, lse32, *g32, ds32), (out_lp, *glp, ds_lp)


def gpt_oss_layer(layer: int, b: int, s: int, packed: bool = False):
    """Seeded bf16 q, k, v, dout and the (h,) sink of one gpt-oss layer:
    (b, s, h, d) tensors, or (b * s, h, d) ones with ``packed``; the sinks
    from utils/cases.py sink_logits (they bite at s keys)."""
    from flash_attn_tpu_torch.utils.cases import sink_logits

    c = GPT_OSS_20B
    gen = torch.Generator(device="cuda").manual_seed(2400 + layer)
    h, h_k, d = c.num_attention_heads, c.num_key_value_heads, c.head_dim
    shape = (lambda n: (b * s, n, d)) if packed else (lambda n: (b, s, n, d))
    q, k, v, do = (torch.randn(*shape(n), device="cuda", generator=gen)
                   .to(torch.bfloat16) for n in (h, h_k, h_k, h))
    sink = sink_logits(h, s, "cuda", gen).to(torch.bfloat16)
    return q, k, v, do, sink


def gpt_oss_stack(packed: bool):
    """All 24 layers of gpt-oss-20b's attention at 2 x 4,096 tokens (or
    packed as GPT_OSS_DOCS through flash_attn_varlen_func), forward and
    backward, each with its trained sink, the counts at 0 before: requires
    every output and gradient finite. Returns the launches."""
    from flash_attn_tpu_torch import flash_attn_func, flash_attn_varlen_func

    c = GPT_OSS_20B
    b, s = GPT_OSS_BATCH, c.initial_context_length
    cu = torch.tensor(np.concatenate([[0], np.cumsum(GPT_OSS_DOCS)]),
                      dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    reset_kernel_counts()
    bad = []
    for i in range(c.num_hidden_layers):
        q, k, v, do, sink = gpt_oss_layer(i, b, s, packed)
        leaves = [x.requires_grad_() for x in (q, k, v, sink)]
        kw = dict(causal=True, window_size=gpt_oss_window(i),
                  learnable_sink=leaves[3])
        if packed:
            out = flash_attn_varlen_func(*leaves[:3], cu, cu,
                                         max(GPT_OSS_DOCS),
                                         max(GPT_OSS_DOCS), **kw)
        else:
            out = flash_attn_func(*leaves[:3], **kw)
        out.backward(do)
        if not all(bool(torch.isfinite(x).all())
                   for x in (out, *(l.grad for l in leaves))):
            bad.append(i)
    torch.cuda.synchronize()
    got = {**bwd_counts(), **kernel_counts(), **sink_counts()}
    require(not bad, f"gpt-oss stack (packed={packed}): non-finite outputs "
                     f"or gradients at layers {bad}")
    n, half = c.num_hidden_layers, c.num_hidden_layers // 2
    if packed:
        want = {"flash_varlen_fwd_persistent": n,
                "flash_varlen_fwd_persistent_band": half,
                "flash_varlen_fwd_persistent_sink": n,
                "fa_varlen_bwd_preprocess": n, "fa_varlen_bwd_dkdv": n,
                "fa_varlen_bwd_dq": n, "fa_varlen_bwd_dkdv_band": half,
                "fa_varlen_bwd_dq_band": half}
    else:
        want = {"flash_fwd": n, "flash_fwd_band": half, "flash_fwd_sink": n,
                "flash_bwd_preprocess": n, "fa_bwd_dkdv": n, "fa_bwd_dq": n,
                "fa_bwd_dkdv_band": half, "fa_bwd_dq_band": half}
    odd = {key: val for key, val in got.items() if val != want.get(key, 0)}
    require(not odd, f"gpt-oss stack (packed={packed}): launches {odd}, "
                     f"want {want}")
    print(f"gpt-oss-20b attention stack ({n} layers, {half} sliding, "
          f"{'packed as ' + str(GPT_OSS_DOCS) if packed else f'b={b} x {s}'}"
          f", 64/8 heads of 64, a trained sink a layer): forward and "
          f"backward finite; launches {want}")
    return got


def sink_dense_checks(errs):
    """Layers 0 (sliding) and 1 (full) at 2 x 4,096: B1's out and lse and
    B3's and B2's dq, dk, dv and dsink against sink_refs by the 2x rule (lse
    within LSE_ATOL), B3 the same bits twice; the counted
    flash_attn_func(deterministic=False).backward(). Returns B2's counts."""
    from flash_attn_tpu_torch import flash_attn_func
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    b, s = GPT_OSS_BATCH, GPT_OSS_20B.initial_context_length
    for layer in (0, 1):
        window = gpt_oss_window(layer)
        q, k, v, do, sink = gpt_oss_layer(layer, b, s)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        kw = dict(causal=True, window_size=window)
        out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt,
                                                 learnable_sink=sink, **kw)
        b3 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                           learnable_sink=sink, **kw)
        again = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                              learnable_sink=sink, **kw)
        require(all(torch.equal(x, y) for x, y in zip(b3, again)),
                f"B3 with a sink differs between runs (layer {layer})")
        b2 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                           deterministic=False,
                                           learnable_sink=sink, **kw)
        del again
        ref, ref_lp = sink_refs(qt, kt, vt, dot, sink.float(), True, window)
        line = []
        e, _ = check_against_ref(out.transpose(1, 2), ref[0].transpose(1, 2),
                                 ref_lp[0], msg=f"B1 sink layer {layer}")
        lse_err = float((lse - ref[1]).abs().max())
        require(lse_err <= LSE_ATOL, f"B1 sink lse err {lse_err}")
        errs["flash_fwd_sink"] = max(errs.get("flash_fwd_sink", 0.0), e)
        line.append(f"B1 out {e:.3e}, lse {lse_err:.3e}")
        for row, g in (("flash_bwd_sink", b3), ("flash_bwd_fused_sink", b2)):
            for name, x, r, lp in zip(("dq", "dk", "dv"), g, ref[2:5],
                                      ref_lp[1:4]):
                e, e_lp = check_against_ref(
                    x.transpose(1, 2), r.transpose(1, 2), lp, atol=BWD_ATOL,
                    msg=f"{row} {name} layer {layer}")
                errs[row] = max(errs.get(row, 0.0), e)
            e, e_lp = check_against_ref(g[3], ref[5], ref_lp[4],
                                        atol=DSINK_ATOL,
                                        msg=f"{row} dsink layer {layer}")
            errs[row] = max(errs[row], e)
            line.append(f"{row} dsink {e:.3e} (low precision {e_lp:.3e}, "
                        f"|dsink| up to {float(ref[5].abs().max()):.3e})")
        print(f"gpt-oss layer {layer} (window {window}) against the plain "
              f"fp32 versions by the 2x rule: " + "; ".join(line)
              + "; B3 bitwise twice")
        del ref, ref_lp, b2, b3
    leaves = [x.requires_grad_() for x in (q, k, v, sink)]
    torch.cuda.synchronize()
    reset_kernel_counts()
    flash_attn_func(*leaves[:3], causal=True, learnable_sink=leaves[3],
                    deterministic=False).backward(do)
    torch.cuda.synchronize()
    got = {**bwd_counts(), **sink_counts()}
    require(got["flash_bwd_fused"] == 1 and got["flash_fwd_sink"] == 1
            and got["fa_bwd_dkdv"] == 0 and got["flash_bwd_preprocess"] == 1
            and leaves[3].grad is not None,
            f"counted deterministic=False call with a sink: {got}")
    return got


def sink_packed_checks(errs):
    """The packed stack's layers 0 and 1: B7 gives B6's forward's bits over
    the packed rows and B1's over each document alone (b = 1); B6's
    backward gives B3's dq, dk, dv bits over each document and dsink within
    1e-5 of the documents' sum (relative to the largest head's); then a small ALiBi + sink case
    through B6's forward (as JAX routes ALiBi), B6 equal to B1 over the same
    rows and B1 against its plain version. Returns B6's counts."""
    from flash_attn_tpu_torch import flash_attn_varlen_func
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd, flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp
    from flash_attn_tpu_torch.utils.cases import SINK_FWD_CASES, score_slopes
    from flash_attn_tpu_torch.utils.cases import sink_logits

    b, s = GPT_OSS_BATCH, GPT_OSS_20B.initial_context_length
    docs = GPT_OSS_DOCS
    cu = torch.tensor(np.concatenate([[0], np.cumsum(docs)]),
                      dtype=torch.int32, device="cuda")
    mx = max(docs)
    for layer in (0, 1):
        window = gpt_oss_window(layer)
        q, k, v, do, sink = gpt_oss_layer(layer, b, s, packed=True)
        kw = dict(causal=True, window_size=window, learnable_sink=sink)
        b7 = fvp.flash_attention_varlen_fwd_persistent(q, k, v, cu, cu, mx,
                                                       mx, **kw)
        b6 = flash_varlen.flash_attention_varlen_fwd(q, k, v, cu, cu, mx, mx,
                                                     **kw)
        require(torch.equal(b7[0], b6[0]) and torch.equal(b7[1], b6[1]),
                f"B7 differs from B6's forward with a sink (layer {layer})")
        g6 = flash_varlen.flash_attention_varlen_bwd(
            do, q, k, v, b7[0], b7[1], cu, cu, mx, mx, **kw)
        dsink = torch.zeros_like(g6[3])
        for i, (a, n) in enumerate(zip(cu.tolist(), docs)):
            qt, kt, vt, dot = (x[None, a:a + n].transpose(1, 2)
                               for x in (q, k, v, do))
            o1, l1 = flash_fwd.flash_attention_fwd(qt, kt, vt, **kw)
            require(torch.equal(o1.transpose(1, 2)[0], b7[0][a:a + n])
                    and torch.equal(l1[0], b7[1][:, a:a + n]),
                    f"B7 differs from B1 over document {i} (layer {layer})")
            g3 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, o1, l1, **kw)
            for x, y in zip(g6[:3], g3[:3]):
                require(torch.equal(x[a:a + n], y.transpose(1, 2)[0]),
                        f"B6's backward differs from B3's over document {i}"
                        f" (layer {layer})")
            dsink += g3[3]
        # the same fp32 terms summed in another order: within 1e-5 of the
        # largest head's |dsink|
        gap = float((g6[3] - dsink).abs().max() / dsink.abs().max())
        require(gap <= 1e-5, f"B6's dsink against the documents' B3 sum: "
                             f"gap {gap:.3e} of the largest (layer {layer})")
        # against the plain fp32 versions over the packed rows
        f32 = [x.float() for x in (q, k, v)]
        ref_o, ref_l = flash_varlen.flash_attention_varlen_fwd_plain(
            *f32, cu, cu, mx, mx, **kw)
        e7 = float((b7[0].float() - ref_o).abs().max())
        lse_err = float((b7[1] - ref_l).abs().max())
        ref_g = flash_varlen.flash_attention_varlen_bwd_plain(
            do.float(), *f32, ref_o, ref_l, cu, cu, mx, mx, **kw)
        e6 = max(float((x.float() - r).abs().max())
                 for x, r in zip(g6, ref_g))
        require(e7 <= 2e-2 and lse_err <= LSE_ATOL
                and all(bool(torch.isfinite(x).all()) for x in g6),
                f"B7 with a sink against its plain version: out {e7:.3e}, "
                f"lse {lse_err:.3e} (layer {layer})")
        errs["flash_varlen_fwd_persistent_sink"] = max(
            errs.get("flash_varlen_fwd_persistent_sink", 0.0), e7)
        errs["flash_varlen_bwd_sink"] = max(
            errs.get("flash_varlen_bwd_sink", 0.0), e6)
        print(f"gpt-oss packed layer {layer} (window {window}, documents "
              f"{docs}): B7 bitwise B6's forward and B1's over each "
              f"document, out {e7:.3e} and lse {lse_err:.3e} from the plain "
              f"fp32 version; B6's backward bitwise B3's over each document "
              f"(B3 held by the 2x rule above), dq, dk, dv and dsink within "
              f"{e6:.3e} of the plain fp32 version's, dsink within "
              f"{gap:.2e} of the documents' sum (relative to the largest "
              f"head's)")
        del b6, b7, g6, f32, ref_o, ref_l, ref_g
    case = SINK_FWD_CASES[5]
    _, bb, sq, _, h, _, d, causal, _, _, kind, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(80)
    q, k, v = (torch.randn(bb, sq, h, d, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    sink = sink_logits(h, sq, "cuda", gen)
    slopes = score_slopes(kind, bb, h, "cuda")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    o1, l1 = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal,
                                           alibi_slopes=slopes,
                                           learnable_sink=sink)
    ref, ref_lse = flash_fwd.flash_attention_fwd_plain(
        qt.float(), kt.float(), vt.float(), causal=causal,
        alibi_slopes=slopes, learnable_sink=sink)
    e = float((o1.float() - ref).abs().max())
    lse_err = float((l1 - ref_lse).abs().max())
    require(e <= 2e-2 and lse_err <= LSE_ATOL,
            f"B1 ALiBi + sink against its plain version: {e}, {lse_err}")
    cu1 = torch.arange(bb + 1, dtype=torch.int32, device="cuda") * sq
    torch.cuda.synchronize()
    reset_kernel_counts()
    o6, l6 = flash_attn_varlen_func(
        q.reshape(bb * sq, h, d), k.reshape(bb * sq, h, d),
        v.reshape(bb * sq, h, d), cu1, cu1, sq, sq, causal=causal,
        alibi_slopes=slopes, learnable_sink=sink, return_attn_probs=True)[:2]
    torch.cuda.synchronize()
    got = {**kernel_counts(), **sink_counts()}
    require(got["flash_varlen_fwd_sink"] == 1
            and got["flash_varlen_fwd_score"] == 1
            and got["flash_varlen_fwd_persistent"] == 0,
            f"ALiBi + sink through B6's forward: {got}")
    require(torch.equal(o6, o1.transpose(1, 2).reshape(bb * sq, h, d))
            and torch.equal(l6, l1.transpose(0, 1).reshape(h, bb * sq)),
            "B6's forward under ALiBi with a sink differs from B1's")
    errs["flash_varlen_fwd_sink"] = e
    print(f"ALiBi + sink at {case[0]} through flash_attn_varlen_func: B6's "
          f"forward (1 launch) bitwise B1's over the same rows; B1 out "
          f"{e:.3e}, lse {lse_err:.3e} from its plain version")
    return got


def sink_paged_checks(errs):
    """The prefix-cached admission of gpt-oss (8 chunks of 256 over 512
    keys, pages of 256) through flash_attn_varlen_func(block_table=,
    learnable_sink=), sliding and full, then over an e4m3 page pool with
    descales, the counts at 0 before: each against its plain version (out
    within 2e-2, lse within LSE_ATOL), the full one bitwise equal to B6's
    forward over the same rows packed; then B8p with a sink at DeepSeek-V3's
    serving chunk (128 heads, 64 + 512, 8 chunks of 512 over 2,048 keys)
    against its plain version. Returns (B8's counts, B8p's counts)."""
    from flash_attn_tpu_torch import flash_attn_varlen_func
    from flash_attn_tpu_torch.dispatch.kvquant import quantize_kv
    from flash_attn_tpu_torch.kernels import flash_paged_prefill as fpp
    from flash_attn_tpu_torch.kernels import flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.utils.cases import SINK_VARLEN_CASES
    from flash_attn_tpu_torch.utils.cases import sink_logits
    from flash_attn_tpu_torch.utils.testing import paged_to_linear

    (name, lens_q, lens_k, _, h, h_k, d, page, dtype, causal), _, window = \
        SINK_VARLEN_CASES[3]
    gen = torch.Generator(device="cuda").manual_seed(256)
    b = len(lens_q)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                      dtype=torch.int32, device="cuda")
    q = torch.randn(int(cu[-1]), h, d, device="cuda", generator=gen).to(dtype)
    kp, vp, table = paged_cache(gen, b, h_k, d, page, max(lens_k), dtype)
    seqlens = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    sink = sink_logits(h, max(lens_k), "cuda", gen)
    qd, vd = (0.5 + torch.rand(b, h_k, device="cuda", generator=gen)
              for _ in range(2))
    kq, vq = (quantize_kv(x, torch.float8_e4m3fn) for x in (kp, vp))
    forms = [("sliding", kp, vp, dict(window_size=window)),
             ("full", kp, vp, {}),
             ("fp8 pool, descales", kq, vq,
              dict(q_descale=qd, k_descale=torch.ones_like(qd),
                   v_descale=vd))]
    torch.cuda.synchronize()
    reset_kernel_counts()
    outs = [flash_attn_varlen_func(
        q, kc, vc, cu, None, max(lens_q), max(lens_k), block_table=table,
        seqused_k=seqlens, causal=causal, learnable_sink=sink,
        return_attn_probs=True, **kw) for _, kc, vc, kw in forms]
    torch.cuda.synchronize()
    got8 = {**kernel_counts(), **sink_counts()}
    require(got8["flash_varlen_paged_sink"] == 3
            and got8["flash_varlen_paged"] == 3
            and got8["flash_varlen_paged_band"] == 1
            and got8["flash_varlen_paged_descale"] == 1
            and got8["kv_dequant"] == 1,
            f"gpt-oss prefix admission with a sink: {got8}")
    line = []
    for (form, kc, vc, kw), (out, lse) in zip(forms, outs):
        plain = dict(window_size=kw.get("window_size", (None, None)))
        if "q_descale" in kw:
            plain.update(qk_descale=kw["q_descale"], v_descale=kw["v_descale"])
        ref, ref_lse = fvp.flash_attention_varlen_paged_fwd_plain(
            q.float(), kc if kc.element_size() == 1 else kc.float(),
            vc if vc.element_size() == 1 else vc.float(), cu, max(lens_q),
            seqlens, table, causal=causal, learnable_sink=sink, **plain)
        e = float((out.float() - ref.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        require(e <= 2e-2 and lse_err <= LSE_ATOL,
                f"B8 with a sink ({form}) against its plain version: out "
                f"{e:.3e}, lse {lse_err:.3e}")
        errs["flash_varlen_paged_sink"] = max(
            errs.get("flash_varlen_paged_sink", 0.0), e)
        line.append(f"{form} out {e:.3e}, lse {lse_err:.3e}")
    k, v = (torch.cat([lin[s, :, :n].transpose(0, 1)
                       for s, n in enumerate(lens_k)])
            for lin in (paged_to_linear(x, table, seqlens) for x in (kp, vp)))
    cu_k = torch.tensor(np.concatenate([[0], np.cumsum(lens_k)]),
                        dtype=torch.int32, device="cuda")
    b6 = flash_varlen.flash_attention_varlen_fwd(
        q, k.contiguous(), v.contiguous(), cu, cu_k, max(lens_q),
        max(lens_k), causal=causal, learnable_sink=sink)
    require(torch.equal(outs[1][0], b6[0]) and torch.equal(outs[1][1], b6[1]),
            "B8 with a sink differs from B6's forward over the same rows")
    print(f"gpt-oss prefix admission ({name}: 8 chunks of 256 over 512 keys, "
          f"pages of 256) with a sink, against the plain version: "
          + "; ".join(line) + "; the full form bitwise B6's forward over the "
          "same rows packed")
    del outs, b6, k, v, kq, vq
    # B8p at DeepSeek-V3's serving chunk
    rows, nseq, cached = 512, 8, 1536
    keys = cached + rows
    kp, vp, table = paged_cache(gen, nseq, 1, 64, 64, keys, torch.bfloat16,
                                512)
    q, qv = (torch.randn(nseq * rows, 128, w, device="cuda", generator=gen)
             .to(torch.bfloat16) for w in (64, 512))
    cu = torch.arange(nseq + 1, dtype=torch.int32, device="cuda") * rows
    seqlens = torch.full((nseq,), keys, dtype=torch.int32, device="cuda")
    sink = sink_logits(128, keys, "cuda", gen)
    used = torch.full((nseq,), rows, dtype=torch.int32, device="cuda")
    used[-1] = rows - 100  # rows past seqused_q: out 0, lse = sink
    torch.cuda.synchronize()
    reset_kernel_counts()
    out, lse = fpp.flash_attention_paged_prefill_varlen(
        q, kp, vp, cu, rows, seqlens, table, seqused_q=used, qv=qv,
        softmax_scale=MLA_SCALE, causal=True, learnable_sink=sink)
    torch.cuda.synchronize()
    got8p = sink_counts()
    require(got8p["flash_paged_prefill_sink"] == 1,
            f"B8p with a sink: {got8p}")
    ref, ref_lse = fpp.flash_attention_paged_prefill_varlen_plain(
        q.float(), kp.float(), vp.float(), cu, rows, seqlens, table,
        seqused_q=used, qv=qv.float(), softmax_scale=MLA_SCALE, causal=True,
        learnable_sink=sink)
    e = float((out.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    require(e <= 2e-2 and lse_err <= LSE_ATOL,
            f"B8p with a sink against its plain version: {e}, {lse_err}")
    tail = slice(int(cu[-2]) + rows - 100, int(cu[-1]))
    require(torch.equal(lse[:, tail], sink[:, None].expand(128, 100))
            and not out[tail].any(), "B8p: rows past seqused_q with a sink")
    errs["flash_paged_prefill_sink"] = e
    print(f"B8p with a sink at DeepSeek-V3's serving chunk (8 x 512 over "
          f"2,048 keys, 128 heads, 64 + 512, pages of 64), the last chunk's "
          f"last 100 rows past seqused_q: out {e:.3e}, lse {lse_err:.3e} "
          f"from its plain version; those rows out 0 and lse = sink")
    return got8, got8p


def sink_no_key_rows():
    """A row that sees no key gives out 0 and lse equal to its head's sink
    in B1, B6's forward and B7 (causal sq > sk, SINK_FWD_CASES[2]) and B8
    (a sequence with no keys and rows past seqused_q, VARLEN_CASES[3]);
    B8p's is checked in sink_paged_checks."""
    from flash_attn_tpu_torch.dispatch.band import band_valid
    from flash_attn_tpu_torch.kernels import flash_fwd
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.utils.cases import (
        SINK_FWD_CASES,
        VARLEN_CASES,
        sink_logits,
    )

    _, b, sq, sk, h, h_k, d, causal, *_ = SINK_FWD_CASES[2]
    gen = torch.Generator(device="cuda").manual_seed(3)
    qt, kt, vt = (torch.randn(b, n, s, d, device="cuda", generator=gen)
                  .to(torch.bfloat16) for n, s in ((h, sq), (h_k, sk),
                                                   (h_k, sk)))
    sink = sink_logits(h, sk, "cuda", gen)
    rows = torch.arange(sq, device="cuda")[:, None]
    cols = torch.arange(sk, device="cuda")[None, :]
    empty = ~band_valid(rows, cols, sk - sq, causal, (None, None)).any(1)
    got = [flash_fwd.flash_attention_fwd(qt, kt, vt, causal=causal,
                                         learnable_sink=sink)]
    got += packed_forwards(qt, kt, vt, causal, learnable_sink=sink)
    n = int(empty.sum())
    for label, (out, lse) in zip(("B1", "B6's forward", "B7"), got):
        require(torch.equal(lse[:, :, empty],
                            sink[None, :, None].expand(b, h, n))
                and not out[:, :, empty].any(),
                f"{label}: rows with no key under a sink")
    name, lens_q, lens_k, used, h, h_k, d, page, dtype, causal = \
        VARLEN_CASES[3]
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                      dtype=torch.int32, device="cuda")
    q = torch.randn(int(cu[-1]), h, d, device="cuda", generator=gen).to(dtype)
    kp, vp, table = paged_cache(gen, len(lens_q), h_k, d, page, max(lens_k),
                                dtype)
    sink = sink_logits(h, max(lens_k), "cuda", gen)
    out, lse = fvp.flash_attention_varlen_paged_fwd(
        q, kp, vp, cu, max(lens_q), torch.tensor(lens_k, dtype=torch.int32,
                                                 device="cuda"),
        table, seqused_q=torch.tensor(used, dtype=torch.int32, device="cuda"),
        causal=causal, learnable_sink=sink)
    dead = torch.ones(int(cu[-1]), dtype=torch.bool, device="cuda")
    for a, u, lk in zip(cu.tolist(), used, lens_k):
        dead[a:a + (u if lk else 0)] = False
    require(torch.equal(lse[:, dead], sink[:, None].expand(h, int(dead.sum())))
            and not out[dead].any(), "B8: rows with no key under a sink")
    print(f"rows with no key under a sink: {n} a head and batch row in B1, "
          f"B6's forward and B7 ({SINK_FWD_CASES[2][0]}), "
          f"{int(dead.sum())} in B8 ({name}): out 0 and lse equal to the "
          f"head's sink")


def sink_timings():
    """Each sink form beside its sink-free form at the same shape (CUDA
    events around whole calls), its plain version (a few KV heads at a
    time), the library yardstick (scaled_dot_product_attention with the
    sink as one more key: a zero K and V row and the sink as a float-mask
    column) and the sink-free form's bound: B1, B3 (with the dsink epilogue
    timed alone beside the pair) and B2 at gpt-oss's training shape (the
    full layer; B1 also sliding), B6's forward, B7 and B6's backward at its
    packing, B8 at its prefix admission and B8p at DeepSeek-V3's serving
    chunk. Returns the timings by kernels-line row."""
    from flash_attn_tpu_torch.dispatch.sink import sink_arg, sink_grad
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd, flash_varlen
    from flash_attn_tpu_torch.kernels import flash_paged_prefill as fpp
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp7
    from flash_attn_tpu_torch.utils.cases import SINK_VARLEN_CASES
    from flash_attn_tpu_torch.utils.cases import sink_logits
    from flash_attn_tpu_torch.utils.testing import paged_to_linear

    b, s = GPT_OSS_BATCH, GPT_OSS_20B.initial_context_length
    t = {}
    q, k, v, do, sink = gpt_oss_layer(1, b, s)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    h, h_k, d = qt.shape[1], kt.shape[1], qt.shape[3]
    esz = qt.element_size()
    pairs = b * attended_pairs([s], [s], True)
    fwd_bound = bound(4 * h * d * pairs, esz * (2 * b * s * h * d
                                                + 2 * b * s * h_k * d)
                      + 4 * b * h * s)
    bwd_bound = bound(10 * h * d * pairs, esz * (4 * b * s * h * d
                                                 + 4 * b * s * h_k * d)
                      + 4 * b * h * s)
    mask = sink_key_mask(sink, band_mask(s, s, True), qt.dtype)
    lib_fwd, lib_bwd = sink_sdpa(qt, kt, vt, mask)
    lib = ("scaled_dot_product_attention with the sink as one more key (a "
           "zero K and V row, the sink a float-mask column), enable_gqa")
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=True,
                                             learnable_sink=sink)
    out_f, lse_f = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=True)
    band = dict(window_size=(None, None), learnable_sink=sink.float())
    plain_fwd, plain_bwd, parts = plain_band_chunks(qt, kt, vt, dot, out, lse,
                                                    True, band)
    plain = f"the plain fp32 version, {parts} calls of {h // parts} heads"
    sliding = time_ms(lambda: flash_fwd.flash_attention_fwd(
        qt, kt, vt, causal=True, window_size=gpt_oss_window(0),
        learnable_sink=sink))
    sliding_free = time_ms(lambda: flash_fwd.flash_attention_fwd(
        qt, kt, vt, causal=True, window_size=gpt_oss_window(0)))
    t["flash_fwd_sink"] = {
        "ms": time_ms(lambda: flash_fwd.flash_attention_fwd(
            qt, kt, vt, causal=True, learnable_sink=sink)),
        "sink_free_ms": time_ms(lambda: flash_fwd.flash_attention_fwd(
            qt, kt, vt, causal=True)),
        "sliding_ms": sliding, "sliding_sink_free_ms": sliding_free,
        "plain_ms": time_ms(plain_fwd, runs=3, batch=1), "plain_call": plain,
        "library_ms": time_ms(lib_fwd, runs=10), "library_call": lib,
        **fwd_bound}

    def bwd(det, sink_=sink, o=out, l=lse):
        return lambda: flash_bwd.flash_attention_bwd(
            dot, qt, kt, vt, o, l, causal=True, deterministic=det,
            learnable_sink=sink_)
    delta, _ = flash_bwd.bwd_preprocess(dot, out, lse)
    s32 = sink_arg("dsink", sink, h, qt.device)
    dsink_ms = time_ms(lambda: sink_grad(s32, lse, delta[..., :s], 1))
    lib_b = {"library_ms": time_ms(lib_bwd(dot), runs=10),
             "library_call": lib + ", backward (torch.autograd.grad)",
             "plain_ms": time_ms(plain_bwd, runs=3, batch=1),
             "plain_call": plain}
    t["flash_bwd_sink"] = {
        "ms": time_ms(bwd(True), runs=10),
        "sink_free_ms": time_ms(bwd(True, None, out_f, lse_f), runs=10),
        "dsink_ms": dsink_ms, **lib_b, **bwd_bound}
    t["flash_bwd_fused_sink"] = {
        "ms": time_ms(bwd(False), runs=10),
        "sink_free_ms": time_ms(bwd(False, None, out_f, lse_f), runs=10),
        "dsink_ms": dsink_ms, **lib_b, **bwd_bound}
    del out, lse, out_f, lse_f, delta, plain_fwd, plain_bwd, mask
    torch.cuda.empty_cache()

    # the packed stack's layer 1 (full) over GPT_OSS_DOCS
    docs = GPT_OSS_DOCS
    q, k, v, do, sink = gpt_oss_layer(1, b, s, packed=True)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(docs)]),
                      dtype=torch.int32, device="cuda")
    mx = max(docs)
    args = (q, k, v, cu, cu, mx, mx)
    ppairs = attended_pairs(docs, docs, True)
    pfwd = bound(4 * h * d * ppairs, esz * (2 * b * s * h * d
                                           + 2 * b * s * h_k * d)
                 + 4 * h * b * s)
    pbwd = bound(10 * h * d * ppairs, esz * (4 * b * s * h * d
                                            + 4 * b * s * h_k * d)
                 + 4 * h * b * s)
    seg = torch.repeat_interleave(torch.arange(len(docs), device="cuda"),
                                  torch.tensor(docs, device="cuda"))
    block = (seg[:, None] == seg[None, :]) & band_mask(b * s, b * s, True)
    mask = sink_key_mask(sink, block, q.dtype)
    del block, seg
    pl = lambda x: x.transpose(0, 1)[None]  # noqa: E731
    lib_fwd, lib_bwd = sink_sdpa(pl(q), pl(k), pl(v), mask)
    lib_p = ("scaled_dot_product_attention over the packed rows with the "
             "documents' causal blocks and the sink column as a float mask "
             "(a zero K and V row), enable_gqa")
    out, lse = fvp7.flash_attention_varlen_fwd_persistent(
        *args, causal=True, learnable_sink=sink)

    def plain_packed_fwd():
        flash_varlen.flash_attention_varlen_fwd_plain(
            *args, causal=True, learnable_sink=sink)

    def plain_packed_bwd():
        flash_varlen.flash_attention_varlen_bwd_plain(
            do, q, k, v, out, lse, cu, cu, mx, mx, causal=True,
            learnable_sink=sink)
    pf_ms = wall_ms(plain_packed_fwd)
    plain_p = ("the plain fp32 version, a document at a time (on the host's "
               "clock: it reads the lengths back)")
    lib_pf = {"library_ms": time_ms(lib_fwd, runs=10), "library_call": lib_p,
              "plain_ms": pf_ms, "plain_call": plain_p}
    t["flash_varlen_fwd_sink"] = {
        "ms": time_ms(lambda: flash_varlen.flash_attention_varlen_fwd(
            *args, causal=True, learnable_sink=sink)),
        "sink_free_ms": time_ms(lambda: flash_varlen.flash_attention_varlen_fwd(
            *args, causal=True)), **lib_pf, **pfwd}
    t["flash_varlen_fwd_persistent_sink"] = {
        "ms": time_ms(lambda: fvp7.flash_attention_varlen_fwd_persistent(
            *args, causal=True, learnable_sink=sink)),
        "sink_free_ms": time_ms(
            lambda: fvp7.flash_attention_varlen_fwd_persistent(
                *args, causal=True)), **lib_pf, **pfwd}
    out_f, lse_f = fvp7.flash_attention_varlen_fwd_persistent(*args,
                                                              causal=True)
    meta = flash_varlen.varlen_meta(q, k, cu, cu, mx, mx, None, None, True,
                                    None)
    delta, _ = flash_varlen.varlen_bwd_preprocess(
        do, out, lse, cu, cu, meta, *(torch.empty_like(x) for x in (q, k, v)))
    s32 = sink_arg("dsink", sink, h, q.device)
    t["flash_varlen_bwd_sink"] = {
        "ms": time_ms(lambda: flash_varlen.flash_attention_varlen_bwd(
            do, q, k, v, out, lse, cu, cu, mx, mx, causal=True, meta=meta,
            learnable_sink=sink), runs=10),
        "sink_free_ms": time_ms(lambda: flash_varlen.flash_attention_varlen_bwd(
            do, q, k, v, out_f, lse_f, cu, cu, mx, mx, causal=True,
            meta=meta), runs=10),
        "dsink_ms": time_ms(lambda: flash_varlen.varlen_sink_grad(
            s32, lse, delta, cu, meta.lens_q)),
        "library_ms": time_ms(lib_bwd(pl(do)), runs=10),
        "library_call": lib_p + ", backward (torch.autograd.grad)",
        "plain_ms": wall_ms(plain_packed_bwd), "plain_call": plain_p,
        **pbwd}
    del out, lse, out_f, lse_f, delta, mask, lib_fwd, lib_bwd
    torch.cuda.empty_cache()

    # B8 at gpt-oss's prefix admission (sliding), B8p at the serving chunk
    (_, lens_q, lens_k, _, h, h_k, d, page, dtype, causal), _, window = \
        SINK_VARLEN_CASES[3]
    gen = torch.Generator(device="cuda").manual_seed(257)
    nb = len(lens_q)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                      dtype=torch.int32, device="cuda")
    q = torch.randn(int(cu[-1]), h, d, device="cuda", generator=gen).to(dtype)
    kp, vp, table = paged_cache(gen, nb, h_k, d, page, max(lens_k), dtype)
    seqlens = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
    sink = sink_logits(h, max(lens_k), "cuda", gen)
    pargs = (q, kp, vp, cu, max(lens_q), seqlens, table)
    kw = dict(causal=causal, window_size=window)
    lq, lk = lens_q[0], lens_k[0]
    vmask = band_mask(lq, lk, causal, window)
    k_lin, v_lin = (paged_to_linear(x, table, seqlens)
                    for x in (kp, vp))  # (b, h_k, keys, d)
    lib8, _ = sink_sdpa(q.reshape(nb, lq, h, d).transpose(1, 2), k_lin,
                        v_lin, sink_key_mask(sink, vmask, dtype))
    vpairs = nb * int(vmask.sum())
    keys8 = nb * int(vmask.any(0).sum())
    t["flash_varlen_paged_sink"] = {
        "ms": time_ms(lambda: fvp.flash_attention_varlen_paged_fwd(
            *pargs, learnable_sink=sink, **kw)),
        "sink_free_ms": time_ms(lambda: fvp.flash_attention_varlen_paged_fwd(
            *pargs, **kw)),
        "plain_ms": wall_ms(lambda: fvp.flash_attention_varlen_paged_fwd_plain(
            q.float(), kp.float(), vp.float(), *pargs[3:], learnable_sink=sink,
            **kw)),
        "plain_call": "the plain fp32 version (on the host's clock)",
        "library_ms": time_ms(lib8, runs=10),
        "library_call": "scaled_dot_product_attention over the pre-gathered "
                        "cache with the sink as one more key, enable_gqa",
        **bound(4 * h * d * vpairs, esz * (2 * int(cu[-1]) * h * d
                                           + 2 * keys8 * h_k * d)
                + 4 * h * int(cu[-1]))}
    del k_lin, v_lin, lib8
    rows, nseq, cached = 512, 8, 1536
    keys = cached + rows
    kp, vp, table = paged_cache(gen, nseq, 1, 64, 64, keys, torch.bfloat16,
                                512)
    q, qv = (torch.randn(nseq * rows, 128, w, device="cuda", generator=gen)
             .to(torch.bfloat16) for w in (64, 512))
    cu = torch.arange(nseq + 1, dtype=torch.int32, device="cuda") * rows
    seqlens = torch.full((nseq,), keys, dtype=torch.int32, device="cuda")
    sink = sink_logits(128, keys, "cuda", gen)
    mla_args = (q, kp, vp, cu, rows, seqlens, table)
    mla_kw = dict(qv=qv, softmax_scale=MLA_SCALE, causal=True)
    mpairs = nseq * attended_pairs([rows], [keys], True)
    flops, nbytes = mla_flops_bytes(mpairs, nseq * rows, nseq * keys, 128, 1,
                                    64, 512, True, 2,
                                    2 * nseq * rows * 128 * 512, table.numel())
    k_lin, v_lin = (paged_to_linear(x, table, seqlens)
                    for x in (kp, vp))  # (b, 1, keys, w)
    qq = torch.cat([q, qv], -1).reshape(nseq, rows, 128, 576).transpose(1, 2)
    kk = torch.cat([k_lin, v_lin], -1)
    lib8p, _ = sink_sdpa(qq, kk, v_lin,
                         sink_key_mask(sink, band_mask(rows, keys, True),
                                       torch.bfloat16), scale=MLA_SCALE)
    t["flash_paged_prefill_sink"] = {
        "ms": time_ms(lambda: fpp.flash_attention_paged_prefill_varlen(
            *mla_args, learnable_sink=sink, **mla_kw)),
        "sink_free_ms": time_ms(lambda: fpp.flash_attention_paged_prefill_varlen(
            *mla_args, **mla_kw)),
        "plain_ms": wall_ms(
            lambda: fpp.flash_attention_paged_prefill_varlen_plain(
                q.float(), kp.float(), vp.float(), cu, rows, seqlens, table,
                qv=qv.float(), softmax_scale=MLA_SCALE, causal=True,
                learnable_sink=sink)),
        "plain_call": "the plain fp32 version (on the host's clock)",
        "library_ms": time_ms(lib8p, runs=10),
        "library_call": "scaled_dot_product_attention of q || qv against "
                        "k || v over the pre-gathered cache with the sink "
                        "as one more key",
        **bound(flops, nbytes)}
    for row, r in t.items():
        print(f"{row}: {r['ms']:.4f} ms with the sink, "
              f"{r['sink_free_ms']:.4f} ms without ("
              f"{r['ms'] / r['sink_free_ms']:.3f}x)"
              + (f", the dsink epilogue alone {r['dsink_ms']:.4f} ms"
                 if "dsink_ms" in r else "")
              + (f", sliding layer {r['sliding_ms']:.4f} / "
                 f"{r['sliding_sink_free_ms']:.4f} ms"
                 if "sliding_ms" in r else "")
              + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.4f} ms")
    return t


def run_gpt_oss_sinks(card):
    """gpt-oss-20b's attention stack on the card with its learnable sinks:
    the 24 layers at 2 x 4,096 through flash_attn_func and packed through
    flash_attn_varlen_func, forward and backward with the sinks trained
    (gpt_oss_stack, counted), the kernels against their plain versions and
    the bitwise identities under a sink (sink_dense_checks,
    sink_packed_checks, sink_paged_checks, sink_no_key_rows), and each sink
    form timed beside its sink-free form (sink_timings). Returns the
    launches of the counted runs, the errors and the timings by
    kernels-line row."""
    errs = {}
    launches = {"dense": gpt_oss_stack(False)}
    torch.cuda.empty_cache()
    launches["packed"] = gpt_oss_stack(True)
    torch.cuda.empty_cache()
    launches["fused"] = sink_dense_checks(errs)
    torch.cuda.empty_cache()
    launches["alibi"] = sink_packed_checks(errs)
    torch.cuda.empty_cache()
    launches["paged"], launches["mla"] = sink_paged_checks(errs)
    torch.cuda.empty_cache()
    sink_no_key_rows()
    torch.cuda.empty_cache()
    timings = sink_timings()
    print(f"gpt-oss-20b's attention with learnable sinks on {card}: every "
          f"check held")
    return launches, errs, timings


def dv_counts():
    """The launches at a v head dim of its own (192 / 128) since the last
    reset_kernel_counts()."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd

    return {"flash_fwd_dv": flash_fwd.launches_dv,
            "flash_bwd_preprocess_dv": flash_bwd.launches_preprocess_dv,
            "fa_bwd_dkdv_dv": flash_bwd.launches_dkdv_dv,
            "fa_bwd_dq_dv": flash_bwd.launches_dq_dv,
            "flash_bwd_fused_dv": flash_bwd.launches_fused_dv}


def all_counts():
    """Every launch counter this script reads, by its name."""
    return {**kernel_counts(), **bwd_counts(), **sink_counts(),
            **dv_counts()}


def dv_inputs(seed: int, b: int, sq: int, sk: int, h: int, h_k: int,
              dtype=torch.bfloat16):
    """Seeded q (b, sq, h, 192), k (b, sk, h_k, 192), v (b, sk, h_k, 128)
    and dout (b, sq, h, 128)."""
    from flash_attn_tpu_torch.utils.cases import DSV3_D, DSV3_DV

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, s, n, w, device="cuda", generator=gen).to(dtype)
            for s, n, w in ((sq, h, DSV3_D), (sk, h_k, DSV3_D),
                            (sk, h_k, DSV3_DV), (sq, h, DSV3_DV))]


def dsv3_layer(layer: int):
    """dv_inputs of one layer of DeepSeek-V3's attention at its training
    shape: 1 x 4,096 rows of 128 heads."""
    from flash_attn_tpu_torch.utils.cases import DSV3_HEADS, DSV3_SEQ

    return dv_inputs(2500 + layer, 1, DSV3_SEQ, DSV3_SEQ, DSV3_HEADS,
                     DSV3_HEADS)


def dsv3_stack():
    """All 61 layers of DeepSeek-V3's attention trained without absorbing
    its MLA (128 heads, q/k 192 = 128 + 64 rope, v 128, causal, 1 x 4,096,
    its softmax scale) through flash_attn_func forward and backward
    (deterministic, as its trainer runs), a layer at a time, the counts at
    0 before: every output and gradient finite, and exactly one B1, one
    preprocess, one dK/dV and one dQ launch a layer, each the 192 / 128
    form. Returns the launches and the peak memory (GB)."""
    from flash_attn_tpu_torch import flash_attn_func
    from flash_attn_tpu_torch.utils.cases import DSV3_LAYERS, DSV3_SCALE

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    bad = []
    for i in range(DSV3_LAYERS):
        q, k, v, do = dsv3_layer(i)
        leaves = [x.requires_grad_() for x in (q, k, v)]
        out = flash_attn_func(*leaves, causal=True, softmax_scale=DSV3_SCALE)
        out.backward(do)
        if not all(bool(torch.isfinite(x).all())
                   for x in (out, *(l.grad for l in leaves))):
            bad.append(i)
        del q, k, v, do, leaves, out
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = all_counts()
    n = DSV3_LAYERS
    want = {"flash_fwd": n, "flash_fwd_dv": n, "flash_bwd_preprocess": n,
            "flash_bwd_preprocess_dv": n, "fa_bwd_dkdv": n,
            "fa_bwd_dkdv_dv": n, "fa_bwd_dq": n, "fa_bwd_dq_dv": n}
    odd = {key: val for key, val in got.items() if val != want.get(key, 0)}
    require(not bad, f"DeepSeek-V3 stack: non-finite outputs or gradients at "
                     f"layers {bad}")
    require(not odd, f"DeepSeek-V3 stack: launches {odd}, want {want}")
    print(f"DeepSeek-V3 attention stack ({n} layers, 128 heads, q/k 192, v "
          f"128, causal, 1 x 4096, scale {DSV3_SCALE:.6f}): forward and "
          f"backward finite, launches {want}, peak {peak:.2f} GB")
    return got, peak


def finite_close(got, want, what: str, atol: float):
    """lse-like tensors: -inf at the same places, the rest within atol.
    Returns the largest difference."""
    fin = torch.isfinite(want)
    require(torch.equal(torch.isfinite(got), fin), f"{what}: -inf rows differ")
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    require(err <= atol, f"{what}: max abs err {err:.3e} > {atol}")
    return err


def dv_case(case):
    """B1, B3, B2 and the preprocess at 192 / 128 on one DV_CASES case
    against the plain fp32 versions by the 2x rule (sink_refs: a batch row
    and a few heads at a time; lse within LSE_ATOL, dsink with its floor),
    every launch counted as the 192 / 128 form, B3 the same bits twice,
    the preprocess's delta and lse2 against its plain version and its
    clearing of the fused pass's 192-column fp32 dQ rows. Returns the
    errors by kernels-line row (without the _d192 suffix)."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.cases import dv_case_scale, sink_logits
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    name, b, sq, sk, h, h_k, causal, dtype, with_sink = case
    scale = dv_case_scale(name)
    q, k, v, do = dv_inputs(3000 + sq + sk + h, b, sq, sk, h, h_k, dtype)
    gen = torch.Generator(device="cuda").manual_seed(sq + sk)
    sink = sink_logits(h, sk, "cuda", gen) if with_sink else None
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    kw = dict(softmax_scale=scale, causal=causal, learnable_sink=sink)
    torch.cuda.synchronize()
    reset_kernel_counts()
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, **kw)
    b3 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse, **kw)
    again = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse, **kw)
    b2 = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse,
                                       deterministic=False, **kw)
    torch.cuda.synchronize()
    got = all_counts()
    want = {"flash_fwd": 1, "flash_fwd_dv": 1, "flash_bwd_preprocess": 3,
            "flash_bwd_preprocess_dv": 3, "fa_bwd_dkdv": 2,
            "fa_bwd_dkdv_dv": 2, "fa_bwd_dq": 2, "fa_bwd_dq_dv": 2,
            "flash_bwd_fused": 1, "flash_bwd_fused_dv": 1,
            "flash_fwd_sink": int(with_sink)}
    odd = {key: val for key, val in got.items() if val != want.get(key, 0)}
    require(not odd, f"launches at 192 / 128 ({name}): {odd}, want {want}")
    require(all(torch.equal(x, y) for x, y in zip(b3, again)),
            f"B3 at 192 / 128 differs between runs ({name})")
    del again
    ref, ref_lp = sink_refs(qt, kt, vt, dot,
                            None if sink is None else sink.float(), causal,
                            (None, None), scale=scale)
    errs, line = {}, []
    e, _ = check_against_ref(out.transpose(1, 2), ref[0].transpose(1, 2),
                             ref_lp[0], msg=f"B1 192/128 {name}")
    lse_err = finite_close(lse, ref[1], f"B1 192/128 lse ({name})", LSE_ATOL)
    errs["flash_fwd"] = e
    line.append(f"B1 out {e:.3e}, lse {lse_err:.3e}")
    for row, g in (("flash_bwd", b3), ("flash_bwd_fused", b2)):
        for gname, x, r, lp in zip(("dq", "dk", "dv"), g, ref[2:5],
                                   ref_lp[1:4]):
            e, e_lp = check_against_ref(
                x.transpose(1, 2), r.transpose(1, 2), lp, atol=BWD_ATOL,
                msg=f"{row} {gname} 192/128 {name}")
            errs[row] = max(errs.get(row, 0.0), e)
            line.append(f"{'B3' if row == 'flash_bwd' else 'B2'} {gname} "
                        f"{e:.3e} (low precision {e_lp:.3e})")
        if sink is not None:
            e, e_lp = check_against_ref(g[3], ref[5], ref_lp[4],
                                        atol=DSINK_ATOL,
                                        msg=f"{row} dsink 192/128 {name}")
            errs[row] = max(errs[row], e)
            line.append(f"{row} dsink {e:.3e}")
    del ref, ref_lp, b2, b3
    dq_accum = torch.full((b, sq, h, q.shape[-1]), float("nan"),
                          device="cuda")
    delta, lse2 = flash_bwd.bwd_preprocess(dot, out, lse, dq_accum,
                                           q.shape[-1])
    want_delta, want_lse2 = flash_bwd.bwd_preprocess_plain(
        dot, out, lse, delta.shape[-1])
    require(bool((dq_accum == 0).all()),
            f"the preprocess at 192 / 128 left fp32 dQ columns uncleared "
            f"({name})")
    finite_close(lse2, want_lse2, f"preprocess lse2 192/128 ({name})", 1e-5)
    pre_err = float((delta - want_delta).abs().max())
    require(pre_err <= 1e-3, f"preprocess delta err {pre_err} at 192 / 128 "
                             f"({name})")
    errs["flash_bwd_preprocess"] = pre_err
    print(f"192 / 128, {name}: b={b} sq={sq} sk={sk} {h}/{h_k} heads, "
          f"{str(dtype)[6:]}, causal={causal}, scale "
          f"{scale if scale is not None else 'default'}"
          f"{', a learnable sink' if with_sink else ''}: " + ", ".join(line)
          + f"; B3 bitwise equal twice; preprocess delta {pre_err:.3e}, "
          f"lse2 within 1e-5, the fused pass's 192 columns cleared")
    return errs


def dv_api_checks(errs):
    """flash_attn_func at DeepSeek-V3's layer shape with
    deterministic=False, counted (the only B2 run on a model's path shape:
    no model path selects it), its gradients by the 2x rule; then
    ``qv`` at (64, 128) against the explicit concatenated call, forward and
    every gradient bitwise, counted. Returns the two runs' launches."""
    from flash_attn_tpu_torch import flash_attn_func
    from flash_attn_tpu_torch.utils.cases import DSV3_SCALE
    from flash_attn_tpu_torch.utils.testing import check_against_ref

    q, k, v, do = dsv3_layer(1)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    torch.cuda.synchronize()
    reset_kernel_counts()
    flash_attn_func(*leaves, causal=True, softmax_scale=DSV3_SCALE,
                    deterministic=False).backward(do)
    torch.cuda.synchronize()
    fused = all_counts()
    want = {"flash_fwd": 1, "flash_fwd_dv": 1, "flash_bwd_preprocess": 1,
            "flash_bwd_preprocess_dv": 1, "flash_bwd_fused": 1,
            "flash_bwd_fused_dv": 1}
    odd = {key: val for key, val in fused.items() if val != want.get(key, 0)}
    require(not odd, f"counted deterministic=False call at 192 / 128: {odd}")
    qt, kt, vt, dot = (x.detach().transpose(1, 2) for x in (q, k, v, do))
    ref, ref_lp = sink_refs(qt, kt, vt, dot, None, True, (None, None),
                            scale=DSV3_SCALE)
    line = []
    for gname, x, r, lp in zip(("dq", "dk", "dv"), leaves, ref[2:5],
                               ref_lp[1:4]):
        e, e_lp = check_against_ref(x.grad, r.transpose(1, 2), lp,
                                    atol=BWD_ATOL,
                                    msg=f"flash_attn_func B2 {gname}")
        errs["flash_bwd_fused"] = max(errs.get("flash_bwd_fused", 0.0), e)
        line.append(f"{gname} {e:.3e} (low precision {e_lp:.3e})")
    del ref, ref_lp, leaves, q, k, v, do, qt, kt, vt, dot
    torch.cuda.empty_cache()
    print("flash_attn_func(deterministic=False).backward() at DeepSeek-V3's "
          "layer shape, counted (1 B1, 1 preprocess, 1 fused dK/dV at 192 / "
          "128): " + ", ".join(line) + " by the 2x rule")

    # qv at (64, 128): JAX's concatenation identity
    gen = torch.Generator(device="cuda").manual_seed(2564)
    b, s, h = 2, 1024, 16
    q, k = (torch.randn(b, s, h, 64, device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    v, qv, do = (torch.randn(b, s, h, 128, device="cuda", generator=gen)
                 .to(torch.bfloat16) for _ in range(3))
    leaves = [x.requires_grad_() for x in (q, k, v, qv)]
    torch.cuda.synchronize()
    reset_kernel_counts()
    out = flash_attn_func(*leaves[:3], qv=leaves[3], causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    qv_counts = all_counts()
    qc = torch.cat([q, qv], -1).detach().requires_grad_()
    kc = torch.cat([k, v], -1).detach().requires_grad_()
    vc = v.detach().requires_grad_()
    out2 = flash_attn_func(qc, kc, vc, causal=True)
    out2.backward(do)
    pairs = [("out", out, out2), ("dq", q.grad, qc.grad[..., :64]),
             ("dqv", qv.grad, qc.grad[..., 64:]),
             ("dk", k.grad, kc.grad[..., :64]),
             ("dv", v.grad, vc.grad + kc.grad[..., 64:])]
    differ = [n for n, x, y in pairs if not torch.equal(x, y)]
    require(not differ, f"flash_attn_func(qv=) differs from the explicit "
                        f"concatenated call: {differ}")
    want = {"flash_fwd": 1, "flash_fwd_dv": 1, "flash_bwd_preprocess": 1,
            "flash_bwd_preprocess_dv": 1, "fa_bwd_dkdv": 1,
            "fa_bwd_dkdv_dv": 1, "fa_bwd_dq": 1, "fa_bwd_dq_dv": 1}
    odd = {key: val for key, val in qv_counts.items()
           if val != want.get(key, 0)}
    require(not odd, f"flash_attn_func(qv=) launches: {odd}")
    print(f"flash_attn_func(q, k, v, qv=qv) at (64, 128), b={b} x {s}, {h} "
          f"heads, causal: out, dq, dqv, dk and dv bitwise equal to the "
          f"explicit call on q || qv, k || v (dv the P V side plus the score "
          f"side); launches {want}")
    return {"fused": fused, "qv": qv_counts}


def sdpa_row(qt, kt, vt, dot, scale, causal=True):
    """scaled_dot_product_attention's forward and backward (ms) at these
    shapes, through the first of its backends that takes q/k head dim 192
    beside v head dim 128, and that backend's name."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
                o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                   scale=scale)
                torch.autograd.grad(o, leaves, dot, retain_graph=True)
                torch.cuda.synchronize()
        except Exception:  # noqa: BLE001 (a backend refuses these shapes)
            continue
        with sdpa_kernel(backend):
            fwd = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale), runs=10)
            bwd = time_ms(lambda: torch.autograd.grad(
                o, leaves, dot, retain_graph=True), runs=10)
        return fwd, bwd, backend.name
    raise RuntimeError("sdpa_row: no backend of scaled_dot_product_attention "
                       "ran")


def dv_timings():
    """At DeepSeek-V3's layer shape (1 x 4,096, 128 heads, causal, its
    scale): B1, the B3 pair (whole call, and its three kernels by CUDA
    events around each launch: entry_split_ms), B2 and the preprocess at
    192 / 128, each beside the same kernels at d = dv = 128 over the same
    rows (what the wider Q and K cost), the plain fp32 versions (a few
    heads at a time), scaled_dot_product_attention (the backend it took)
    and a bound in operations: 2 h pairs (d + dv) flops forward, 2 h pairs
    (3 d + 2 dv) backward, over the attended pairs. Returns the timings by
    kernels-line row."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.cases import DSV3_SCALE

    q, k, v, do = dsv3_layer(0)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    b, h, s, d = qt.shape
    dv = vt.shape[-1]
    kw = dict(causal=True, softmax_scale=DSV3_SCALE)
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, **kw)
    pairs = b * h * attended_pairs([s], [s], True)
    esz = qt.element_size()
    rows = b * h * s
    fwd_bound = bound(2 * pairs * (d + dv),
                      esz * rows * (2 * d + 2 * dv) + 4 * rows)
    bwd_bound = bound(2 * pairs * (3 * d + 2 * dv),
                      esz * rows * (4 * d + 4 * dv) + 4 * rows)
    sq_pad = -(-s // 128) * 128
    pre_bound = bound(2 * rows * dv, esz * 2 * rows * dv + 4 * rows
                      + 2 * 4 * b * h * sq_pad, PEAK_FP32)

    def bwd(det, tensors=(qt, kt, vt, dot, out, lse)):
        qq, kk, vv, dd, oo, ll = tensors
        return lambda: flash_bwd.flash_attention_bwd(
            dd, qq, kk, vv, oo, ll, deterministic=det, **kw)
    t_fwd = time_ms(lambda: flash_fwd.flash_attention_fwd(qt, kt, vt, **kw),
                    runs=10)
    t_b3 = time_ms(bwd(True), runs=10)
    t_b2 = time_ms(bwd(False), runs=10)
    t_pre = time_ms(lambda: flash_bwd.bwd_preprocess(dot, out, lse, None, d),
                    runs=10)
    split = entry_split_ms(bwd(True), ["preprocess_kernel", "dkdv_kernel",
                                       "dq_kernel"])
    split_b2 = entry_split_ms(bwd(False), ["preprocess_kernel",
                                           "dkdv_kernel"])
    plain_fwd, plain_bwd, parts = plain_band_chunks(
        qt, kt, vt, dot, out, lse, True, {"softmax_scale": DSV3_SCALE})
    plain = f"the plain fp32 version, {parts} calls of {h // parts} heads"
    p_fwd = time_ms(plain_fwd, runs=3, batch=1)
    p_bwd = time_ms(plain_bwd, runs=3, batch=1)
    p_pre = time_ms(lambda: flash_bwd.bwd_preprocess_plain(dot, out, lse, 128),
                    runs=10)
    lib_fwd, lib_bwd, backend = sdpa_row(qt, kt, vt, dot, DSV3_SCALE)
    lib = f"scaled_dot_product_attention(is_causal=True, scale=) ({backend})"
    # the same rows at d = dv = 128: q and k cut to their first 128 columns
    q128, k128 = (x[..., :128].contiguous() for x in (q, k))
    t128 = (q128.transpose(1, 2), k128.transpose(1, 2), vt, dot)
    out128, lse128 = flash_fwd.flash_attention_fwd(*t128[:3], **kw)
    d128 = {"fwd": time_ms(lambda: flash_fwd.flash_attention_fwd(
        *t128[:3], **kw), runs=10),
        "b3": time_ms(bwd(True, (*t128, out128, lse128)), runs=10),
        "b2": time_ms(bwd(False, (*t128, out128, lse128)), runs=10)}
    pre_lib = time_ms(lambda: torch.linalg.vecdot(dot, out), runs=10)
    t = {"flash_fwd": {"ms": t_fwd, "d128_ms": d128["fwd"], "plain_ms": p_fwd,
                       "plain_call": plain, "library_ms": lib_fwd,
                       "library_call": lib, **fwd_bound},
         "flash_bwd": {"ms": t_b3, "d128_ms": d128["b3"],
                       "entry_split_ms": split, "plain_ms": p_bwd,
                       "plain_call": plain, "library_ms": lib_bwd,
                       "library_call": lib + ", backward "
                                             "(torch.autograd.grad)",
                       **bwd_bound},
         "flash_bwd_fused": {"ms": t_b2, "d128_ms": d128["b2"],
                             "entry_split_ms": split_b2, "plain_ms": p_bwd,
                             "plain_call": plain, "library_ms": lib_bwd,
                             "library_call": lib + ", backward "
                                                   "(torch.autograd.grad)",
                             **bwd_bound},
         "flash_bwd_preprocess": {"ms": t_pre, "plain_ms": p_pre,
                                  "library_ms": pre_lib,
                                  "library_call": "torch.linalg.vecdot(dO, O)"
                                                  " (in bf16)", **pre_bound}}
    for row, r in t.items():
        r["to_bound"] = r["bound_ms"] / r["ms"]
        print(f"{row} at 192 / 128, DeepSeek-V3's layer (1 x {s}, {h} heads, "
              f"causal): {r['ms']:.4f} ms, {100 * r['to_bound']:.1f}% of the "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f", {r['d128_ms']:.4f} ms at d = dv = 128 over the same rows"
                 if "d128_ms" in r else "")
              + (", its kernels by CUDA events " + ", ".join(
                  f"{n} {x:.4f}" for n, x in r["entry_split_ms"].items())
                 if "entry_split_ms" in r else "")
              + f"; plain {r['plain_ms']:.3f} ms; library "
              f"{r['library_ms']:.4f} ms ({r['library_call']}, "
              f"{r['ms'] / r['library_ms']:.2f}x)")
    return t


def check_dv_kernels(lib):
    """B1, B3, B2 and the preprocess at q/k head dim 192 beside v head dim
    128 (csrc/flash_fwd_192.cu, csrc/flash_bwd_192.cu) on every DV_CASES
    case (dv_case), and their registers, stack and spilled bytes a thread
    (cuobjdump -res-usage). Returns the errors by kernels-line row and the
    resources."""
    from flash_attn_tpu_torch.utils.cases import DV_CASES

    errs = {}
    for case in DV_CASES:
        for row, e in dv_case(case).items():
            errs[row] = max(errs.get(row, 0.0), e)
        torch.cuda.empty_cache()
    res = {}
    for ty in ("13__nv_bfloat16", "6__half"):
        res.update({f"{label} {ty.lstrip('0123456789')}": u for label, u in
                    kernel_resources(lib, {
                        "B1": ("dense_fwd10fwd_kernel", ty,
                               "Li192ELb0ELb0ELi128E"),
                        "preprocess": ("dense_bwd17preprocess_kernel", ty,
                                       "Li192ELi128E"),
                        "dkdv": ("dense_bwd11dkdv_kernel", ty,
                                 "Li192ELb0ELb0ELb0ELi128E"),
                        "dkdv fused": ("dense_bwd11dkdv_kernel", ty,
                                       "Li192ELb1ELb0ELb0ELi128E"),
                        "dq": ("dense_bwd9dq_kernel", ty,
                               "Li192ELb0ELb0ELi128E")}).items()})
    print("192 / 128 kernels' registers / stack / local bytes a thread "
          "(cuobjdump -res-usage): " + "; ".join(
              f"{label} " + ", ".join(
                  f"{u.get('REG')}/{u.get('STACK')}/{u.get('LOCAL')}"
                  for u in us) for label, us in res.items()))
    return errs, res


def run_deepseek_v3_attention(card, lib):
    """DeepSeek-V3's attention trained without absorbing its MLA on the
    card: the 61-layer stack through flash_attn_func (dsv3_stack, counted),
    the kernels at 192 / 128 against their plain versions on DV_CASES
    (check_dv_kernels), the counted deterministic=False call and qv on
    flash_attn_func (dv_api_checks), and the timings at its layer shape
    (dv_timings). Returns the launches of the counted runs, the errors,
    the timings by kernels-line row and the kernels' resources."""
    launches, peak = dsv3_stack()
    torch.cuda.empty_cache()
    errs, res = check_dv_kernels(lib)
    launches = {"stack": launches, **dv_api_checks(errs)}
    torch.cuda.empty_cache()
    timings = dv_timings()
    timings["flash_fwd"]["stack_peak_gb"] = peak
    print(f"DeepSeek-V3's non-absorbed attention at 192 / 128 on {card}: "
          f"every check held")
    return launches, errs, timings, res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--spec-readings", type=int, default=0, metavar="N",
        help="build the kernels, then only read the speculative engine's "
             "per-proposal mismatch rate with the target as its own draft "
             "over N seeded prompt sets")
    args = parser.parse_args()
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

    if args.spec_readings:
        return spec_readings(card, args.spec_readings)
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
    vdec_err, vdec_t = phase("verify-step decode kernel checks",
                             check_decode_verify, gen)
    vp_err, vp_t = phase("varlen-paged kernel checks", check_varlen_paged, gen)
    bwd_err, bwd_timing = phase("backward kernel checks", check_bwd, gen)
    api_launches = phase("flash_attn_func backward", run_api_backward, gen)
    vl_err, vl_t = phase("varlen kernel checks", check_varlen, gen)
    bench_vl_launches, bench_vl = phase("bench varlen", run_bench_varlen, gen,
                                        card)
    launches, ttft, tok_s = phase("static serving", run_slice, gen)
    print(f"time to first token (b={BATCH}, prompt {PROMPT}, median of 5): "
          f"{ttft * 1e3:.2f} ms; decode {tok_s['graphed']:.1f} tokens/s "
          f"graphed, {tok_s['eager']:.1f} eager at b={BATCH} "
          f"({NEW_TOKENS - 1} steps) on {card}")
    eng_launches, engines = phase("engines", run_engines, card)
    paged, prefix = engines["paged"], engines["prefix_cache"]
    spec, spec_d = engines["speculative_self"], engines["speculative_draft"]
    print(f"paged engine (64 slots, {ENGINE_REQUESTS} x {ENGINE_PROMPT}-token "
          f"prompts + {ENGINE_NEW} new): {paged['tokens_per_s']:.1f} tokens/s,"
          f" TTFT p50 {paged['ttft_p50_ms']:.1f} ms, p99 "
          f"{paged['ttft_p99_ms']:.1f} ms; prefix-cache engine "
          f"({PREFIX_REQUESTS} prompts sharing {PREFIX_SHARED} tokens): "
          f"{prefix['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{prefix['ttft_p50_ms']:.1f} ms, p99 {prefix['ttft_p99_ms']:.1f} ms"
          f" (eager: {engines['paged_eager']['tokens_per_s']:.1f} and "
          f"{engines['prefix_cache_eager']['tokens_per_s']:.1f} tokens/s); "
          f"decode-block idle share {paged['block_idle_share']:.3f} graphed, "
          f"{engines['paged_eager']['block_idle_share']:.3f} eager; "
          f"speculative engine (k={SPEC_K}, {SPEC_REQUESTS} requests): "
          f"{spec['tokens_per_s']:.1f} tokens/s with the target as its own "
          f"draft ({spec['mean_accepted']:.3f} accepted a round), "
          f"{spec_d['tokens_per_s']:.1f} with a {SPEC_DRAFT_LAYERS}-layer "
          f"draft ({spec_d['mean_accepted']:.3f}) on {card}")
    train_launches, train = phase("training", run_training)
    print(f"training step (median of steps {TRAIN_WARM + 1}-{TRAIN_STEPS}): "
          f"{train['step_ms']:.1f} ms; {train['tokens_per_s']:.0f} tokens/s; "
          f"{train['tflops_per_s']:.1f} TFLOP/s (model_flops_per_token); peak "
          f"memory {train['peak_gb']:.2f} GB (max_memory_allocated) on {card}")
    remat = phase("remat", run_remat)
    print("remat (913M GPT, b=4 x 2048): " + "; ".join(
        f"{label} {r['step_ms']:.1f} ms a step, peak {r['peak_gb']:.2f} GB, "
        f"activations {r['activations_gb']:.2f} GB"
        for label, r in remat.items()) + f"; losses bitwise equal on {card}")
    dwconv = phase("dwconv", run_dwconv, gen)
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
    bk_err, bk_t = phase("model breadth kernel checks", check_breadth_kernels,
                         gen)
    br_launches, breadth = phase("model breadth", run_breadth, card)
    vit_launches, breadth["ViT-L/16"] = phase("ViT-L/16", run_vit, gen, card)
    wk_err, wk_t = phase("head dims 96 and 256 kernel checks",
                         check_wide_kernels, gen)
    wide_launches, wide = phase("GPT-NeoX-20B and GPT-J-6B",
                                run_wide_families, card)
    wb_err, wb_t, wb_api, wb_res = phase(
        "head dims 96 and 256 backward kernel checks", check_wide_backward,
        gen, lib)
    wp_launches, wp_err = phase("packed attention at 96 and 256",
                                run_packed_wide, gen, card)
    wt_launches, wide_train = phase("GPT-J-6B and GPT-NeoX-20B training",
                                    run_wide_training, card)
    bd_err, bd_t = phase("band kernel checks", check_band_kernels, gen)
    ms_launches, mistral = phase("Mistral-7B", run_mistral, card)
    bb_err, bb_t, bb_api, bb_res = phase("band backward kernel checks",
                                         check_band_backward, gen, lib)
    bm_launches, bm_err = phase("windowed MHA", run_band_mha, gen, card)
    mt_launches, mistral_train = phase("Mistral-7B training",
                                       run_mistral_training, card)
    sc_err, sc_t = phase("score kernel checks", check_score_kernels, gen)
    bc_launches, baichuan = phase("Baichuan-13B", run_baichuan, card)
    sg_launches, softcap_gpt = phase("913M softcap", run_softcap_gpt, card)
    sb_err, sb_t, sb_api, sb_res = phase("score backward kernel checks",
                                         check_score_backward, gen, lib)
    sm_launches, sm_err = phase("packed score MHA", run_score_mha, gen, card)
    bt_launches, baichuan_train = phase("Baichuan-13B training",
                                        run_baichuan_training, card)
    st_launches, softcap_train = phase("913M softcap training",
                                       run_softcap_training, card)
    kq_err, kq_t = phase("quantized-cache kernel checks",
                         check_kvquant_kernels, gen)
    kq_launches, kvq = phase("913M from an fp8 cache", run_kvquant_913m, gen,
                             card)
    h8_err, h8_t, h8_api = phase("head dim 80 kernel checks",
                                 check_head_dim_80_kernels, gen)
    bl_launches, btlm = phase("BTLM-3B-8K", run_btlm, card)
    hb_err, hb_t, hb_api, hb_res = phase(
        "head dim 80 backward kernel checks", check_head_dim_80_backward, gen,
        lib)
    btt_launches, btlm_train, hm_launches, hm_err = phase(
        "BTLM-3B-8K training", run_btlm_training, card)
    go_launches, go_err, go_t = phase("gpt-oss-20b attention with sinks",
                                      run_gpt_oss_sinks, card)
    dv_launches, dv_err, dv_t, dv_res = phase(
        "DeepSeek-V3 attention at 192 / 128", run_deepseek_v3_attention, card,
        lib)
    for name, r in wide_train.items():
        print(f"{name} trained at full width, {r['layers']} layers "
              f"({r['params_b']:.2f}B parameters), b={TRAIN_BATCH} x "
              f"{TRAIN_SEQ}: step {r['step_ms']:.1f} ms, "
              f"{r['tokens_per_s']:.0f} tokens/s, {r['tflops_per_s']:.1f} "
              f"TFLOP/s, peak {r['peak_gb']:.2f} GB; loss {r['first_loss']:.4f}"
              f" -> {r['last3_loss']:.4f} (fused CE {r['first_loss']:.4f}, "
              f"full-logits CE {r['ce_ref']:.4f}) on {card}")
    for name, d in (("GPT-NeoX-20B", 96), ("GPT-J-6B", 256)):
        fam = wide[name]
        engs = [k for k in wide if k.startswith(name + " ")]
        print(f"{name} (full width, {wide[name]['layers']} layers, head dim "
              f"{d}, b={BATCH} x "
              f"{PROMPT} + {NEW_TOKENS}): TTFT {fam['ttft_ms']:.2f} ms, decode "
              f"{fam['decode_tokens_per_s']:.1f} tokens/s graphed (a step "
              f"{fam['decode_step_ms']:.3f} ms, the weights' read "
              f"{fam['weight_read_ms']:.3f} ms); " + "; ".join(
                  f"{k[len(name) + 1:]} ({BREADTH_REQUESTS} requests on "
                  f"{BREADTH_SLOTS} slots) {wide[k]['tokens_per_s']:.1f} "
                  f"tokens/s, TTFT p50 {wide[k]['ttft_p50_ms']:.1f} ms"
                  for k in engs) + f" on {card}")
    print(f"DeepSeek-V3 absorbed attention ({MLA_LAYERS} layers): prefill "
          f"{mla['prefill_ms_per_layer_chunk']:.3f} ms per layer-chunk, "
          f"decode step {mla['decode_step_ms']:.3f} ms graphed "
          f"({mla['decode_step_ms_eager']:.3f} eager), "
          f"{mla['decode_tokens_per_s']:.1f} tokens/s at b={MLA_BATCH}, peak "
          f"{mla['peak_gb']:.2f} GB on {card}")
    llama, llama_eng = breadth["Llama-3-8B"], breadth["Llama-3-8B paged engine"]
    print(f"Llama-3-8B (full width and depth, b={BATCH} x {PROMPT} + "
          f"{NEW_TOKENS}): TTFT {llama['ttft_ms']:.2f} ms, decode "
          f"{llama['decode_tokens_per_s']:.1f} tokens/s graphed; paged engine "
          f"({BREADTH_REQUESTS} requests on {BREADTH_SLOTS} slots) "
          f"{llama_eng['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{llama_eng['ttft_p50_ms']:.1f} ms on {card}")
    print(f"{BREADTH_LAYERS}-layer families, decode tokens/s graphed (TTFT "
          f"ms): " + ", ".join(
              f"{name} {breadth[name]['decode_tokens_per_s']:.1f} "
              f"({breadth[name]['ttft_ms']:.2f})"
              for name in ("Falcon-7B", "Pythia-6.9B", "OPT-6.7B",
                           "StarCoder"))
          + f"; OPT-6.7B prefix-cache engine "
          f"{breadth['OPT-6.7B prefix-cache engine']['tokens_per_s']:.1f} "
          f"tokens/s; ViT-L/16 {breadth['ViT-L/16']['images_per_s']:.0f} "
          f"images/s at b={VIT_BATCH} on {card}")
    mis, mis_eng = mistral["Mistral-7B"], [
        k for k in mistral if k.startswith("Mistral-7B ")]
    print(f"Mistral-7B (full width, {mis['layers']} layers, window "
          f"{MISTRAL_7B.sliding_window}"
          f", b={MISTRAL_BATCH} x {MISTRAL_PROMPT} + {MISTRAL_NEW}): TTFT "
          f"{mis['ttft_ms']:.2f} ms ({mis['ttft_without_window_ms']:.2f} ms "
          f"without the window), decode {mis['decode_tokens_per_s']:.1f} "
          f"tokens/s graphed (a step {mis['decode_step_ms']:.3f} ms, the "
          f"weights' read {mis['weight_read_ms']:.3f} ms); " + "; ".join(
              f"{k[len('Mistral-7B '):]} ({MISTRAL_SLOTS} x "
              f"{MISTRAL_ENGINE_PROMPT} + {MISTRAL_ENGINE_NEW}) "
              f"{mistral[k]['tokens_per_s']:.1f} tokens/s, TTFT p50 "
              f"{mistral[k]['ttft_p50_ms']:.1f} ms" for k in mis_eng)
          + f" on {card}")
    mtr, b3b = mistral_train, bb_t["flash_bwd_band"]
    print(f"Mistral-7B trained at full width, {MISTRAL_TRAIN_LAYERS} layers "
          f"({mtr['params_b']:.2f}B parameters), window "
          f"{MISTRAL_7B.sliding_window}, b={MISTRAL_TRAIN_BATCH} x "
          f"{MISTRAL_TRAIN_SEQ}: step {mtr['step_ms']:.1f} ms, "
          f"{mtr['tokens_per_s']:.0f} tokens/s, {mtr['tflops_per_s']:.1f} "
          f"TFLOP/s, peak {mtr['peak_gb']:.2f} GB; loss "
          f"{mtr['first_loss']:.4f} -> {mtr['last3_loss']:.4f} (full-logits "
          f"CE {mtr['ce_ref']:.4f}); B3's band pair at its shape (one layer) "
          f"{b3b['ms']:.4f} ms beside the band-free pair "
          f"{b3b['band_free_ms']:.4f} ms, SDPA's masked backward "
          f"{b3b['library_ms']:.4f} ms and the bound {b3b['bound_ms']:.4f} ms "
          f"on {card}")
    bc, bc_eng = baichuan["Baichuan-13B"], [
        k for k in baichuan if k.startswith("Baichuan-13B ")]
    print(f"Baichuan-13B (full width and depth, {bc['layers']} layers, "
          f"{bc['params_b']:.2f}B parameters, ALiBi, b={BATCH} x {PROMPT} + "
          f"{NEW_TOKENS}): TTFT {bc['ttft_ms']:.2f} ms, decode "
          f"{bc['decode_tokens_per_s']:.1f} tokens/s graphed "
          f"({bc['decode_tokens_per_s_eager']:.1f} eager; a step "
          f"{bc['decode_step_ms']:.3f} ms, the weights' read "
          f"{bc['weight_read_ms']:.3f} ms); " + "; ".join(
              f"{k[len('Baichuan-13B '):]} ({BREADTH_REQUESTS} requests on "
              f"{BREADTH_SLOTS} slots) {baichuan[k]['tokens_per_s']:.1f} "
              f"tokens/s, TTFT p50 {baichuan[k]['ttft_p50_ms']:.1f} ms"
              for k in bc_eng) + f" on {card}")
    sg = softcap_gpt["913M softcap"]
    print(f"913M GPT with softcap 50 (b={BATCH} x {PROMPT} + {NEW_TOKENS}): "
          f"TTFT {sg['ttft_ms']:.2f} ms, decode "
          f"{sg['decode_tokens_per_s']:.1f} tokens/s graphed; " + "; ".join(
              f"{k[len('913M softcap '):]} {softcap_gpt[k]['tokens_per_s']:.1f}"
              f" tokens/s, TTFT p50 {softcap_gpt[k]['ttft_p50_ms']:.1f} ms"
              for k in softcap_gpt if k.startswith("913M softcap "))
          + f" on {card}")
    for label, r, row, cut in (
            (f"Baichuan-13B trained at full width, {BAICHUAN_TRAIN_LAYERS} "
             f"layers", baichuan_train, "flash_bwd_alibi",
             f"b={BAICHUAN_TRAIN_BATCH} x {BAICHUAN_TRAIN_SEQ}"),
            ("913M GPT trained with softcap 50", softcap_train,
             "flash_bwd_softcap", f"b={TRAIN_BATCH} x {TRAIN_SEQ}")):
        t3 = sb_t[row]
        print(f"{label} ({r['params_b']:.2f}B parameters), {cut}: step "
              f"{r['step_ms']:.1f} ms, {r['tokens_per_s']:.0f} tokens/s, "
              f"{r['tflops_per_s']:.1f} TFLOP/s, peak {r['peak_gb']:.2f} GB; "
              f"loss {r['first_loss']:.4f} -> {r['last3_loss']:.4f} "
              f"(full-logits CE {r['ce_ref']:.4f}); B3's score pair at its "
              f"shape (one layer) {t3['ms']:.4f} ms beside the pair without "
              f"the map {t3['without_map_ms']:.4f} ms and the bound "
              f"{t3['bound_ms']:.4f} ms ({t3['bound_largest']}) on {card}")
    for scale in KV_SCALES:
        st, key = kvq[f"913M fp8 x{scale}"], f"913M fp8 x{scale}"
        print(f"913M from an fp8 cache, kv_cache_scale {scale} (b={BATCH} x "
              f"{PROMPT} + {NEW_TOKENS}): decode "
              f"{st['decode_tokens_per_s']:.1f} tokens/s graphed against "
              f"{st['bf16_decode_tokens_per_s']:.1f} from the bf16 cache; "
              f"logit drift {st['drift_max']:.4f} (last step "
              f"{st['drift_last']:.4f}, bound {KV_DRIFT_BOUND}); " + "; ".join(
                  f"{kind} engine ({n} requests on {KV_ENGINE_REQUESTS} "
                  f"slots) {kvq[f'{key} {kind} engine']['tokens_per_s']:.1f}"
                  " tokens/s" for kind, n in (
                      ("paged", KV_ENGINE_REQUESTS),
                      ("prefix-cache", KV_ENGINE_REQUESTS),
                      ("speculative", KV_SPEC_REQUESTS)))
              + f" on {card}")
    dk, dpk = kq_t["flash_decode_kv8"], kq_t["flash_decode_paged_kv8"]
    print(f"B4 over the fp8 cache at the 913M's decode step {dk['ms']:.4f} ms "
          f"against {dk['bf16_cache_ms']:.4f} ms over a bf16 cache; at the "
          f"engine's {dpk['ms']:.4f} against {dpk['bf16_cache_ms']:.4f} ms on "
          f"{card}")
    lq = breadth["Llama-3-8B fp8 cache"]
    print(f"Llama-3-8B from an fp8 cache (full width and depth, b={BATCH} x "
          f"{PROMPT} + {NEW_TOKENS}): decode {lq['decode_tokens_per_s']:.1f} "
          f"tokens/s graphed against {lq['bf16_decode_tokens_per_s']:.1f} "
          f"from the bf16 cache; logit drift {lq['drift_max']:.4f} (last "
          f"step {lq['drift_last']:.4f}, bound {KV_DRIFT_BOUND}) on {card}")
    bl, bl_eng = btlm["BTLM-3B-8K"], [
        k for k in btlm if k.startswith("BTLM-3B-8K ")]
    print(f"BTLM-3B-8K (full width and depth, {bl['layers']} layers, "
          f"{bl['params_b']:.2f}B parameters, 32 heads of 80, ALiBi, softmax "
          f"scale 1/80, b={BATCH} x {PROMPT} + {NEW_TOKENS}): TTFT "
          f"{bl['ttft_ms']:.2f} ms, decode {bl['decode_tokens_per_s']:.1f} "
          f"tokens/s graphed ({bl['decode_tokens_per_s_eager']:.1f} eager; a "
          f"step {bl['decode_step_ms']:.3f} ms, the weights' read "
          f"{bl['weight_read_ms']:.3f} ms), peak {bl['serve_peak_gb']:.2f} GB; "
          + "; ".join(
              f"{k[len('BTLM-3B-8K '):]} ({BREADTH_REQUESTS} requests on "
              f"{BREADTH_SLOTS} slots) {btlm[k]['tokens_per_s']:.1f} "
              f"tokens/s, TTFT p50 {btlm[k]['ttft_p50_ms']:.1f} ms"
              for k in bl_eng) + f" on {card}")
    bt3 = hb_t["flash_bwd_d80"]
    print(f"BTLM-3B-8K trained at full width, {btlm_train['layers']} layers "
          f"({btlm_train['params_b']:.2f}B parameters, 32 heads of 80, "
          f"ALiBi, softmax scale 1/80), b={BTLM_TRAIN_BATCH} x "
          f"{BTLM_TRAIN_SEQ}: step {btlm_train['step_ms']:.1f} ms, "
          f"{btlm_train['tokens_per_s']:.0f} tokens/s, "
          f"{btlm_train['tflops_per_s']:.1f} TFLOP/s, peak "
          f"{btlm_train['peak_gb']:.2f} GB; loss "
          f"{btlm_train['first_loss']:.4f} -> {btlm_train['last3_loss']:.4f} "
          f"(full-logits CE {btlm_train['ce_ref']:.4f}); B3's score pair at "
          f"80 at its shape (one layer) {bt3['ms']:.4f} ms beside the pair "
          f"without the map {bt3['without_map_ms']:.4f} ms, SDPA's backward "
          f"{bt3['library_ms']:.4f} ms and the bound {bt3['bound_ms']:.4f} ms "
          f"({bt3['bound_largest']}) on {card}")
    print("phase wall times: " + ", ".join(
        f"{name} {sec:.1f} s" for name, sec in phases.items()))

    def varlen_both(name):
        """A varlen kernel's timing at BERT's packing, with bench.py's mixed
        shape's under "bench_mixed"."""
        return {**vl_t["BERT-large packing"][name],
                "bench_mixed": vl_t["bench.py mixed"][name]}

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
              eng_launches["paged"]["flash_decode_paged"], pdec_err, pdec_t),
        entry("flash_decode_paged_verify", "flash_decode.cu",
              "flash_decode.py:54",
              eng_launches["speculative_self"]["flash_decode_paged"],
              vdec_err, vdec_t),
        entry("flash_varlen_paged", "flash_varlen_paged.cu",
              "flash_varlen_paged.py:69",
              eng_launches["prefix_cache"]["flash_varlen_paged"], vp_err,
              vp_t),
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
        entry("flash_varlen_fwd", "flash_varlen_fwd.cu", "flash_varlen.py:79",
              bench_vl_launches["flash_varlen_fwd"], vl_err["flash_varlen_fwd"],
              vl_t["bench.py mixed"]["flash_varlen_fwd"]),
        entry("flash_varlen_fwd_persistent", "flash_varlen_fwd.cu",
              "flash_varlen_persistent.py:72",
              bert_launches["flash_varlen_fwd_persistent"],
              vl_err["flash_varlen_fwd_persistent"],
              vl_t["BERT-large packing"]["flash_varlen_fwd_persistent"]),
        entry("flash_varlen_bwd_preprocess", "flash_varlen.cu",
              "flash_varlen.py:854", bert_launches["fa_varlen_bwd_preprocess"],
              vl_err["flash_varlen_bwd_preprocess"],
              varlen_both("flash_varlen_bwd_preprocess")),
        entry("fa_varlen_bwd_dkdv", "flash_varlen.cu", "flash_varlen.py:462",
              bert_launches["fa_varlen_bwd_dkdv"], vl_err["fa_varlen_bwd_dkdv"],
              varlen_both("fa_varlen_bwd_dkdv")),
        entry("fa_varlen_bwd_dq", "flash_varlen.cu", "flash_varlen.py:651",
              bert_launches["fa_varlen_bwd_dq"], vl_err["fa_varlen_bwd_dq"],
              varlen_both("fa_varlen_bwd_dq")),
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
        entry("flash_blocksparse_bwd_preprocess", "flash_blocksparse.cu",
              "flash_blocksparse.py:403",
              bs_launches["flash_blocksparse_bwd_preprocess"],
              bs_err["flash_blocksparse_bwd_preprocess"],
              bs_t["flash_blocksparse_bwd_preprocess"]),
        entry("flash_blocksparse_bwd", "flash_blocksparse.cu",
              "flash_blocksparse.py:225", bs_launches["flash_blocksparse_bwd"],
              bs_err["flash_blocksparse_bwd"], bs_t["flash_blocksparse_bwd"]),
        entry("flash_fwd_gqa71", "flash_fwd.cu", "flash_fwd.py:59",
              br_launches["Falcon-7B"]["flash_fwd"], bk_err["flash_fwd_gqa71"],
              bk_t["flash_fwd_gqa71"]),
        entry("flash_fwd_gqa48", "flash_fwd.cu", "flash_fwd.py:59",
              br_launches["StarCoder"]["flash_fwd"], bk_err["flash_fwd_gqa48"],
              bk_t["flash_fwd_gqa48"]),
        entry("flash_fwd_vit", "flash_fwd.cu", "flash_fwd.py:59",
              vit_launches["flash_fwd"], bk_err["flash_fwd_vit"],
              bk_t["flash_fwd_vit"]),
        entry("flash_decode_group71", "flash_decode.cu", "flash_decode.py:54",
              br_launches["Falcon-7B"]["flash_decode"],
              bk_err["flash_decode_group71"], bk_t["flash_decode_group71"]),
        entry("flash_decode_group48", "flash_decode.cu", "flash_decode.py:54",
              br_launches["StarCoder"]["flash_decode"],
              bk_err["flash_decode_group48"], bk_t["flash_decode_group48"]),
        *(entry(f"flash_fwd_d{d}", "flash_fwd.cu", "flash_fwd.py:59",
                wide_launches[fam]["flash_fwd"], wk_err[f"flash_fwd_d{d}"],
                wk_t[f"flash_fwd_d{d}"])
          for fam, d, _ in WIDE_FAMILIES),
        *(entry(f"flash_decode_d{d}", "flash_decode.cu", "flash_decode.py:54",
                wide_launches[fam]["flash_decode"],
                wk_err[f"flash_decode_d{d}"], wk_t[f"flash_decode_d{d}"])
          for fam, d, _ in WIDE_FAMILIES),
        # the paged route's launches at its head dim in the family's
        # prefix-cached engine; the verify step's row counts them too (no
        # model path at that head dim runs sq = SPEC_K + 1)
        *(entry(name, "flash_decode.cu", "flash_decode.py:54",
                wide_launches[f"{fam} prefix-cache engine"]
                ["flash_decode_paged"], wk_err[name], wk_t[name])
          for fam, d, _ in WIDE_FAMILIES
          for name in (f"flash_decode_paged_d{d}",)
          + ((f"flash_decode_paged_d{d}_verify",) if d == WIDE_VERIFY_D
             else ())),
        *(entry(f"flash_varlen_paged_d{d}", "flash_varlen_paged.cu",
                "flash_varlen_paged.py:69",
                wide_launches[f"{fam} prefix-cache engine"]
                ["flash_varlen_paged"], wk_err[f"flash_varlen_paged_d{d}"],
                wk_t[f"flash_varlen_paged_d{d}"])
          for fam, d, _ in WIDE_FAMILIES),
        # the backwards and the packed forwards at 96 and 256: B3's and
        # the preprocess's launches in the family's training, B2's in the
        # counted flash_attn_func(deterministic=False).backward(), the
        # packed ones' in the counted packed run at the training shape
        *(row for fam, d, _ in WIDE_FAMILIES for row in (
            entry(f"flash_bwd_preprocess_d{d}", "flash_bwd_wide.cu",
                  "flash_bwd.py:408",
                  wt_launches[fam]["flash_bwd_preprocess"],
                  wb_err[f"flash_bwd_preprocess_d{d}"],
                  wb_t[f"flash_bwd_preprocess_d{d}"]),
            entry(f"flash_bwd_d{d}", "flash_bwd_wide.cu", "flash_bwd.py:181",
                  wt_launches[fam]["fa_bwd_dkdv"]
                  + wt_launches[fam]["fa_bwd_dq"],
                  wb_err[f"flash_bwd_d{d}"], wb_t[f"flash_bwd_d{d}"]),
            entry(f"flash_bwd_fused_d{d}", "flash_bwd_wide.cu",
                  "flash_bwd_fused.py:64", wb_api[d][False]["flash_bwd_fused"],
                  wb_err[f"flash_bwd_fused_d{d}"],
                  wb_t[f"flash_bwd_fused_d{d}"]),
            *(entry(f"{name}_d{d}", source, replaces, wp_launches[fam][count],
                    wb_err[f"{name}_d{d}"], wb_t[f"{name}_d{d}"])
              for name, source, replaces, count in (
                  ("flash_varlen_fwd", "flash_varlen_fwd.cu",
                   "flash_varlen.py:79", "flash_varlen_fwd"),
                  ("flash_varlen_fwd_persistent", "flash_varlen_fwd.cu",
                   "flash_varlen_persistent.py:72",
                   "flash_varlen_fwd_persistent"),
                  ("flash_varlen_bwd_preprocess", "flash_varlen_wide.cu",
                   "flash_varlen.py:854", "fa_varlen_bwd_preprocess"),
                  ("fa_varlen_bwd_dkdv", "flash_varlen_wide.cu",
                   "flash_varlen.py:462", "fa_varlen_bwd_dkdv"),
                  ("fa_varlen_bwd_dq", "flash_varlen_wide.cu",
                   "flash_varlen.py:651", "fa_varlen_bwd_dq"))))),
        # the band masks: B1's band instantiation at Mistral-7B's prefill,
        # B4 under the window at its static and engine decode steps and
        # its verify step, B8's band instantiation at its prefix-cached
        # admission; the launches those of the Mistral-7B runs
        entry("flash_fwd_band", "flash_fwd.cu", "flash_fwd.py:59",
              ms_launches["Mistral-7B"]["flash_fwd_band"],
              bd_err["flash_fwd_band"], bd_t["flash_fwd_band"]),
        entry("flash_decode_band", "flash_decode.cu", "flash_decode.py:54",
              ms_launches["Mistral-7B"]["flash_decode_band"],
              bd_err["flash_decode_band"], bd_t["flash_decode_band"]),
        entry("flash_decode_paged_band", "flash_decode.cu",
              "flash_decode.py:54",
              ms_launches["Mistral-7B paged engine"]
              ["flash_decode_paged_band"], bd_err["flash_decode_paged_band"],
              bd_t["flash_decode_paged_band"]),
        entry("flash_decode_paged_band_verify", "flash_decode.cu",
              "flash_decode.py:54",
              ms_launches["Mistral-7B speculative engine"]
              ["flash_decode_paged_band"],
              bd_err["flash_decode_paged_band_verify"],
              bd_t["flash_decode_paged_band_verify"]),
        entry("flash_varlen_paged_band", "flash_varlen_paged.cu",
              "flash_varlen_paged.py:69",
              ms_launches["Mistral-7B prefix-cache engine"]
              ["flash_varlen_paged_band"], bd_err["flash_varlen_paged_band"],
              bd_t["flash_varlen_paged_band"]),
        # the band in training: B3's band pair in the Mistral-7B training
        # run, B2's in the counted flash_attn_func(deterministic=False)
        # .backward() at its shape, B7's and B6's band backward in the
        # windowed packed MHA, B6's band forward in band_bwd_case's counted
        # packed run at the timed shape
        entry("flash_bwd_band", "flash_bwd_band.cu", "flash_bwd.py:181",
              mt_launches["fa_bwd_dkdv_band"] + mt_launches["fa_bwd_dq_band"],
              bb_err["flash_bwd_band"], bb_t["flash_bwd_band"]),
        entry("flash_bwd_fused_band", "flash_bwd_band.cu",
              "flash_bwd_fused.py:64", bb_api[False]["flash_bwd_fused_band"],
              bb_err["flash_bwd_fused_band"], bb_t["flash_bwd_fused_band"]),
        entry("flash_varlen_fwd_band", "flash_varlen_fwd_band.cu",
              "flash_varlen.py:79", bb_api["packed"]["flash_varlen_fwd_band"],
              bb_err["flash_varlen_fwd_band"], bb_t["flash_varlen_fwd_band"]),
        entry("flash_varlen_fwd_persistent_band", "flash_varlen_fwd_band.cu",
              "flash_varlen_persistent.py:72",
              bm_launches["packed"]["flash_varlen_fwd_persistent_band"],
              bb_err["flash_varlen_fwd_persistent_band"],
              bb_t["flash_varlen_fwd_persistent_band"]),
        entry("fa_varlen_bwd_dkdv_band", "flash_varlen_band.cu",
              "flash_varlen.py:462",
              bm_launches["packed"]["fa_varlen_bwd_dkdv_band"],
              bb_err["fa_varlen_bwd_dkdv_band"],
              bb_t["fa_varlen_bwd_dkdv_band"]),
        entry("fa_varlen_bwd_dq_band", "flash_varlen_band.cu",
              "flash_varlen.py:651",
              bm_launches["packed"]["fa_varlen_bwd_dq_band"],
              bb_err["fa_varlen_bwd_dq_band"], bb_t["fa_varlen_bwd_dq_band"]),
        # softcap and ALiBi: B1's, B4's and B8's score instantiations, the
        # launches those of Baichuan-13B's (ALiBi) and the softcap GPT's runs
        entry("flash_fwd_alibi", "flash_fwd_score.cu", "flash_fwd.py:59",
              bc_launches["Baichuan-13B"]["flash_fwd_score"],
              sc_err["flash_fwd_alibi"], sc_t["flash_fwd_alibi"]),
        entry("flash_fwd_softcap", "flash_fwd_score.cu", "flash_fwd.py:59",
              sg_launches["913M softcap"]["flash_fwd_score"],
              sc_err["flash_fwd_softcap"], sc_t["flash_fwd_softcap"]),
        entry("flash_decode_alibi", "flash_decode.cu", "flash_decode.py:54",
              bc_launches["Baichuan-13B"]["flash_decode_score"],
              sc_err["flash_decode_alibi"], sc_t["flash_decode_alibi"]),
        entry("flash_decode_paged_alibi", "flash_decode.cu",
              "flash_decode.py:54",
              bc_launches["Baichuan-13B paged engine"]
              ["flash_decode_paged_score"],
              sc_err["flash_decode_paged_alibi"],
              sc_t["flash_decode_paged_alibi"]),
        entry("flash_decode_paged_alibi_verify", "flash_decode.cu",
              "flash_decode.py:54",
              bc_launches["Baichuan-13B speculative engine"]
              ["flash_decode_paged_score"],
              sc_err["flash_decode_paged_alibi_verify"],
              sc_t["flash_decode_paged_alibi_verify"]),
        entry("flash_decode_softcap", "flash_decode.cu", "flash_decode.py:54",
              sg_launches["913M softcap"]["flash_decode_score"],
              sc_err["flash_decode_softcap"], sc_t["flash_decode_softcap"]),
        entry("flash_decode_paged_softcap", "flash_decode.cu",
              "flash_decode.py:54",
              sg_launches["913M softcap paged engine"]
              ["flash_decode_paged_score"],
              sc_err["flash_decode_paged_softcap"],
              sc_t["flash_decode_paged_softcap"]),
        entry("flash_varlen_paged_softcap", "flash_varlen_paged_score.cu",
              "flash_varlen_paged.py:69",
              sg_launches["913M softcap prefix-cache engine"]
              ["flash_varlen_paged_score"],
              sc_err["flash_varlen_paged_softcap"],
              sc_t["flash_varlen_paged_softcap"]),
        # softcap and ALiBi in training: B3's score pair in the
        # Baichuan-13B and softcap GPT training runs, B2's in the counted
        # flash_attn_func(deterministic=False).backward() at their shapes,
        # B6's score forward (ALiBi, as JAX routes it), B7's (the cap) and
        # B6's score backward in the packed score MHAs, B6's forward under
        # the cap and B7's under ALiBi in score_bwd_case's counted packed
        # run at the timed shape
        *(row for kind, train in (("alibi", bt_launches),
                                  ("softcap", st_launches)) for row in (
            entry(f"flash_bwd_{kind}", "flash_bwd_score.cu",
                  "flash_bwd.py:181",
                  train["fa_bwd_dkdv_score"] + train["fa_bwd_dq_score"],
                  sb_err[f"flash_bwd_{kind}"], sb_t[f"flash_bwd_{kind}"]),
            entry(f"flash_bwd_fused_{kind}", "flash_bwd_score.cu",
                  "flash_bwd_fused.py:64",
                  sb_api[kind][False]["flash_bwd_fused_score"],
                  sb_err[f"flash_bwd_fused_{kind}"],
                  sb_t[f"flash_bwd_fused_{kind}"]),
            entry(f"flash_varlen_fwd_{kind}", "flash_varlen_fwd_score.cu",
                  "flash_varlen.py:79",
                  (sm_launches["alibi"] if kind == "alibi" else
                   sb_api["softcap"]["packed"])["flash_varlen_fwd_score"],
                  sb_err[f"flash_varlen_fwd_{kind}"],
                  sb_t[f"flash_varlen_fwd_{kind}"]),
            entry(f"flash_varlen_fwd_persistent_{kind}",
                  "flash_varlen_fwd_score.cu", "flash_varlen_persistent.py:72",
                  (sm_launches["softcap"] if kind == "softcap" else
                   sb_api["alibi"]["packed"])
                  ["flash_varlen_fwd_persistent_score"],
                  sb_err[f"flash_varlen_fwd_persistent_{kind}"],
                  sb_t[f"flash_varlen_fwd_persistent_{kind}"]),
            entry(f"fa_varlen_bwd_dkdv_{kind}", "flash_varlen_score.cu",
                  "flash_varlen.py:462",
                  sm_launches[kind]["fa_varlen_bwd_dkdv_score"],
                  sb_err[f"fa_varlen_bwd_dkdv_{kind}"],
                  sb_t[f"fa_varlen_bwd_dkdv_{kind}"]),
            entry(f"fa_varlen_bwd_dq_{kind}", "flash_varlen_score.cu",
                  "flash_varlen.py:651",
                  sm_launches[kind]["fa_varlen_bwd_dq_score"],
                  sb_err[f"fa_varlen_bwd_dq_{kind}"],
                  sb_t[f"fa_varlen_bwd_dq_{kind}"]))),
        # quantized caches: B4 over the fp8 cache at the 913M's static
        # decode step, engine decode step and verify step, B8 with descales
        # at its prefix-cached admission over the converted pages, and that
        # conversion (B11's role); the launches those of the runs at
        # kv_cache_scale 1.0
        entry("flash_decode_kv8", "flash_decode_kv8.cu", "flash_decode.py:54",
              kq_launches["913M fp8 x1.0"]["flash_decode_kv8"],
              kq_err["flash_decode_kv8"], kq_t["flash_decode_kv8"]),
        entry("flash_decode_paged_kv8", "flash_decode_kv8.cu",
              "flash_decode.py:54",
              kq_launches["913M fp8 x1.0 paged engine"]
              ["flash_decode_paged_kv8"], kq_err["flash_decode_paged_kv8"],
              kq_t["flash_decode_paged_kv8"]),
        entry("flash_decode_paged_kv8_verify", "flash_decode_kv8.cu",
              "flash_decode.py:54",
              kq_launches["913M fp8 x1.0 speculative engine"]
              ["flash_decode_paged_kv8"],
              kq_err["flash_decode_paged_kv8_verify"],
              kq_t["flash_decode_paged_kv8_verify"]),
        entry("flash_varlen_paged_descale", "flash_varlen_paged.cu",
              "flash_varlen_paged.py:69",
              kq_launches["913M fp8 x1.0 prefix-cache engine"]
              ["flash_varlen_paged_descale"],
              kq_err["flash_varlen_paged_descale"],
              kq_t["flash_varlen_paged_descale"]),
        entry("kv_dequant", "kv_dequant.cu", "fp8_cast.py:28",
              kq_launches["913M fp8 x1.0 prefix-cache engine"]["kv_dequant"],
              kq_err["kv_dequant"], kq_t["kv_dequant"]),
        # head dim 80: B1's, B4's and B8's instantiations at 80, the
        # launches those of the BTLM-3B-8K runs (B1 and B4 under ALiBi); B8
        # and B4 over a 1-byte cache at 80, which no model path reaches,
        # those of the counted entry-point calls at BTLM's shapes
        entry("flash_fwd_d80", "flash_fwd_80.cu", "flash_fwd.py:59",
              bl_launches["BTLM-3B-8K"]["flash_fwd"],
              h8_err["flash_fwd_d80"], h8_t["flash_fwd_d80"]),
        entry("flash_decode_d80", "flash_decode_80.cu", "flash_decode.py:54",
              bl_launches["BTLM-3B-8K"]["flash_decode"],
              h8_err["flash_decode_d80"], h8_t["flash_decode_d80"]),
        entry("flash_decode_paged_d80", "flash_decode_80.cu",
              "flash_decode.py:54",
              bl_launches["BTLM-3B-8K paged engine"]["flash_decode_paged"],
              h8_err["flash_decode_paged_d80"],
              h8_t["flash_decode_paged_d80"]),
        entry("flash_decode_paged_d80_verify", "flash_decode_80.cu",
              "flash_decode.py:54",
              bl_launches["BTLM-3B-8K speculative engine"]
              ["flash_decode_paged"],
              h8_err["flash_decode_paged_d80_verify"],
              h8_t["flash_decode_paged_d80_verify"]),
        entry("flash_decode_kv8_d80", "flash_decode_80.cu",
              "flash_decode.py:54",
              h8_api["flash_decode_kv8_d80"]["flash_decode_paged_kv8"],
              h8_err["flash_decode_kv8_d80"], h8_t["flash_decode_kv8_d80"]),
        entry("flash_varlen_paged_d80", "flash_varlen_paged_80.cu",
              "flash_varlen_paged.py:69",
              h8_api["flash_varlen_paged_d80"]["flash_varlen_paged"],
              h8_err["flash_varlen_paged_d80"],
              h8_t["flash_varlen_paged_d80"]),
        # head dim 80 in training: B3's score pair and the preprocess in the
        # BTLM-3B-8K training run, B2's in the counted
        # flash_attn_func(deterministic=False).backward() at its shape (no
        # model path selects B2), B6's score forward and backward and its
        # preprocess in the packed ALiBi MHA at BTLM's widths, B7's in the
        # packed capped one; timed at BTLM's training shape
        entry("flash_bwd_preprocess_d80", "flash_bwd_80.cu",
              "flash_bwd.py:408", btt_launches["flash_bwd_preprocess"],
              hb_err["flash_bwd_preprocess_d80"],
              hb_t["flash_bwd_preprocess_d80"]),
        entry("flash_bwd_d80", "flash_bwd_score_80.cu", "flash_bwd.py:181",
              btt_launches["fa_bwd_dkdv"] + btt_launches["fa_bwd_dq"],
              hb_err["flash_bwd_d80"], hb_t["flash_bwd_d80"]),
        entry("flash_bwd_fused_d80", "flash_bwd_score_80.cu",
              "flash_bwd_fused.py:64", hb_api[False]["flash_bwd_fused"],
              hb_err["flash_bwd_fused_d80"], hb_t["flash_bwd_fused_d80"]),
        entry("flash_varlen_fwd_d80", "flash_varlen_fwd_80.cu",
              "flash_varlen.py:79", hm_launches["alibi"]["flash_varlen_fwd"],
              hb_err["flash_varlen_fwd_d80"], hb_t["flash_varlen_fwd_d80"]),
        entry("flash_varlen_fwd_persistent_d80", "flash_varlen_fwd_80.cu",
              "flash_varlen_persistent.py:72",
              hm_launches["softcap"]["flash_varlen_fwd_persistent"],
              hb_err["flash_varlen_fwd_persistent_d80"],
              hb_t["flash_varlen_fwd_persistent_d80"]),
        *(entry(f"{name}_d80", source, replaces,
                sum(hm_launches[form][count] for form in hm_launches),
                hb_err[f"{name}_d80"], hb_t[f"{name}_d80"])
          for name, source, replaces, count in (
              ("flash_varlen_bwd_preprocess", "flash_varlen_80.cu",
               "flash_varlen.py:854", "fa_varlen_bwd_preprocess"),
              ("fa_varlen_bwd_dkdv", "flash_varlen_score_80.cu",
               "flash_varlen.py:462", "fa_varlen_bwd_dkdv"),
              ("fa_varlen_bwd_dq", "flash_varlen_score_80.cu",
               "flash_varlen.py:651", "fa_varlen_bwd_dq"))),
        # the learnable sink: B1's, B7's and B3's pair (with the dsink
        # epilogue) launches those of gpt-oss-20b's 24-layer stack at 2 x
        # 4,096 and packed, B2's the counted deterministic=False call, B6's
        # forward the ALiBi + sink call, B8's the three admissions, B8p's
        # the serving chunk; timed beside the sink-free forms (sink_timings)
        *(entry(name, source, replaces, n, go_err[name], go_t[name])
          for name, source, replaces, n in (
              ("flash_fwd_sink", "flash_fwd.cu", "flash_fwd.py:59",
               go_launches["dense"]["flash_fwd_sink"]),
              ("flash_bwd_sink", "flash_bwd.cu", "flash_bwd.py:181",
               go_launches["dense"]["fa_bwd_dkdv"]
               + go_launches["dense"]["fa_bwd_dq"]),
              ("flash_bwd_fused_sink", "flash_bwd.cu",
               "flash_bwd_fused.py:64",
               go_launches["fused"]["flash_bwd_fused"]),
              ("flash_varlen_fwd_sink", "flash_varlen_fwd_score.cu",
               "flash_varlen.py:79",
               go_launches["alibi"]["flash_varlen_fwd_sink"]),
              ("flash_varlen_fwd_persistent_sink", "flash_varlen_fwd.cu",
               "flash_varlen_persistent.py:72",
               go_launches["packed"]["flash_varlen_fwd_persistent_sink"]),
              ("flash_varlen_bwd_sink", "flash_varlen.cu",
               "flash_varlen.py:462",
               go_launches["packed"]["fa_varlen_bwd_dkdv"]
               + go_launches["packed"]["fa_varlen_bwd_dq"]),
              ("flash_varlen_paged_sink", "flash_varlen_paged.cu",
               "flash_varlen_paged.py:69",
               go_launches["paged"]["flash_varlen_paged_sink"]),
              ("flash_paged_prefill_sink", "flash_paged_prefill.cu",
               "flash_paged_prefill.py:60",
               go_launches["mla"]["flash_paged_prefill_sink"]))),
        # q/k head dim 192 beside v head dim 128: B1's, the preprocess's and
        # B3's pair's launches those of DeepSeek-V3's 61-layer stack, B2's
        # the counted deterministic=False call at its layer shape; timed
        # at that shape (dv_timings)
        *(entry(f"{row}_d192", "flash_fwd_192.cu" if row == "flash_fwd"
                else "flash_bwd_192.cu", replaces, n, dv_err[row], dv_t[row])
          for row, replaces, n in (
              ("flash_fwd", "flash_fwd.py:59",
               dv_launches["stack"]["flash_fwd_dv"]),
              ("flash_bwd_preprocess", "flash_bwd.py:408",
               dv_launches["stack"]["flash_bwd_preprocess_dv"]),
              ("flash_bwd", "flash_bwd.py:181",
               dv_launches["stack"]["fa_bwd_dkdv_dv"]
               + dv_launches["stack"]["fa_bwd_dq_dv"]),
              ("flash_bwd_fused", "flash_bwd_fused.py:64",
               dv_launches["fused"]["flash_bwd_fused_dv"]))),
        entry("smem_probe", "probes.cu", "benchmarks/vmem_probe.py:18",
              pr_launches["smem_probe"], pr_err["smem_probe"],
              pr_t["smem_probe"]),
        entry("mma_exp2_overlap_probe", "probes.cu",
              "benchmarks/mxu_vpu_overlap_probe.py:31",
              pr_launches["mma_exp2_overlap_probe"],
              pr_err["mma_exp2_overlap_probe"],
              pr_t["mma_exp2_overlap_probe"]),
    ], "engines": engines,
        "varlen": {"timings": vl_t, "bench": bench_vl}, "bert": bert,
        "mla": {"serving": mla, "timings": mla_t},
        "blocksparse": bs_all, "probes": probes, "breadth": breadth,
        "wide_head_dims": wide, "remat": remat, "dwconv": dwconv,
        "wide_training": {"models": wide_train, "packed_mha_err": wp_err,
                          "kernel_resources": wb_res},
        "band": bd_t, "mistral": mistral,
        "band_training": {"mistral": mistral_train, "mha_err": bm_err,
                          "mha_launches": bm_launches,
                          "kernel_resources": bb_res},
        "score": {"timings": sc_t, "baichuan": baichuan,
                  "softcap_gpt": softcap_gpt},
        "kvquant": {"timings": kq_t, "serving": kvq,
                    "llama": breadth["Llama-3-8B fp8 cache"]},
        "score_training": {"baichuan": baichuan_train,
                           "softcap_gpt": softcap_train, "mha_err": sm_err,
                           "mha_launches": sm_launches,
                           "kernel_resources": sb_res},
        "head_dim_80": {"timings": h8_t, "api_launches": h8_api,
                        "btlm": btlm},
        "head_dim_80_training": {"timings": hb_t, "api_launches": hb_api,
                                 "kernel_resources": hb_res,
                                 "btlm": btlm_train, "mha_err": hm_err,
                                 "mha_launches": hm_launches},
        "learnable_sink": {"timings": go_t, "launches": go_launches},
        "head_dims_192_128": {"timings": dv_t, "launches": dv_launches,
                              "kernel_resources": dv_res}}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
