"""Smoke run of the PyTorch + CUDA port (flash_attn_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. builds the CUDA kernels from flash_attn_tpu_torch/csrc with nvcc
   (sm_90a) and prints the build time;
2. holds each kernel against its plain PyTorch version at the shapes of the
   serving and training paths (the repo's 2x rule against an fp32
   reference for out and for dq/dk/dv, an absolute bound for lse), checks
   that the deterministic backward gives the same bits twice, and times
   kernels and plain versions with CUDA events;
3. calls flash_attn_func(...).backward() at the training shape, once with
   deterministic=True and once with False, and checks each run's launch
   counts and gradients;
4. serves 8 seeded 512-token prompts with the flagship 913M GPT (random
   weights from a seed, bf16) through serving.generation.decode for 32 new
   tokens, checks that the kernels carried it (launch counts), that the
   logits are finite and that the decode steps agree with one teacher-forced
   forward; then times the first token and the decode rate;
5. trains the same model (random weights from a seed, bf16 weights with
   fp32 masters, bf16 Adam moments, fused CE) at b=4 x 2048 for 10 steps
   with Trainer.fit over an LMDataLoader of a seeded token file, checks
   the launch counts, a finite and falling loss, and the first step's
   fused-CE loss against torch's cross-entropy over full fp32 logits; then
   prints the step time, tokens/s, TFLOP/s, peak memory and a split of one
   training step's device time (torch.profiler and CUDA events).

It prints the card's name and power limit, one JSON line with the kernels'
launches, errors and times, and as its last line
{"ok": true, "device": {...}}. It needs a CUDA card and exits non-zero
without one, and when run outside a checkout of the repo.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

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
# lse is fp32 in the kernel and in the plain version, from the same bf16
# inputs; they differ only in summation order (|scores| <~ 20 here).
LSE_ATOL = 1e-3
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
    ends, and the device would then wait for the host again."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(0, runs, batch):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(batch)]
        torch.cuda._sleep(100_000_000)
        for start, end in events:
            start.record()
            fn()
            end.record()
        if events[0][0].query():
            raise RuntimeError("time_ms: the device caught up with the host "
                               "while runs were enqueued")
        torch.cuda.synchronize()
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
            timing = (ms, plain_ms)
            print(f"flash_fwd time at the prefill shape: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms (median of 25)")
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
            timing = (ms, plain_ms)
            print(f"flash_decode time at the decode shape: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms (median of 25)")
    return worst, timing


def check_bwd(gen):
    """Both backward paths against the plain fp32 backward on every case
    (the 2x rule, with autograd through attention_ref in the inputs' type
    as the low-precision reference); deterministic grads bitwise equal
    over two runs; kernel and plain times at the training shape."""
    from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.testing import (
        attention_ref_grads,
        check_against_ref,
    )

    worst = {"flash_bwd": 0.0, "flash_bwd_fused": 0.0}
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
            if det and timing is None:
                again = flash_bwd.flash_attention_bwd(
                    dot, qt, kt, vt, out, lse, causal=causal)
                same = all(torch.equal(a, b_) for a, b_ in zip(grads, again))
                require(same, "deterministic backward differs between runs")
                print(f"flash_bwd {case}: two deterministic runs bitwise equal")
        if timing is None:
            def bwd(det):
                return lambda: flash_bwd.flash_attention_bwd(
                    dot, qt, kt, vt, out, lse, causal=causal,
                    deterministic=det)
            ms = time_ms(bwd(True), runs=10)
            fused_ms = time_ms(bwd(False), runs=10)
            plain_ms = time_ms(lambda: flash_bwd.flash_attention_bwd_plain(
                dot, qt, kt, vt, out, lse, causal=causal), runs=10)
            timing = {"flash_bwd": (ms, plain_ms),
                      "flash_bwd_fused": (fused_ms, plain_ms)}
            print(f"backward time at the training shape ({case}): "
                  f"deterministic {ms:.4f} ms, fused {fused_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (median of 10)")
    return worst, timing


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
        flash_fwd.launches = 0
        flash_bwd.launches_dkdv = flash_bwd.launches_dq = 0
        flash_bwd.launches_fused = 0
        flash_attn_func(*leaves, causal=causal,
                        deterministic=det).backward(dout)
        torch.cuda.synchronize()
        got = {"flash_fwd": flash_fwd.launches,
               "fa_bwd_dkdv": flash_bwd.launches_dkdv,
               "fa_bwd_dq": flash_bwd.launches_dq,
               "flash_bwd_fused": flash_bwd.launches_fused}
        want = {"flash_fwd": 1, "fa_bwd_dkdv": int(det), "fa_bwd_dq": int(det),
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

    def wall(fn, runs):
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    prefill_only = served(PROMPT + 1)   # the prefill token, no decode step
    full = served(PROMPT + NEW_TOKENS)
    prefill_only()
    ttft = wall(prefill_only, 5)
    t_full = wall(full, 3)
    tok_s = BATCH * steps / (t_full - ttft)
    return launches, ttft, tok_s


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
        flash_fwd.launches = 0
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
            require(c == {"flash_fwd": n * (i + 1), "fa_bwd_dkdv": n * (i + 1),
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


def profile_step(trainer, loader):
    """Device time of one training step by kernel family (torch.profiler),
    and the phases of a step timed with CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    from flash_attn_tpu_torch.models.gpt import lm_head_weights
    from flash_attn_tpu_torch.ops.cross_entropy import (
        fused_linear_cross_entropy,
    )

    it = iter(loader)
    ids, labels = map(trainer._batch, next(it))
    trainer.train_step(ids, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(ids, labels)
        torch.cuda.synchronize()
    families = {"attention forward (flash_fwd)": ("fwd_kernel",),
                "attention backward (dkdv + dq)": ("dkdv_kernel", "dq_kernel"),
                "matmuls (cuBLAS)": ("gemm", "nvjet", "cutlass", "xmma"),
                "copies and casts": ("copy", "Memcpy", "Memset", "cast")}
    totals = dict.fromkeys(list(families) + ["elementwise, reductions, other"], 0.0)
    kernels = []
    for evt in prof.key_averages():
        dev = getattr(evt, "device_time_total", 0.0)
        if dev <= 0 or evt.key.startswith("ProfilerStep"):
            continue
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = next((f for f, keys in families.items()
                    if any(k.lower() in evt.key.lower() for k in keys)),
                   "elementwise, reductions, other")
        totals[fam] += dev
        kernels.append((dev, evt.count, evt.key))
    total = sum(totals.values())
    print(f"profile: one training step, {total / 1e3:.2f} ms of device time")
    for fam, us in totals.items():
        print(f"profile:   {fam}: {us / 1e3:.2f} ms ({100 * us / total:.1f}%)")
    for dev, count, key in sorted(kernels, reverse=True)[:12]:
        print(f"profile:   {dev / 1e3:8.2f} ms  x{count:<5d} {key[:90]}")

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
    fwd_err, (fwd_ms, fwd_plain_ms) = check_fwd(gen)
    dec_err, (dec_ms, dec_plain_ms) = check_decode(gen)
    bwd_err, bwd_timing = check_bwd(gen)
    api_launches = run_api_backward(gen)
    torch.cuda.empty_cache()
    launches, ttft, tok_s = run_slice(gen)
    print(f"time to first token (b={BATCH}, prompt {PROMPT}, median of 5): "
          f"{ttft * 1e3:.2f} ms; decode {tok_s:.1f} tokens/s at b={BATCH} "
          f"({NEW_TOKENS - 1} steps) on {card}")
    torch.cuda.empty_cache()
    train_launches, train = run_training()
    print(f"training step (median of steps {TRAIN_WARM + 1}-{TRAIN_STEPS}): "
          f"{train['step_ms']:.1f} ms; {train['tokens_per_s']:.0f} tokens/s; "
          f"{train['tflops_per_s']:.1f} TFLOP/s (model_flops_per_token); peak "
          f"memory {train['peak_gb']:.2f} GB (max_memory_allocated) on {card}")
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "flash_attn_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "flash_attn_tpu/kernels/flash_fwd.py:59",
         "launches": launches["flash_fwd"], "max_abs_err": fwd_err,
         "ms": fwd_ms, "plain_ms": fwd_plain_ms},
        {"name": "flash_decode", "route": "cuda",
         "source": "flash_attn_tpu_torch/csrc/flash_decode.cu",
         "replaces": "flash_attn_tpu/kernels/flash_decode.py:54",
         "launches": launches["flash_decode"], "max_abs_err": dec_err,
         "ms": dec_ms, "plain_ms": dec_plain_ms},
        {"name": "flash_bwd", "route": "cuda",
         "source": "flash_attn_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "flash_attn_tpu/kernels/flash_bwd.py:181",
         "launches": train_launches["fa_bwd_dkdv"]
         + train_launches["fa_bwd_dq"],
         "max_abs_err": bwd_err["flash_bwd"],
         "ms": bwd_timing["flash_bwd"][0],
         "plain_ms": bwd_timing["flash_bwd"][1]},
        {"name": "flash_bwd_fused", "route": "cuda",
         "source": "flash_attn_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "flash_attn_tpu/kernels/flash_bwd_fused.py:64",
         "launches": api_launches[False]["flash_bwd_fused"],
         "max_abs_err": bwd_err["flash_bwd_fused"],
         "ms": bwd_timing["flash_bwd_fused"][0],
         "plain_ms": bwd_timing["flash_bwd_fused"][1]},
    ]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
