"""Smoke run of the PyTorch + CUDA port (flash_attn_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. builds the CUDA kernels from flash_attn_tpu_torch/csrc with nvcc
   (sm_90a) and prints the build time;
2. holds each kernel against its plain PyTorch version at the shapes of the
   serving path (the repo's 2x rule against an fp32 reference for out, an
   absolute bound for lse), and times both with CUDA events;
3. serves 8 seeded 512-token prompts with the flagship 913M GPT (random
   weights from a seed, bf16) through serving.generation.decode for 32 new
   tokens, checks that the kernels carried it (launch counts), that the
   logits are finite and that the decode steps agree with one teacher-forced
   forward; then times the first token and the decode rate.

It prints the card's name and power limit, one JSON line with the kernels'
launches, errors and times, and as its last line
{"ok": true, "device": {...}}. It needs a CUDA card and exits non-zero
without one, and when run outside a checkout of the repo.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

FWD_CASES = [  # (b, sq, sk, h, h_k, d, causal); the first is the prefill's
    (8, 512, 512, 16, 16, 128, True),
    (8, 512, 512, 16, 4, 128, True),
    (8, 512, 512, 16, 16, 128, False),
    (8, 256, 512, 16, 16, 128, True),
]
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
    launches, ttft, tok_s = run_slice(gen)
    print(f"time to first token (b={BATCH}, prompt {PROMPT}, median of 5): "
          f"{ttft * 1e3:.2f} ms; decode {tok_s:.1f} tokens/s at b={BATCH} "
          f"({NEW_TOKENS - 1} steps) on {card}")
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
    ]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
