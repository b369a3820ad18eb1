"""Device time of the two absorbed-MLA kernels, B8p (the paged chunked
prefill) and the MLA route of split-KV decode, for comparing trees of the
port on one card.

    python3 tools/mla_ab.py [--digests] ROOT [ROOT ...]

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit), in a fresh process each, it
builds that tree's kernels and runs them at DeepSeek-V3's absorbed widths
(128 heads on one KV head, d 64 + qv 512, scale 0.13523, bf16, causal, pages
of 64 in a shuffled pool). B8p: on every shape of chip_smoke.py's
MLA_PREFILL_CASES (from this script's own checkout, seeded the same way in
every process) it prints a SHA-256 of out and lse, and at the end whether
every tree gave the same bits; it times the serving chunk of chip_smoke.py
(8 chunks of 512 rows at the end of 2,048 keys) and 4 chunks of 256 over
1,280 keys against the plain fp32 version (max abs err). Decode: the split
partials at the default split count, at the serving phase's last step (8
rows of 2,080 keys), at lengths 1..2080 and at b=32 x 8192, against the
plain version's (max abs err). Each time is
the device ms a call (CUDA events over a held stream, median of 10), taken
twice. Give the roots in turns (A B B A) to compare two trees on the card
they share. The decode route's partials at each decode shape get a digest
too; with ``--digests`` it prints the digests alone and times nothing.
"""

import hashlib
import importlib.util
import math
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

H, D, DV, PAGE = 128, 64, 512, 64
SCALE = (0.1 * math.log(40.0) + 1.0) ** 2 / math.sqrt(128 + 64)
CASES = [  # (name, chunk rows a sequence, sequences, keys before the chunk)
    ("serving chunk, 8 x 512 over 2,048 keys", 512, 8, 1536),
    ("4 x 256 over 1,280 keys", 256, 4, 1024),
]
DECODE = [  # (name, keys of each batch row)
    ("decode, serving step, 8 x 2,080 keys", [2080] * 8),
    ("decode, lengths 1..2080", np.linspace(1, 2080, 8).round().astype(int)
     .tolist()),
    ("decode, b=32 x 8192", [8192] * 32),
]
SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"


def time_ms(fn, runs: int = 10, batch: int = 5) -> float:
    """Median device ms of fn(): a sleep kernel holds the stream while a
    batch of runs is enqueued, so that the events time the device."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < runs:
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(batch)]
        torch.cuda._sleep(100_000_000)
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        times += [s.elapsed_time(e) for s, e in events]
    return statistics.median(times)


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(root: str, timed: bool = True) -> None:
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, root)
    from flash_attn_tpu_torch.cache.kvcache import _default_num_splits
    from flash_attn_tpu_torch.kernels import _build, flash_decode
    from flash_attn_tpu_torch.kernels import flash_paged_prefill as fpp

    print(f"package {fpp.__file__}")
    _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, lens_q, cached, h, h_k, d, dv, page, dtype, causal in \
            smoke.MLA_PREFILL_CASES:
        lens_k = [c + n for c, n in zip(cached, lens_q)]
        cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                          dtype=torch.int32, device="cuda")
        q, qv = (torch.randn(int(cu[-1]), h, w, device="cuda", generator=gen)
                 .to(dtype) for w in (d, dv))
        kp, vp, table = smoke.paged_cache(gen, len(lens_q), h_k, d, page,
                                          max(lens_k), dtype, dv)
        seqlens = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
        out, lse = fpp.flash_attention_paged_prefill_varlen(
            q, kp, vp, cu, max(lens_q), seqlens, table, qv=qv,
            softmax_scale=smoke.MLA_SCALE, causal=causal)
        print(f"B8p digest {name}: {digest(out, lse)}", flush=True)
    calls = []
    for name, rows, b, cached in CASES if timed else ():
        keys = cached + rows
        width = -(-keys // PAGE)
        table = torch.randperm(b * width, device="cuda", generator=gen) \
            .reshape(b, width).to(torch.int32)
        kp, vp = (torch.randn(b * width, 1, PAGE, w, device="cuda",
                              generator=gen).to(torch.bfloat16)
                  for w in (D, DV))
        q, qv = (torch.randn(b * rows, H, w, device="cuda", generator=gen)
                 .to(torch.bfloat16) for w in (D, DV))
        cu = torch.arange(b + 1, dtype=torch.int32, device="cuda") * rows
        seqlens = torch.full((b,), keys, dtype=torch.int32, device="cuda")
        args = (q, kp, vp, cu, rows, seqlens, table)
        kw = dict(qv=qv, softmax_scale=SCALE, causal=True)
        out, _ = fpp.flash_attention_paged_prefill_varlen(*args, **kw)
        ref, _ = fpp.flash_attention_paged_prefill_varlen_plain(
            q.float(), kp.float(), vp.float(), cu, rows, seqlens, table,
            qv=qv.float(), softmax_scale=SCALE, causal=True)
        err = float((out.float() - ref).abs().max())
        del ref
        calls.append((f"B8p {name} (max abs err {err:.3e})",
                      lambda a=args, k=kw:
                      fpp.flash_attention_paged_prefill_varlen(*a, **k)))
    for name, keys in DECODE:
        b = len(keys)
        kc, vc, table = smoke.paged_cache(gen, b, 1, D, PAGE, max(keys),
                                          torch.bfloat16, DV)
        q, qv = (torch.randn(b, 1, H, w, device="cuda", generator=gen)
                 .to(torch.bfloat16) for w in (D, DV))
        seqlens = torch.tensor(keys, dtype=torch.int32, device="cuda")
        splits = _default_num_splits(q, kc, vc, table, True)
        splits = max(1, min(splits, -(-flash_decode.cache_capacity(kc, table)
                                      // 64)))
        out_p, lse_p = flash_decode.flash_attention_decode_partials(
            q, kc, vc, seqlens, splits, SCALE, True, block_table=table, qv=qv)
        print(f"B8p digest {name}: {digest(out_p, lse_p)}", flush=True)
        if not timed:
            continue
        ref_p, _ = flash_decode.flash_attention_decode_paged_partials_plain(
            q, kc, vc, seqlens, table, splits, 64, SCALE, True, qv=qv)
        err = float((out_p - ref_p).abs().max())
        del out_p, ref_p
        calls.append((f"{name} ({splits} splits, max abs err {err:.3e})",
                      lambda a=(q, kc, vc, seqlens, splits, SCALE, True),
                      t=table, qv=qv:
                      flash_decode.flash_attention_decode_partials(
                          *a, block_table=t, qv=qv)))
    for _ in range(2 if timed else 0):
        for name, fn in calls:
            print(f"{name}: {time_ms(fn):.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("mla_ab: needs a CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] in (["--one"], ["--one-digests"]):
        measure(args[1], timed=args[0] == "--one")
        return 0
    mode = "--one"
    if args[:1] == ["--digests"]:
        mode, args = "--one-digests", args[1:]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    digests = {}
    for root in args:
        print(f"== {root}", flush=True)
        run = subprocess.run([sys.executable, __file__, mode, root],
                             stdout=subprocess.PIPE, text=True)
        print(run.stdout, end="", flush=True)
        if run.returncode:
            return run.returncode
        for line in run.stdout.splitlines():
            if line.startswith("B8p digest "):
                name, value = line[len("B8p digest "):].rsplit(": ", 1)
                digests.setdefault(name, set()).add(value)
    for name, values in digests.items():
        same = len(values) == 1
        print(f"{name}: "
              f"{'the same bits in every tree' if same else 'DIFFERENT bits'}")
    return 0 if all(len(v) == 1 for v in digests.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
