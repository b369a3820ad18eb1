"""Device time of the MLA paged chunked prefill (B8p), for comparing trees
of the port on one card.

    python3 tools/mla_ab.py ROOT [ROOT ...]

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit), in a fresh process each, it
builds that tree's kernels and runs ``flash_attention_paged_prefill_varlen``
at DeepSeek-V3's absorbed widths (128 heads on one KV head, d 64 + qv 512,
scale 0.13523, bf16, causal, pages of 64 in a shuffled pool): the serving
chunk of chip_smoke.py (8 chunks of 512 rows at the end of 2,048 keys) and
4 chunks of 256 over 1,280 keys. It checks each against the plain fp32
version (max abs err) and prints the device ms a call (CUDA events over a
held stream, median of 10), twice. Give the roots in turns (A B B A) to
compare two trees on the card they share.
"""

import math
import statistics
import subprocess
import sys

import torch

H, D, DV, PAGE = 128, 64, 512, 64
SCALE = (0.1 * math.log(40.0) + 1.0) ** 2 / math.sqrt(128 + 64)
CASES = [  # (name, chunk rows a sequence, sequences, keys before the chunk)
    ("serving chunk, 8 x 512 over 2,048 keys", 512, 8, 1536),
    ("4 x 256 over 1,280 keys", 256, 4, 1024),
]


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


def measure(root: str) -> None:
    sys.path.insert(0, root)
    from flash_attn_tpu_torch.kernels import _build
    from flash_attn_tpu_torch.kernels import flash_paged_prefill as fpp

    print(f"package {fpp.__file__}")
    _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = []
    for name, rows, b, cached in CASES:
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
        calls.append((f"{name} (max abs err {err:.3e})",
                      lambda a=args, k=kw:
                      fpp.flash_attention_paged_prefill_varlen(*a, **k)))
    for _ in range(2):
        for name, fn in calls:
            print(f"B8p {name}: {time_ms(fn):.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("mla_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        measure(sys.argv[2])
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for root in sys.argv[1:]:
        print(f"== {root}", flush=True)
        rc = subprocess.run([sys.executable, __file__, "--one", root]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
