"""Device time of the attention forward kernels (B1, B6's forward and B7),
for comparing trees of the port on one card.

    python3 tools/fwd_ab.py [--digests] ROOT [ROOT ...]

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit), in a fresh process each, it
builds that tree's kernels, checks B1 against the plain fp32 forward at the
static prefill's shape (b=8 x 512) and the training shape (b=4 x 2048), both
h=16, d=128, causal, bf16, and prints the device ms a call (CUDA events over
a held stream, median of 25) beside scaled_dot_product_attention. Then, at
BERT-large's packing (32 sequences of U[256, 512], seed 5, 16 heads of 64,
not causal, the packed tail of 32 x 512 rows) and bench.py's mixed lengths
(16 causal sequences of U[2048, 4096], seed 0, 16 heads of 128), it times
B6's forward (one block per item) and B7 (the persistent walk over the same
list, built beforehand by get_scheduler_metadata), and prints max |B6 - B7|.
Each round runs twice. Give the roots in turns (A B B A) to compare two
trees on the card they share; a variant of a kernel (another Q buffering of
B7, say) is timed as a tree of its own. Every tree also prints a SHA-256 of
each kernel's out and lse on each shape (and of B10's over the full causal
block mask at the training shape, chip_smoke.py's
blocksparse_full_mask_forward), none of them with a learnable sink, and at
the end whether every tree gave the same bits (exit 1 if not); with
``--digests`` it prints the digests alone and times nothing.
"""

import hashlib
import importlib.util
import inspect
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

DENSE = [(8, 512), (4, 2048)]  # (b, s) at h=16, d=128, causal
H, D = 16, 128
MIXED = [int(x) for x in np.random.default_rng(0).integers(2048, 4097, 16)]
SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def same_digests(runs) -> int:
    """Print, for each "digest NAME: VALUE" line of the trees' ``runs``
    (their standard outputs), whether every tree gave the same bits;
    returns the exit code: 1 if any differ."""
    digests = {}
    for out in runs:
        for line in out.splitlines():
            if line.startswith("digest "):
                name, value = line[len("digest "):].rsplit(": ", 1)
                digests.setdefault(name, set()).add(value)
    for name, values in digests.items():
        print(f"{name}: " + ("the same bits in every tree" if len(values) == 1
                             else "DIFFERENT bits"))
    return 0 if all(len(v) == 1 for v in digests.values()) else 1


def time_ms(fn, runs: int = 25, batch: int = 5) -> float:
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


VARLEN = [  # (name, lengths, packed tail rows, h, d, causal)
    ("BERT-large packing",
     [int(x) for x in np.random.default_rng(5).integers(256, 513, 32)],
     None, 16, 64, False),
    ("bench.py mixed", MIXED, 0, 16, 128, True),
]


def measure(root: str, timed: bool = True) -> None:
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, root)
    from flash_attn_tpu_torch import get_scheduler_metadata
    from flash_attn_tpu_torch.dispatch.varlen_meta import compute_varlen_meta
    from flash_attn_tpu_torch.kernels import _build, flash_fwd, flash_varlen
    from flash_attn_tpu_torch.kernels import flash_varlen_persistent as fvp

    print(f"package {flash_fwd.__file__}")
    _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for b, s in DENSE:
        q, k, v = (torch.randn(b, s, H, D, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=True)
        print(f"digest B1 b={b} x {s}: {digest(out, lse)}", flush=True)
        if (b, s) == DENSE[-1]:
            print(f"digest B10 full causal mask b={b} x {s}: "
                  f"{digest(*smoke.blocksparse_full_mask_forward(qt, kt, vt, True))}",
                  flush=True)
        if not timed:
            continue
        ref, _ = flash_fwd.flash_attention_fwd_plain(
            qt.float(), kt.float(), vt.float(), causal=True)
        err = float((out.float() - ref).abs().max())
        cases.append((f"B1 b={b} x {s} (max abs err {err:.3e})", {
            "B1": lambda qt=qt, kt=kt, vt=vt: flash_fwd.flash_attention_fwd(
                qt, kt, vt, causal=True),
            "SDPA": lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)}))
    for name, lens, tail, h, d, causal in VARLEN:
        tail = len(lens) * 512 - sum(lens) if tail is None else tail
        cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                          dtype=torch.int32, device="cuda")
        n, mx = sum(lens) + tail, max(lens)
        q, k, v = (torch.randn(n, h, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        # the work lists built once, as BERT's encoder builds them; a tree
        # whose B7 walked 64-row tiles takes B6's 128-row list apart
        meta = get_scheduler_metadata(len(lens), mx, mx, h, h, d,
                                      cu_seqlens_q=cu, cu_seqlens_k=cu,
                                      causal=causal).meta
        meta6 = meta if "schedule_block_q" in inspect.signature(
            compute_varlen_meta).parameters else compute_varlen_meta(
                cu, cu, mx, mx, n, n, causal=causal, block_q=128, block_k=64)
        args = (q, k, v, cu, cu, mx, mx)
        b6 = flash_varlen.flash_attention_varlen_fwd(*args, causal=causal,
                                                     meta=meta6)
        b7 = fvp.flash_attention_varlen_fwd_persistent(*args, causal=causal,
                                                       meta=meta)
        print(f"digest B6 {name}: {digest(*b6)}", flush=True)
        print(f"digest B7 {name}: {digest(*b7)}", flush=True)
        diff = float((b6[0].float() - b7[0].float()).abs().max())
        fns = {"B6": lambda a=args, c=causal, m=meta6:
               flash_varlen.flash_attention_varlen_fwd(*a, causal=c, meta=m),
               "B7": lambda a=args, c=causal, m=meta:
               fvp.flash_attention_varlen_fwd_persistent(*a, causal=c, meta=m)}
        cases.append((f"{name} (max |B6 - B7| {diff:.3e}, B7 grid "
                      f"{fvp.last_grid})", fns))
    for _ in range(2 if timed else 0):
        for name, fns in cases:
            times = ", ".join(f"{k} {time_ms(fn):.4f}" for k, fn in fns.items())
            print(f"{name}: {times} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_ab: needs a CUDA card", file=sys.stderr)
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
    runs = []
    for root in args:
        print(f"== {root}", flush=True)
        run = subprocess.run([sys.executable, __file__, mode, root],
                             stdout=subprocess.PIPE, text=True)
        print(run.stdout, end="", flush=True)
        if run.returncode:
            return run.returncode
        runs.append(run.stdout)
    return same_digests(runs)


if __name__ == "__main__":
    sys.exit(main())
