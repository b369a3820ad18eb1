"""Device time of the packed-varlen backward (B6), for comparing trees of
the port on one card.

    python3 tools/varlen_bwd_ab.py ROOT [ROOT ...]

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit), in a fresh process each, it
builds that tree's kernels and runs ``flash_attention_varlen_bwd`` at the
two shapes of chip_smoke.py's varlen checks (from this script's own
checkout, seeded the same way in every process): BERT-large's packing (32
sequences of 256-512 rows padded to 512, h=16, d=64, not causal) and
bench.py's mixed lengths (16 sequences uniform in [2048, 4096], h=16,
d=128, causal), bf16, on residuals of B6's forward. For each it prints the
max abs error of dq, dk, dv against the plain fp32 backward, the whole
call's device ms (CUDA events over a held stream, median of 25) and each
kernel's alone (torch.profiler, device time a call over 10 calls; the torch
ops around them under "other"), with chip_smoke.py's own timers, twice.
Give the roots in turns (A B B A) to compare two trees on the card they
share.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"
KERNELS = ("varlen_preprocess_kernel", "varlen_dkdv_kernel",
           "varlen_dq_kernel")


def measure(root: str) -> None:
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, root)
    from flash_attn_tpu_torch.kernels import _build, flash_varlen

    print(f"package {flash_varlen.__file__}")
    _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [("BERT-large packing", smoke.BERT_LENS,
               smoke.BERT_BATCH * smoke.BERT_SEQ - sum(smoke.BERT_LENS), 64,
               False),
              ("bench.py mixed", smoke.BENCH_MIXED_LENS, 0, 128, True)]
    calls = []
    for name, lens, tail, d, causal in shapes:
        h = 16
        cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                          dtype=torch.int32, device="cuda")
        q, k, v, do = (torch.randn(sum(lens) + tail, h, d, device="cuda",
                                   generator=gen).to(torch.bfloat16)
                       for _ in range(4))
        args = (cu, cu, max(lens), max(lens))
        out, lse = flash_varlen.flash_attention_varlen_fwd(q, k, v, *args,
                                                           causal=causal)
        got = flash_varlen.flash_attention_varlen_bwd(do, q, k, v, out, lse,
                                                      *args, causal=causal)
        ref = flash_varlen.flash_attention_varlen_bwd_plain(
            do.float(), q.float(), k.float(), v.float(), out.float(), lse,
            *args, causal=causal)
        errs = [float((g.float() - r).abs().max()) for g, r in zip(got, ref)]
        del got, ref
        calls.append((f"B6 backward, {name} (max abs err dq, dk, dv "
                      + ", ".join(f"{e:.3e}" for e in errs) + ")",
                      lambda a=(do, q, k, v, out, lse, *args), c=causal:
                      flash_varlen.flash_attention_varlen_bwd(*a, causal=c)))
    for _ in range(2):
        for name, fn in calls:
            split = smoke.kernel_split_ms(fn, KERNELS)
            print(f"{name}: whole call {smoke.time_ms(fn, runs=10):.4f} ms; "
                  + ", ".join(f"{n} {t:.4f}" for n, t in split.items()),
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("varlen_bwd_ab: needs a CUDA card", file=sys.stderr)
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
