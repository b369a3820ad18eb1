"""Device time of the dense attention backward's kernels, for comparing two
trees of the port on one card.

    python3 tools/dense_bwd_ab.py ROOT [ROOT ...]

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit), in a fresh process each, it
builds that tree's kernels, checks both backward paths against the plain
fp32 backward at the training shape (b=4 x 2048, h=16, d=128, causal,
bf16) and prints the device ms a call of every kernel that each path
launches (torch.profiler over 10 calls), twice. Give the roots in turns
(A B B A) to compare two trees on the card they share.
"""

import subprocess
import sys

import torch

SHAPE = (4, 2048, 16, 128)  # b, s, h, d
RUNS = 10


def kernel_ms(fn, runs: int = RUNS) -> dict:
    """Device ms a call of each kernel fn() launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / runs / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0}


def measure(root: str) -> None:
    sys.path.insert(0, root)
    from flash_attn_tpu_torch.kernels import _build, flash_bwd, flash_fwd

    print(f"package {flash_bwd.__file__}")
    _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, d = SHAPE
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=True)
    ref = flash_bwd.flash_attention_bwd_plain(
        do.float(), q.float(), k.float(), v.float(), out.float(), lse,
        causal=True)
    for det in (True, False):
        got = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse,
                                            causal=True, deterministic=det)
        errs = [float((g.float() - r).abs().max()) for g, r in zip(got, ref)]
        print(f"deterministic={det}: max abs err dq, dk, dv {errs}")
    for _ in range(2):
        for det in (True, False):
            t = kernel_ms(lambda: flash_bwd.flash_attention_bwd(
                do, q, k, v, out, lse, causal=True, deterministic=det))
            print(f"deterministic={det}: {sum(t.values()):.4f} ms of device "
                  f"time; " + ", ".join(f"{n} {v:.4f}" for n, v in t.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("dense_bwd_ab: needs a CUDA card", file=sys.stderr)
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
