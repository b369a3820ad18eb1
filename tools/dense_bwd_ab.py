"""Device time and bits of the dense attention backward's kernels, for
comparing trees of the port on one card.

    python3 tools/dense_bwd_ab.py ROOT [ROOT ...]

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit), in a fresh process each, it
builds that tree's kernels and prints a SHA-256 of B3's dq, dk, dv and of
B2's dk, dv (its dq is summed by reductions whose order varies) on every
shape of chip_smoke.py's BWD_CASES (from this script's own checkout, the
inputs seeded the same way in every process, out and lse from the plain
fp32 forward); then it checks both backward paths against the plain fp32
backward at the training shape (b=4 x 2048, h=16, d=128, causal, bf16) and
prints the device ms a call of every kernel that each path launches
(torch.profiler over 10 calls), twice. At the end it says whether every
tree gave the same bits (exit 1 if not). Give the roots in turns (A B B A)
to compare two trees on the card they share.
"""

import hashlib
import importlib.util
import subprocess
import sys

from pathlib import Path

import torch

SHAPE = (4, 2048, 16, 128)  # b, s, h, d
RUNS = 10
SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, root)
    from flash_attn_tpu_torch.kernels import _build, flash_bwd, flash_fwd

    print(f"package {flash_bwd.__file__}")
    _build.load_library()
    for i, (b, sq, sk, h, h_k, d, causal, dtype) in enumerate(smoke.BWD_CASES):
        gen = torch.Generator(device="cuda").manual_seed(i)
        q, do = (torch.randn(b, sq, h, d, device="cuda", generator=gen)
                 .to(dtype).transpose(1, 2) for _ in range(2))
        k, v = (torch.randn(b, sk, h_k, d, device="cuda", generator=gen)
                .to(dtype).transpose(1, 2) for _ in range(2))
        out, lse = flash_fwd.flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), causal=causal)
        out = out.to(dtype).transpose(1, 2).contiguous().transpose(1, 2)
        case = f"{(b, sq, sk, h, h_k, d, causal, str(dtype)[6:])}"
        b3 = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse,
                                           causal=causal, deterministic=True)
        b2 = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse,
                                           causal=causal, deterministic=False)
        print(f"digest B3 {case}: {digest(*b3)}", flush=True)
        print(f"digest B2 dK/dV {case}: {digest(*b2[1:])}", flush=True)
        del q, k, v, do, out, lse, b3, b2
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
    digests = {}
    for root in sys.argv[1:]:
        print(f"== {root}", flush=True)
        run = subprocess.run([sys.executable, __file__, "--one", root],
                             stdout=subprocess.PIPE, text=True)
        print(run.stdout, end="", flush=True)
        if run.returncode:
            return run.returncode
        for line in run.stdout.splitlines():
            if line.startswith("digest "):
                name, value = line[len("digest "):].rsplit(": ", 1)
                digests.setdefault(name, set()).add(value)
    for name, values in digests.items():
        print(f"{name}: {'the same bits in every tree' if len(values) == 1 else 'DIFFERENT bits'}")
    return 0 if all(len(v) == 1 for v in digests.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
