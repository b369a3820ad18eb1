"""Device time of the paged varlen prefill (B8), for comparing trees of the
port on one card.

    python3 tools/paged_ab.py [--digests] ROOT [ROOT ...]

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit), in a fresh process each, it
builds that tree's kernels and runs ``flash_attention_varlen_paged_fwd`` on
the B8 shapes of chip_smoke.py (``VARLEN_CASES`` of this script's own
checkout's ``flash_attn_tpu_torch/utils/cases.py``, seeded the same way in
every process): the prefix-cached admission (8 chunks of 256 rows over 512
keys, 16 heads of 128, pages of 256, causal, bf16) and the ragged case. For
each it prints the max abs error against the plain fp32 version, the whole
call's device ms (CUDA events over a held stream, median of 25) and the
kernel's alone (torch.profiler, device time a call over 10 calls), with
chip_smoke.py's own timers, twice. Give the roots in turns (A B B A) to
compare two trees on the card they share. Every tree also prints a SHA-256
of B8's out and lse on every VARLEN_CASES shape, with no learnable sink,
and at the end whether every tree gave the same bits (exit 1 if not); with
``--digests`` it prints the digests alone and times nothing.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SMOKE = ROOT / "chip_smoke.py"
CASES = ROOT / "flash_attn_tpu_torch" / "utils" / "cases.py"
TIMED = ("prefix admission", "ragged")


def load(name: str, path: Path):
    """The module at ``path``, loaded without importing any package."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def measure(root: str, timed: bool = True) -> None:
    smoke = load("chip_smoke", SMOKE)
    cases = load("cases", CASES)
    ab = load("fwd_ab", ROOT / "tools" / "fwd_ab.py")
    sys.path.insert(0, root)
    from flash_attn_tpu_torch.kernels import _build
    from flash_attn_tpu_torch.kernels import flash_varlen_paged as fvp

    print(f"package {fvp.__file__}")
    _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = []
    for name, lens_q, lens_k, used, h, h_k, d, page, dtype, causal in \
            cases.VARLEN_CASES:
        cu = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                          dtype=torch.int32, device="cuda")
        q = torch.randn(int(cu[-1]), h, d, device="cuda", generator=gen).to(
            dtype)
        kp, vp, table = smoke.paged_cache(gen, len(lens_q), h_k, d, page,
                                          max(max(lens_k), 1), dtype)
        seqlens = torch.tensor(lens_k, dtype=torch.int32, device="cuda")
        args = (q, kp, vp, cu, max(max(lens_q), 1), seqlens, table)
        used = None if used is None else torch.tensor(
            used, dtype=torch.int32, device="cuda")
        out, lse = fvp.flash_attention_varlen_paged_fwd(
            *args, seqused_q=used, causal=causal)
        print(f"digest B8 {name}: {ab.digest(out, lse)}", flush=True)
        if name not in TIMED or not timed:
            continue
        ref, _ = fvp.flash_attention_varlen_paged_fwd_plain(
            q.float(), kp.float(), vp.float(), *args[3:], causal=causal)
        err = float((out.float() - ref.float()).abs().max())
        del ref
        calls.append((f"B8 {name} (max abs err {err:.3e})",
                      lambda a=args, c=causal:
                      fvp.flash_attention_varlen_paged_fwd(*a, causal=c)))
    for _ in range(2 if timed else 0):
        for name, fn in calls:
            kernel = smoke.kernel_split_ms(fn, ("varlen_paged_kernel",))
            print(f"{name}: whole call {smoke.time_ms(fn):.4f} ms, kernel "
                  f"{kernel['varlen_paged_kernel']:.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_ab: needs a CUDA card", file=sys.stderr)
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
    return load("fwd_ab", ROOT / "tools" / "fwd_ab.py").same_digests(runs)


if __name__ == "__main__":
    sys.exit(main())
