"""Device time of the attention forward kernels (B1 and B6's forward), for
comparing trees of the port on one card.

    python3 tools/fwd_ab.py ROOT [ROOT ...]

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit), in a fresh process each, it
builds that tree's kernels, checks B1 against the plain fp32 forward at the
static prefill's shape (b=8 x 512) and the training shape (b=4 x 2048), both
h=16, d=128, causal, bf16, and B6's forward at bench.py's mixed lengths (16
causal sequences of U[2048, 4096], seed 0), then prints the device ms a
call of each (CUDA events over a held stream, median of 25) beside B7 over
the same rows packed (the mma.sync tile of fwd_tile.cuh) and
scaled_dot_product_attention, twice. Give the roots in turns (A B B A) to
compare two trees on the card they share.
"""

import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

DENSE = [(8, 512), (4, 2048)]  # (b, s) at h=16, d=128, causal
H, D = 16, 128
MIXED = [int(x) for x in np.random.default_rng(0).integers(2048, 4097, 16)]


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


def measure(root: str) -> None:
    sys.path.insert(0, root)
    from flash_attn_tpu_torch.dispatch.config import FWD_TILE
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
        out, _ = flash_fwd.flash_attention_fwd(qt, kt, vt, causal=True)
        ref, _ = flash_fwd.flash_attention_fwd_plain(
            qt.float(), kt.float(), vt.float(), causal=True)
        err = float((out.float() - ref).abs().max())
        cu = torch.arange(b + 1, dtype=torch.int32, device="cuda") * s
        packed = [x.reshape(b * s, H, D) for x in (q, k, v)]
        meta = compute_varlen_meta(cu, cu, s, s, b * s, b * s, causal=True)
        cases.append((f"B1 b={b} x {s}", err,
                      lambda qt=qt, kt=kt, vt=vt: flash_fwd.flash_attention_fwd(
                          qt, kt, vt, causal=True),
                      lambda p=packed, cu=cu, s=s, m=meta:
                      fvp.flash_attention_varlen_fwd_persistent(
                          *p, cu, cu, s, s, causal=True, meta=m),
                      lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(
                          qt, kt, vt, is_causal=True)))
    cu = torch.tensor(np.concatenate([[0], np.cumsum(MIXED)]),
                      dtype=torch.int32, device="cuda")
    n, mx = sum(MIXED), max(MIXED)
    q, k, v = (torch.randn(n, H, D, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    meta128 = compute_varlen_meta(cu, cu, mx, mx, n, n, causal=True,
                                  block_q=FWD_TILE.block_q,
                                  block_k=FWD_TILE.block_k)
    meta64 = compute_varlen_meta(cu, cu, mx, mx, n, n, causal=True)
    out, _ = flash_varlen.flash_attention_varlen_fwd(
        q, k, v, cu, cu, mx, mx, causal=True, meta=meta128)
    ref, _ = fvp.flash_attention_varlen_fwd_persistent(
        q, k, v, cu, cu, mx, mx, causal=True, meta=meta64)
    cases.append(("B6 forward, bench.py mixed",
                  float((out.float() - ref.float()).abs().max()),
                  lambda: flash_varlen.flash_attention_varlen_fwd(
                      q, k, v, cu, cu, mx, mx, causal=True, meta=meta128),
                  lambda: fvp.flash_attention_varlen_fwd_persistent(
                      q, k, v, cu, cu, mx, mx, causal=True, meta=meta64),
                  None))
    for _ in range(2):
        for name, err, kernel, previous, sdpa in cases:
            t = [time_ms(kernel), time_ms(previous)]
            lib = f", SDPA {time_ms(sdpa):.4f}" if sdpa else ""
            print(f"{name}: kernel {t[0]:.4f} ms, B7 packed {t[1]:.4f}{lib} "
                  f"(max abs err {err:.3e})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_ab: needs a CUDA card", file=sys.stderr)
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
