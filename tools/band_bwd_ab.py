"""Device time of the dense backward's band instantiations (B3 with a band)
against its band-free kernels at Mistral-7B's training shape, for comparing
trees of the port on one card.

    python3 tools/band_bwd_ab.py ROOT [ROOT ...]

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit, or a variant of the band tiles),
in a fresh process each, it builds that tree's kernels and, on one sequence
of 8192 tokens at 32 query heads on 8 KV heads of 128 (bf16, causal, seeded
the same in every tree), times three backward calls twice over, each by the
profiler a kernel at a time (preprocess, dK/dV, dQ) and as a whole call
(CUDA events):

  - "free": the band-free kernels (no window);
  - "band-causal": the band instantiations over the causal band alone
    (``has_band`` forced true with no window: the same tiles as "free", so
    the difference is what the band's code costs a tile);
  - "window": the band instantiations under Mistral-7B's window (4095, 0),
    which keeps 0.750 of the causal pairs.

Give the roots in turns (A B B A) to compare two trees on the card they
share.
"""

import os
import subprocess
import sys

SHAPE = (1, 8192, 32, 8, 128)  # b, s, h, h_k, d
NAMES = ["preprocess_kernel", "dkdv_kernel", "dq_kernel"]


def measure(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    import chip_smoke
    import flash_attn_tpu_torch
    from flash_attn_tpu_torch.kernels import _build, flash_bwd, flash_fwd

    here = os.path.dirname(flash_attn_tpu_torch.__file__)
    if not here.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {here}, not {root}'s package")
    _build.build()
    _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, h_k, d = SHAPE
    q, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
             .bfloat16().transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(b, s, h_k, d, device="cuda", generator=gen)
            .bfloat16().transpose(1, 2) for _ in range(2))
    has_band = flash_bwd.has_band
    for _ in range(2):
        for label, window, force in (("free", (None, None), False),
                                     ("band-causal", (None, None), True),
                                     ("window", (4095, 0), False)):
            out, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=True,
                                                     window_size=window)
            flash_bwd.has_band = (lambda *a: True) if force else has_band

            def call():
                return flash_bwd.flash_attention_bwd(
                    do, q, k, v, out, lse, causal=True, window_size=window)
            before = flash_bwd.launches_dkdv_band
            split = chip_smoke.kernel_split_ms(call, NAMES, runs=5)
            ms = chip_smoke.time_ms(call, runs=10)
            band = flash_bwd.launches_dkdv_band > before
            flash_bwd.has_band = has_band
            print(f"{root} {label:12s} band kernels {band}: {ms:.4f} ms a "
                  f"call; " + ", ".join(f"{n} {x:.4f}"
                                        for n, x in split.items()),
                  flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        measure(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("band_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for root in sys.argv[1:]:
        run = subprocess.run([sys.executable, __file__, "--one", root])
        if run.returncode:
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
