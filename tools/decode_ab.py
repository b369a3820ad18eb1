"""Device time of the d = dv decode route (B4), for comparing trees of the
port on one card.

    python3 tools/decode_ab.py ROOT [ROOT ...]

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit), in a fresh process each, it
builds that tree's kernels and runs ``flash_attention_decode_partials`` at
the first shapes of chip_smoke.py's DEC_CASES and PAGED_DEC_CASES (from
this script's own checkout, seeded the same way in every process): static
serving's decode step (b=8, 16 heads of 128, a linear cache of 640, lengths
1..600, one split) and the engine's (64 slots, pages of 256, lengths
1..560, one split), bf16, causal. For each it prints the max abs error of
the split partials against the plain version and their device ms (CUDA
events over a held stream, median of 25, chip_smoke.py's timer), twice. In
a tree whose wrapper picks a thread-block cluster (dispatch/config.py
decode_cluster) it also times each shape at every cluster size the kernel
takes. Give the roots in turns (A B B A) to compare two trees on the card
they share.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"


def measure(root: str) -> None:
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, root)
    from flash_attn_tpu_torch.kernels import _build, flash_decode

    print(f"package {flash_decode.__file__}")
    _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = []
    b, h, h_k, d, s_max, splits = smoke.DEC_CASES[0]
    q = torch.randn(b, 1, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    kc, vc = (torch.randn(b, h_k, s_max, d, device="cuda", generator=gen)
              .to(torch.bfloat16) for _ in range(2))
    lens = torch.linspace(1, 600, b, device="cuda").round().to(torch.int32)
    calls.append(("linear, b=8 x lengths 1..600", (q, kc, vc, lens, splits),
                  {}, lambda: flash_decode.flash_attention_decode_partials_plain(
                      q, kc, vc, lens, splits, 64, d ** -0.5, True)))
    b, h, h_k, d, page, max_len, splits = smoke.PAGED_DEC_CASES[0]
    kp, vp, table = smoke.paged_cache(gen, b, h_k, d, page, max_len,
                                      torch.bfloat16)
    qp = torch.randn(b, 1, h, d, device="cuda", generator=gen).to(
        torch.bfloat16)
    plens = torch.linspace(1, max_len, b, device="cuda").round().to(torch.int32)
    calls.append(("paged, 64 slots x lengths 1..560, pages of 256",
                  (qp, kp, vp, plens, splits), {"block_table": table},
                  lambda: flash_decode.flash_attention_decode_paged_partials_plain(
                      qp, kp, vp, plens, table, splits, 64, d ** -0.5, True)))
    clusters = [None]
    if hasattr(flash_decode, "decode_cluster"):
        clusters += [1, 2, 4]
    pick = getattr(flash_decode, "decode_cluster", None)
    timed = []
    for name, args, kw, plain in calls:
        ref_p, _ = plain()
        for c in clusters:
            if c is not None:
                flash_decode.decode_cluster = lambda blocks, sms, c=c: c
            out_p, _ = flash_decode.flash_attention_decode_partials(
                *args, d ** -0.5, True, **kw)
            err = float((out_p - ref_p).abs().max())
            label = f"{name}, " + ("the wrapper's cluster" if c is None
                                   else f"clusters of {c}")
            timed.append((f"{label} (max abs err {err:.3e})", c,
                          lambda a=args, k=kw:
                          flash_decode.flash_attention_decode_partials(
                              *a, d ** -0.5, True, **k)))
            flash_decode.decode_cluster = pick
    for _ in range(2):
        for label, c, fn in timed:
            if c is not None:
                flash_decode.decode_cluster = lambda blocks, sms, c=c: c
            print(f"{label}: {smoke.time_ms(fn):.4f} ms", flush=True)
            flash_decode.decode_cluster = pick


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_ab: needs a CUDA card", file=sys.stderr)
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
