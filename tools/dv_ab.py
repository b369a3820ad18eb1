"""Device time of the kernels at q/k head dim 192 beside v head dim 128 (B1,
B3's pair, B2 and the preprocess), for comparing trees of the port on one
card.

    python3 tools/dv_ab.py ROOT [ROOT ...]

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit, or a variant of this tree with
another ring depth or tile plan), in a fresh process each, it builds that
tree's kernels and, at one layer of DeepSeek-V3's attention trained
without absorbing its MLA (1 x 4,096 rows, 128 heads, causal, its softmax
scale: chip_smoke.py's dsv3_layer), times B1, B3's pair (the whole
backward call, and each of its three kernels by CUDA events around its
launch: chip_smoke.py's entry_split_ms), B2 and the preprocess (CUDA
events over a held stream, median of 10), twice, and prints a SHA-256 of
B1's out and lse and of B3's dq, dk and dv. Give the roots in turns (A B B
A) to compare two trees on the card they share; the bits may differ where
a tree sums in another order.
"""

import hashlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(root: str) -> None:
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from flash_attn_tpu_torch.kernels import _build, flash_bwd, flash_fwd
    from flash_attn_tpu_torch.utils.cases import DSV3_SCALE

    print(f"package {flash_fwd.__file__}")
    _build.load_library()
    q, k, v, do = smoke.dsv3_layer(0)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    kw = dict(causal=True, softmax_scale=DSV3_SCALE)
    out, lse = flash_fwd.flash_attention_fwd(qt, kt, vt, **kw)
    grads = flash_bwd.flash_attention_bwd(dot, qt, kt, vt, out, lse, **kw)
    print(f"digest B1: {digest(out, lse)}", flush=True)
    print(f"digest B3: {digest(*grads)}", flush=True)

    def bwd(det):
        return lambda: flash_bwd.flash_attention_bwd(
            dot, qt, kt, vt, out, lse, deterministic=det, **kw)
    for _ in range(2):
        split = smoke.entry_split_ms(bwd(True), ["preprocess_kernel",
                                                 "dkdv_kernel", "dq_kernel"])
        times = {
            "B1": smoke.time_ms(lambda: flash_fwd.flash_attention_fwd(
                qt, kt, vt, **kw), runs=10),
            "B3 pair": smoke.time_ms(bwd(True), runs=10),
            "B2": smoke.time_ms(bwd(False), runs=10),
            "preprocess": smoke.time_ms(lambda: flash_bwd.bwd_preprocess(
                dot, out, lse, None, q.shape[-1]), runs=10)}
        print(", ".join(f"{name} {ms:.4f}" for name, ms in times.items())
              + " ms; B3's kernels by CUDA events " + ", ".join(
                  f"{name} {ms:.4f}" for name, ms in split.items()),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("dv_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--one"]:
        measure(sys.argv[2])
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for root in sys.argv[1:]:
        print(f"== {root}", flush=True)
        run = subprocess.run([sys.executable, __file__, "--one", root])
        if run.returncode:
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
