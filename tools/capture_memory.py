"""Allocated device memory across CUDA graph captures, on one card.

    python3 tools/capture_memory.py

Captures and replays a small bf16 matmul program four times through
``serving.graphs.CapturedProgram``, dropping each program before the next,
and prints ``torch.cuda.memory_allocated()`` after each capture and after
each drop (MiB): once with a fresh side stream for every capture, once on
the one capture stream that ``CapturedProgram`` shares. cuBLAS keeps a
workspace per stream, allocated at the first matmul captured on it in that
graph's pool; a fresh stream per capture adds one that is never freed.
"""

import gc
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from flash_attn_tpu_torch.serving import graphs  # noqa: E402

MIB = 2 ** 20


def main() -> int:
    if not torch.cuda.is_available():
        print("capture_memory: needs a CUDA card")
        return 2
    w = torch.randn(1024, 1024, device="cuda", dtype=torch.bfloat16)
    x = torch.randn(64, 1024, device="cuda", dtype=torch.bfloat16)
    (x @ w).sum().item()
    shared = graphs._capture_stream
    for mode in ("fresh", "shared"):
        graphs._capture_stream = (torch.cuda.Stream if mode == "fresh"
                                  else shared)
        mems = []
        for _ in range(4):
            prog = graphs.CapturedProgram()
            for _ in range(2):  # captured, then replayed
                prog(lambda t: t @ w, x)
            torch.cuda.synchronize()
            mems.append(torch.cuda.memory_allocated() / MIB)
            del prog
            gc.collect()
            mems.append(torch.cuda.memory_allocated() / MIB)
        print(f"{mode} stream per capture: MiB allocated after each capture "
              f"and after dropping it: {[round(m, 3) for m in mems]}")
    graphs._capture_stream = shared
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
