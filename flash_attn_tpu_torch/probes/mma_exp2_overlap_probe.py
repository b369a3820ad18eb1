"""Do independent tensor-core (mma.sync) and exp2 (MUFU) chains overlap in
one block?

Counterpart of benchmarks/mxu_vpu_overlap_probe.py (MXU-only, VPU-only and
both with no data dependence, timed by trip-count slope). The kernel of
csrc/probes.cu runs one block of 4 warps for ``steps`` steps in one of
three modes: an mma.sync.m16n8k16 bf16 chain over 4 accumulators a warp, an
exp2 chain v = exp2(v * 0.03125) - 1 over 16 values a thread, or both; 4
rounds of each a step. Each mode is timed at 64 and 512 steps with CUDA
events and reported as us a step from the slope, so that the launch cost
drops out. A "both" time near the larger of the two says the warp
schedulers overlap the chains (the premise of a kernel that overlaps its
softmax with its products); near their sum, that they serialise. The
outputs are held against a plain torch version of the same arithmetic.

    python -m flash_attn_tpu_torch.probes.mma_exp2_overlap_probe
"""

import json
import statistics
import sys

import torch

from flash_attn_tpu_torch.kernels import _build

__all__ = ["MODES", "STEPS", "overlap_probe", "overlap_probe_plain", "run",
           "step_us"]

MODES = {"mma": 1, "exp2": 2, "both": 3}
STEPS = (64, 512)
# The kernel's shape (csrc/probes.cu): threads, mma accumulators a warp,
# exp2 values a thread, rounds of each chain a step.
THREADS, CH, NV, REPS = 128, 4, 16, 4

launches = 0  # kernel launches since the last reset


def overlap_probe(mode: str, steps: int, device="cuda"):
    """(out_mma (128 * 4 * 4,), out_exp (128 * 16,)) fp32: the chains'
    final values after ``steps`` steps of ``mode``."""
    out_mma = torch.empty(THREADS * CH * 4, device=device)
    out_exp = torch.empty(THREADS * NV, device=device)
    if out_mma.device.type != "cuda":
        raise ValueError("overlap_probe: the probe runs on the card")
    lib = _build.load_library()
    with torch.cuda.device(out_mma.device):
        err = lib.fa_overlap_probe(
            out_mma.data_ptr(), out_exp.data_ptr(), MODES[mode], steps,
            torch.cuda.current_stream(out_mma.device).cuda_stream)
    _build.check(err, "fa_overlap_probe")
    global launches
    launches += 1
    return out_mma, out_exp


def overlap_probe_plain(mode: str, steps: int, device="cuda"):
    """The same arithmetic with torch ops: each m16n8k16 product of ones
    adds 16 to every accumulator; the exp2 chain runs steps x 4 times."""
    n_mma = 16 * REPS * steps if MODES[mode] & 1 else 0
    out_mma = torch.full((THREADS * CH * 4,), float(n_mma), device=device)
    out_exp = torch.ones(THREADS * NV, device=device)
    if MODES[mode] & 2:
        for _ in range(steps * REPS):
            out_exp = torch.exp2(out_exp * 0.03125) - 1
    return out_mma, out_exp


def _launch_ms(mode: str, steps: int, runs: int) -> float:
    """Median device time of one launch (CUDA events)."""
    overlap_probe(mode, steps)  # warm-up
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        overlap_probe(mode, steps)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def step_us(mode: str, runs: int = 11) -> float:
    """us a step of ``mode``: the slope of the launch time between 64 and
    512 steps."""
    lo, hi = (_launch_ms(mode, s, runs) for s in STEPS)
    return (hi - lo) * 1e3 / (STEPS[1] - STEPS[0])


def run(runs: int = 11):
    """us a step of each mode, the serial sum and overlap max beside
    "both", and each mode's largest error against the plain version at 512
    steps."""
    res = {f"{m}_us_per_step": step_us(m, runs) for m in MODES}
    res["serial_us_per_step"] = res["mma_us_per_step"] + res["exp2_us_per_step"]
    res["overlap_us_per_step"] = max(res["mma_us_per_step"],
                                     res["exp2_us_per_step"])
    for m in MODES:
        got = overlap_probe(m, STEPS[1])
        want = overlap_probe_plain(m, STEPS[1])
        res[f"{m}_max_abs_err"] = max(float((g - w).abs().max())
                                      for g, w in zip(got, want))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_exp2_overlap_probe: needs a CUDA card", file=sys.stderr)
        return 2
    res = run()
    print(f"{torch.cuda.get_device_name(0)}, one block of {THREADS} threads")
    for m in MODES:
        print(f"{m:5s} {res[m + '_us_per_step']:8.4f} us/step")
    print(f"both vs serial {res['serial_us_per_step']:.4f}, overlap "
          f"{res['overlap_us_per_step']:.4f} us/step")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
