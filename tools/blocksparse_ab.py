"""Device time and bits of block-sparse attention (B10) and of the dense
kernels whose tiles it shares, for comparing trees of the port on one card.

    python3 tools/blocksparse_ab.py ROOT [ROOT ...]
    python3 tools/blocksparse_ab.py --sass ROOT_A ROOT_B

For each ROOT (a directory holding a ``flash_attn_tpu_torch`` package, such
as an unpacked archive of another commit), in a fresh process each, it
builds that tree's kernels and then

  - runs B10 on every mask of chip_smoke.py's BS_CASES (from this script's
    own checkout: 16 heads of 128, bf16, the inputs seeded the same way in
    every tree) and on the local window at tiles of 64 (STRADDLE: each
    128-row block's halves, and each 128-key dK/dV block's, lie in two
    caller tiles with different lists) and prints a digest of out and lse and of the fp32
    gradients, the device ms of a forward call and of a whole backward call
    (CUDA events over a held stream, median of 25 and of 10) and the device
    ms a call of every kernel the backward launches (torch.profiler over 10
    calls);
  - prints a digest of B1's out and lse on every FWD_CASES shape and of
    B3's gradients on every BWD_CASES shape, and times B1 and B3 (whole
    call, CUDA events) at the training shape (b=4 x 2048, h=16, d=128,
    causal).

At the end it says whether the trees gave the same bits, case by case, and
exits 1 if B1's or B3's differ (B10's may: that is what a redesign of B10
changes). Give the roots in turns (A B B A) to compare two trees on the
card they share.

With --sass it compiles the sources of the kernels that share B10's tiles
(flash_fwd.cu, flash_varlen_fwd.cu and its band and score instantiations,
flash_varlen_paged.cu, flash_blocksparse.cu, and the dense and varlen
backwards' sources: flash_bwd.cu, flash_varlen.cu, their head dims 96 and
256 and their band and score instantiations), the score instantiations of
B1 and B8, the decode route's sources (flash_decode.cu,
flash_decode_kv8.cu), the head dim 80 sources (the *_80.cu files) and the
q/k 192 beside v 128 ones (flash_fwd_192.cu, flash_bwd_192.cu) in
both trees with nvcc -cubin, all side by side, and says, kernel by
kernel, whether the machine code (cuobjdump -sass, with the file-specific
part of the names taken out) is the same, under the kernel's own name or
another one; exit 1 if a kernel of ROOT_A compiles to code that ROOT_B
does not hold. A source that ROOT_A lacks holds no kernel there (its
kernels are all new in ROOT_B).
"""

import concurrent.futures
import hashlib
import importlib.util
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"
TRAINING = (4, 2048, 16, 128)  # b, s, h, d
STRADDLE = ("local 4 + global, tiles of 64", 4, 2048, 64, "local", True)
SASS_SOURCES = ["flash_fwd.cu", "flash_varlen_fwd.cu", "flash_varlen_fwd_band.cu",
                "flash_varlen_fwd_score.cu", "flash_varlen_paged.cu",
                "flash_blocksparse.cu", "flash_bwd.cu", "flash_bwd_wide.cu",
                "flash_bwd_band.cu", "flash_bwd_band_wide.cu", "flash_bwd_score.cu",
                "flash_bwd_score_wide.cu", "flash_varlen.cu", "flash_varlen_wide.cu",
                "flash_varlen_band.cu", "flash_varlen_band_wide.cu",
                "flash_varlen_score.cu", "flash_varlen_score_wide.cu",
                "flash_fwd_score.cu", "flash_varlen_paged_score.cu", "flash_decode.cu",
                "flash_decode_kv8.cu", "flash_fwd_80.cu", "flash_decode_80.cu",
                "flash_varlen_paged_80.cu", "flash_bwd_80.cu", "flash_bwd_score_80.cu",
                "flash_varlen_80.cu", "flash_varlen_score_80.cu",
                "flash_varlen_fwd_80.cu", "flash_fwd_192.cu", "flash_bwd_192.cu"]


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def kernel_ms(fn, runs: int = 10) -> dict:
    """Device ms a call of each kernel fn() launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {re.sub(r"^void |\(anonymous namespace\)::|at::native::", "",
                   e.key)[:40]: e.device_time_total / runs / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0}


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def measure(root: str) -> None:
    smoke = load_smoke()
    sys.path.insert(0, root)
    from flash_attn_tpu_torch.kernels import _build, flash_bwd, flash_fwd
    from flash_attn_tpu_torch.kernels import flash_blocksparse as bs

    print(f"package {bs.__file__}")
    _build.load_library()
    h, d = smoke.BS_HEADS, smoke.BS_DIM
    for ci, (name, b, s, block, kind, causal) in enumerate(
            smoke.BS_CASES + [STRADDLE]):
        nt = s // block
        num, idx = (x.cuda() for x in bs.blockmask_to_kv_indices(
            smoke.blocksparse_mask(kind, b, nt, nt)))
        gen = torch.Generator(device="cuda").manual_seed(ci)
        q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        kw = dict(causal=causal, block_q=block, block_k=block)
        out, lse = bs.flash_attention_blocksparse_fwd(q, k, v, num, idx, **kw)
        grads = bs.flash_attention_blocksparse_bwd(do, q, k, v, out, lse, num,
                                                   idx, **kw)
        case = f"B10 {name} (b={b}, s={s}, tiles of {block})"
        print(f"digest {case} out, lse: {digest(out, lse)}")
        print(f"digest {case} dq, dk, dv: {digest(*grads)}", flush=True)
        for _ in range(2):
            fwd_ms = smoke.time_ms(lambda: bs.flash_attention_blocksparse_fwd(
                q, k, v, num, idx, **kw))
            bwd_ms = smoke.time_ms(lambda: bs.flash_attention_blocksparse_bwd(
                do, q, k, v, out, lse, num, idx, **kw), runs=10)
            split = kernel_ms(lambda: bs.flash_attention_blocksparse_bwd(
                do, q, k, v, out, lse, num, idx, **kw))
            print(f"{case}: forward {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms"
                  f" (whole call); profiler split of the backward (ms a "
                  f"call): " + ", ".join(f"{n} {t:.4f}"
                                         for n, t in split.items()),
                  flush=True)
        del q, k, v, do, out, lse, grads
    for i, (b, sq, sk, hh, h_k, dd, causal) in enumerate(smoke.FWD_CASES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        q = torch.randn(b, sq, hh, dd, device="cuda", generator=gen).to(
            torch.bfloat16).transpose(1, 2)
        k, v = (torch.randn(b, sk, h_k, dd, device="cuda", generator=gen).to(
            torch.bfloat16).transpose(1, 2) for _ in range(2))
        out, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal)
        print(f"digest B1 {(b, sq, sk, hh, h_k, dd, causal)}: "
              f"{digest(out, lse)}")
    for i, (b, sq, sk, hh, h_k, dd, causal, dtype) in enumerate(
            smoke.BWD_CASES):
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        q, do = (torch.randn(b, sq, hh, dd, device="cuda", generator=gen)
                 .to(dtype).transpose(1, 2) for _ in range(2))
        k, v = (torch.randn(b, sk, h_k, dd, device="cuda", generator=gen)
                .to(dtype).transpose(1, 2) for _ in range(2))
        out, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal)
        grads = flash_bwd.flash_attention_bwd(do, q, k, v, out, lse,
                                              causal=causal)
        print(f"digest B3 {(b, sq, sk, hh, h_k, dd, causal, str(dtype)[6:])}:"
              f" {digest(*grads)}")
    b, s, hh, dd = TRAINING
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, s, hh, dd, device="cuda", generator=gen)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=True)
    for _ in range(2):
        b1 = smoke.time_ms(lambda: flash_fwd.flash_attention_fwd(
            q, k, v, causal=True))
        b3 = smoke.time_ms(lambda: flash_bwd.flash_attention_bwd(
            do, q, k, v, out, lse, causal=True), runs=10)
        print(f"training shape {TRAINING}: B1 {b1:.4f} ms, B3 {b3:.4f} ms "
              f"(whole call)", flush=True)


def sass(root: str, source: str, workdir: str) -> dict:
    """Kernel name -> its SASS, with the file-specific hash of the
    anonymous namespace and the addresses taken out."""
    path = os.path.join(root, "flash_attn_tpu_torch", "csrc", source)
    if not os.path.exists(path):
        return {}
    cubin = os.path.join(workdir, f"{abs(hash(root))}_{source}.cubin")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-cubin", "-o", cubin, path],
                   check=True)
    text = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "ANON", text)
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name is not None:
            kernels[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line))
    return {n: "\n".join(body) for n, body in kernels.items()}


def compare_sass(root_a: str, root_b: str) -> int:
    """Each kernel of ROOT_A's sources against ROOT_B's: the same SASS
    under its own name, or under another (a template argument added, such
    as a band instantiation's flag, renames a kernel that compiles to the
    same code); a kernel of ROOT_A whose SASS ROOT_B holds under no name
    differs. ROOT_B's kernels that ROOT_A lacks are listed as new."""
    differ = 0
    with tempfile.TemporaryDirectory() as work, \
            concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        jobs = {(root, source): pool.submit(sass, root, source, work)
                for source in SASS_SOURCES for root in (root_a, root_b)}
        for source in SASS_SOURCES:
            a, b = (jobs[root, source].result() for root in (root_a, root_b))
            bodies = set(b.values())
            same = [n for n in a if a[n] == b.get(n)]
            renamed = [n for n in a if n not in same and a[n] in bodies]
            diff = sorted(n for n in a if a[n] not in bodies)
            new = sorted(n for n in b if b[n] not in set(a.values()))
            differ += len(diff)
            print(f"{source}: {len(same)} kernels with the same SASS, "
                  f"{len(renamed)} more under another name"
                  + (f"; differ: {', '.join(diff)}" if diff else "")
                  + (f"; new in {root_b}: {len(new)}" if new else ""))
    return 1 if differ else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("blocksparse_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if len(sys.argv) == 4 and sys.argv[1] == "--sass":
        return compare_sass(sys.argv[2], sys.argv[3])
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
    return 0 if all(len(v) == 1 for n, v in digests.items()
                    if not n.startswith("B10 ")) else 1


if __name__ == "__main__":
    sys.exit(main())
