"""Build and load the hand-written CUDA kernels.

All ``csrc/*.cu`` files are compiled by ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``: one ``nvcc`` process per
source, all started together, then one link. The library lands in
``flash_attn_tpu_torch/build/`` under a name keyed by a hash of the sources,
so an unchanged tree does not rebuild. Nothing here runs at import: the
first CUDA call of a kernel wrapper calls :func:`load_library`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# C entry points and their argument types (every pointer and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints).
SIGNATURES = {
    "fa_fwd": [_P] * 5 + [_I] * 9 + [_L] * 12 + [_F] + [_I] * 6
              + [_F, _P, _L, _P, _I, _P],
    "fa_decode": [_P] * 7 + [_I] * 12 + [_L] * 10 + [_F] + [_I] * 4
                 + [_F, _P, _L, _I, _P, _P, _I, _P],
    "fa_decode_mla": [_P] * 8 + [_I] * 13 + [_L] * 13 + [_F, _I, _I, _P],
    "fa_paged_prefill": [_P] * 10 + [_I] * 11 + [_L] * 15
                        + [_F, _I, _P, _I, _P],
    "fa_varlen_paged": [_P] * 10 + [_I] * 11 + [_L] * 11 + [_F] + [_I] * 4
                       + [_F, _P, _P, _P, _I, _P],
    "fa_kv_dequant": [_P] * 6 + [_I] * 7 + [_L] * 7 + [_I, _P],
    "fa_bwd_preprocess": [_P] * 6 + [_I] * 6 + [_L] * 6 + [_I, _P],
    "fa_bwd_dkdv": [_P] * 9 + [_I] * 10 + [_L] * 18 + [_F] + [_I] * 6
                   + [_F, _P, _L, _I, _P],
    "fa_bwd_dq": [_P] * 7 + [_I] * 10 + [_L] * 15 + [_F] + [_I] * 6
                 + [_F, _P, _L, _I, _P],
    "fa_varlen_fwd": [_P] * 10 + [_I] * 8 + [_L] * 8 + [_F] + [_I] * 5
                     + [_F, _P, _L, _P, _I, _P],
    "fa_varlen_fwd_persistent":
        [_P] * 10 + [_I] * 8 + [_L] * 8 + [_F] + [_I] * 5
        + [_F, _P, _L, _P, _I, _I, _P, _P],
    "fa_varlen_bwd_preprocess": [_P] * 13 + [_I] * 7 + [_L] * 5 + [_I, _P],
    "fa_varlen_bwd_dkdv":
        [_P] * 13 + [_I] * 9 + [_L] * 13 + [_F] + [_I] * 5
        + [_F, _P, _L, _I, _P],
    "fa_varlen_bwd_dq":
        [_P] * 12 + [_I] * 9 + [_L] * 11 + [_F] + [_I] * 5
        + [_F, _P, _L, _I, _P],
    "fa_blocksparse_fwd": [_P] * 7 + [_I] * 8 + [_L] * 9 + [_F, _I, _I, _P],
    "fa_blocksparse_bwd_preprocess": [_P] * 9 + [_I] * 10 + [_L] * 6 + [_I, _P],
    "fa_blocksparse_bwd_dkdv":
        [_P] * 11 + [_I] * 9 + [_L] * 12 + [_F, _I, _I, _P],
    "fa_blocksparse_bwd_dq": [_P] * 9 + [_I] * 9 + [_L] * 12 + [_F, _I, _I, _P],
    "fa_smem_probe": [_P, _P, _I, _I, _P, _P],
    "fa_overlap_probe": [_P, _P, _I, _I, _P],
}

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
        f"{CSRC} on first use")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libfa_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with the first failure's
    output once all have ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    cu, _ = _sources()
    objs = BUILD_DIR / f"{out.stem}.{os.getpid()}.objs"
    objs.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    obj_files = [objs / f"{src.stem}.o" for src in cu]
    _run_all([[nvcc, *flags, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(cu, obj_files)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, obj_files)]])
    os.replace(tmp, out)
    shutil.rmtree(objs, ignore_errors=True)
    return out


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        msg = load_library().fa_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_operand(kernel: str, name: str, x, dtype, device) -> None:
    """What the C entry points assume of a tensor: the device and type
    given (q's, or a cache's own), a contiguous last dim, other strides in
    multiples of 16 bytes (8 elements of 2 bytes) and a 16-byte aligned
    start (the kernels move 16-byte chunks)."""
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{kernel}: {name} is {x.dtype} on {x.device}, "
                         f"want {dtype} on {device}")
    per = max(1, 16 // x.element_size())
    if x.stride(-1) != 1 or any(st % per for st in x.stride()[:-1]) \
            or x.data_ptr() % 16:
        raise ValueError(
            f"{kernel}: {name} needs a contiguous last dim, strides that are "
            f"multiples of {per} and a 16-byte aligned start; got strides "
            f"{x.stride()}")
