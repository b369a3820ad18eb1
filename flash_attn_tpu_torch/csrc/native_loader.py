"""ctypes bridge to the native C++ data loader (dataloader.cpp).

Port of flash_attn_tpu/csrc/native_loader.py. Builds the shared library
with g++ on first use into flash_attn_tpu_torch/build/, under a name keyed
by a hash of the source (written to a temporary file and renamed, so
concurrent first uses do not race). Every entry point degrades to None /
numpy if the toolchain or the build is unavailable, so the data path never
depends on it.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from flash_attn_tpu_torch.kernels._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "dataloader.cpp"
_lock = threading.Lock()
_lib = None
_build_failed = False


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdataloader_{digest}.so"


def _get_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = _library_path()
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                     "-pthread", str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.tl_open.restype = ctypes.c_void_p
        lib.tl_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.tl_close.argtypes = [ctypes.c_void_p]
        lib.tl_num_items.restype = ctypes.c_long
        lib.tl_num_items.argtypes = [ctypes.c_void_p]
        lib.tl_fill_batch.restype = ctypes.c_int
        lib.tl_fill_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, ctypes.c_long, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


class _Handle:
    def __init__(self, lib, ptr):
        self.lib = lib
        self.ptr = ptr

    def __del__(self):
        if self.ptr:
            self.lib.tl_close(self.ptr)
            self.ptr = None


def open_token_file(path: str, item_size: int):
    """A handle on the mapped token file, or None without the library."""
    lib = _get_lib()
    if lib is None:
        return None
    ptr = lib.tl_open(os.fsencode(path), item_size)
    return _Handle(lib, ptr) if ptr else None


def fill_batch(handle: "_Handle", starts: np.ndarray, window: int, dtype):
    """(len(starts), window) tokens from the given start offsets; raises
    IndexError for a window past the end of the file."""
    n = len(starts)
    out = np.empty((n, window), dtype=dtype)
    starts64 = np.ascontiguousarray(starts, dtype=np.int64)
    rc = handle.lib.tl_fill_batch(
        handle.ptr,
        starts64.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n, window, out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise IndexError("token window out of bounds")
    return out
