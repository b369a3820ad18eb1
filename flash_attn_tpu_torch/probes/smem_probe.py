"""How much dynamic shared memory one block can opt into, and how many such
blocks an SM then holds.

Counterpart of benchmarks/vmem_probe.py, which compiled a kernel with a
growing VMEM scratch (8-120 MiB) to find the largest Mosaic accepts. On
the card the limit is a runtime opt-in: the kernel of csrc/probes.cu asks
for each size with cudaFuncSetAttribute(...,
cudaFuncAttributeMaxDynamicSharedMemorySize, bytes), reads the resident
blocks per SM from cudaOccupancyMaxActiveBlocksPerMultiprocessor, and, where
the size is accepted, computes o = x + x[0, 0] over an (8, 128) fp32 tile
through the end of the buffer; the output is held against the plain torch
version. It bears on the B8p kernel, which takes 224.5 KB a block.

    python -m flash_attn_tpu_torch.probes.smem_probe
"""

import ctypes
import json
import sys
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.kernels import _build

__all__ = ["SIZES_KB", "run", "smem_probe", "smem_probe_plain"]

# From the default 48 KB up to and past the 227 KB a block may opt into.
SIZES_KB = (48, 64, 96, 128, 160, 192, 200, 216, 224, 226, 227, 228, 232, 256)
SHAPE = (8, 128)
_REFUSED = 1  # cudaErrorInvalidValue: the card does not take the size

launches = 0  # kernel launches since the last reset


def smem_probe_plain(x):
    return x + x[0, 0]


def smem_probe(x, nbytes: int) -> Tuple[Optional[torch.Tensor], int]:
    """(o, blocks per SM) with ``nbytes`` of dynamic shared memory for one
    block, or (None, 0) when the card refuses that size. x: (8, 128) fp32 on
    the card."""
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or x.shape != SHAPE or not x.is_contiguous():
        raise ValueError(f"smem_probe: x must be a contiguous {SHAPE} fp32 "
                         f"tensor on the card; got {x.dtype} {tuple(x.shape)}"
                         f" on {x.device}")
    o = torch.empty_like(x)
    blocks = ctypes.c_int(0)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.fa_smem_probe(
            x.data_ptr(), o.data_ptr(), x.numel(), nbytes,
            ctypes.addressof(blocks),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err == _REFUSED:
        return None, 0
    _build.check(err, "fa_smem_probe")
    global launches
    launches += 1
    return o, blocks.value


def run(sizes_kb=SIZES_KB, seed: int = 0):
    """One row per size: accepted or refused, blocks per SM and the error
    against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(SHAPE, device="cuda", generator=gen)
    want = smem_probe_plain(x)
    rows = []
    for kb in sizes_kb:
        o, blocks = smem_probe(x, kb * 1024)
        err = None if o is None else float((o - want).abs().max())
        rows.append({"kb": kb, "bytes": kb * 1024, "accepted": o is not None,
                     "blocks_per_sm": blocks, "max_abs_err": err})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("smem_probe: needs a CUDA card", file=sys.stderr)
        return 2
    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    print(f"{torch.cuda.get_device_name(0)}: opt-in limit "
          f"{optin} bytes a block (device properties)")
    for row in run():
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
