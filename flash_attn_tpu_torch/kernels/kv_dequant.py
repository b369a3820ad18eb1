"""The pages of a quantized cache that a paged prefill reaches, converted
to the activations' type: the CUDA kernel ``csrc/kv_dequant.cu`` and its
plain PyTorch version.

It carries B11's conversion (flash_attn_tpu/kernels/fp8_cast.py:28, called
on load by flash_varlen_paged.py:62-63) for the paged prefill B8 over a
cache of 1-byte codes (float8_e4m3fn or int8, dispatch/kvquant.py): JAX's
kernel converts each staged tile; here B8's ``wgmma`` tile keeps its
2-byte stages, so the wrapper first converts exactly the pages the call's
block table reaches below each row's key count into a pool of q's type
under a compacted table (row s's page j at pool page s * width + j), and
B8 runs over that pool unchanged. Both conversions are exact: every finite
e4m3 value and every int8 value is a bf16 and an fp16 value. The two NaN
codes of e4m3 (0x7F, 0xFF) give NaN here, where JAX's bit relocation gives
a finite value; the saturating store (dispatch/kvquant.py quantize_kv)
never writes them. Pages the table names past a row's key count are left
as they are (the kernel does not write them): B8 masks their keys. A
tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

import torch

from flash_attn_tpu_torch.dispatch.kvquant import KV_CODES
from flash_attn_tpu_torch.kernels import _build

# Kernel launches since the last reset (plain calls not counted).
launches = 0


def pages_reached(seqlens_k, page_size: int, width: int):
    """(b, width) bool: the table entries below each row's key count."""
    need = (seqlens_k.long() + page_size - 1) // page_size
    return torch.arange(width, device=seqlens_k.device)[None, :] < need[:, None]


def dequant_pages_plain(k_pages, v_pages, block_table, seqlens_k, dtype):
    """(k_pool, v_pool, table): the pages of ``block_table`` (b, width)
    below each row's ``seqlens_k`` as values of ``dtype``, row s's page j at
    pool page s * width + j of pools (b * width, h_k, page_size, d), the
    others zero; ``table`` (b, width) int32 the compacted block table."""
    num_pages, h_k, page_size, d = k_pages.shape
    b, width = block_table.shape
    dev = k_pages.device
    t = block_table.to(dev, torch.long).clamp(0, num_pages - 1)
    keep = pages_reached(seqlens_k.to(dev), page_size, width)
    pools = []
    for pages in (k_pages, v_pages):
        codes = pages.view(torch.uint8)[t].view(pages.dtype)
        pool = codes.float() * keep[:, :, None, None, None]
        pools.append(pool.to(dtype).reshape(b * width, h_k, page_size,
                                            pages.shape[-1]))
    table = torch.arange(b * width, dtype=torch.int32, device=dev).reshape(
        b, width)
    return pools[0], pools[1], table


def dequant_pages(k_pages, v_pages, block_table, seqlens_k, dtype):
    """:func:`dequant_pages_plain`'s result; on the card the pool pages
    past a row's key count hold whatever the allocator left there. Pages
    (num_pages, h_k, page_size, d) of float8_e4m3fn or int8, K and V alike;
    ``dtype`` bf16 or fp16; block_table (b, width) and seqlens_k (b,)
    int32."""
    if k_pages.device.type == "cpu":
        return dequant_pages_plain(k_pages, v_pages, block_table, seqlens_k,
                                   dtype)
    if k_pages.device.type != "cuda":
        raise ValueError(f"kv_dequant: unsupported device {k_pages.device}")
    num_pages, h_k, page_size, d = k_pages.shape
    b, width = block_table.shape
    dev = k_pages.device
    if (k_pages.dtype not in KV_CODES or v_pages.dtype != k_pages.dtype
            or v_pages.shape != k_pages.shape or d % 16
            or dtype not in (torch.bfloat16, torch.float16)):
        raise ValueError(
            f"kv_dequant kernel: pages {k_pages.dtype} {tuple(k_pages.shape)}"
            f", v {v_pages.dtype} {tuple(v_pages.shape)}, into {dtype}")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        _build.check_operand("kv_dequant", name, x, k_pages.dtype, dev)
    for name, x in (("block_table", block_table), ("seqlens_k", seqlens_k)):
        if x.device != dev or x.dtype != torch.int32 or x.stride(-1) != 1 \
                or x.shape[0] != b:
            raise ValueError(f"kv_dequant kernel: {name} must be int32 on the "
                             "pages' device, a row per sequence, its last dim "
                             "contiguous")
    k_pool = torch.empty((b * width, h_k, page_size, d), dtype=dtype,
                         device=dev)
    v_pool = torch.empty_like(k_pool)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.fa_kv_dequant(
            k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
            seqlens_k.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            b, width, num_pages, h_k, page_size, d, KV_CODES[k_pages.dtype],
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
            block_table.stride(0), int(dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fa_kv_dequant")
    global launches
    launches += 1
    table = torch.arange(b * width, dtype=torch.int32, device=dev).reshape(
        b, width)
    return k_pool, v_pool, table
