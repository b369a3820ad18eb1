"""Shapes shared by ``chip_smoke.py`` and the card tests.

This module imports torch and nothing of the package, so that a tool that
compares trees of the port (``tools/paged_ab.py``) can load it by path
without importing one tree's package before another's.
"""

import torch

VARLEN_CASES = [  # (name, lens_q, lens_k, seqused_q, h, h_k, d, page, dtype,
    # causal); the first is the prefix-cached admission's: 8 chunks of 256
    # query tokens over 512 keys
    ("prefix admission", [256] * 8, [512] * 8, None, 16, 16, 128, 256,
     torch.bfloat16, True),
    ("ragged", [300, 17, 128, 64], [812, 17, 400, 264], None, 16, 16, 128,
     64, torch.bfloat16, True),
    ("zero-length", [0, 50, 0, 200], [10, 50, 0, 700], None, 16, 16, 128,
     256, torch.bfloat16, True),
    ("seqused_q padding", [128] * 4, [384, 77, 0, 517], [128, 77, 0, 5], 16,
     16, 128, 256, torch.bfloat16, True),
    ("GQA 16/4", [256] * 4, [512] * 4, None, 16, 4, 128, 16, torch.bfloat16,
     True),
    ("d=64", [100, 200], [300, 200], None, 8, 8, 64, 64, torch.bfloat16,
     False),
    ("fp16", [256, 256], [600, 256], None, 16, 4, 128, 256, torch.float16,
     True),
]
