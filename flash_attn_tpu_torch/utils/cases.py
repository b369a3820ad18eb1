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

# The band masks (dispatch/band.py) on the card. Mistral-7B-v0.1's shape:
# 32 query heads on 8 KV heads of 128, a sliding window of 4096 keys
# (window_size (4095, 0) under causal masking).
MISTRAL_WINDOW = (4095, 0)
BAND_FWD_CASES = [  # (name, b, sq, sk, h, h_k, d, causal, window,
    # attention_chunk, sink_token_length); the first is Mistral-7B's
    # prefill, timed into the kernels line
    ("Mistral-7B prefill", 2, 6144, 6144, 32, 8, 128, True, MISTRAL_WINDOW,
     0, 0),
    ("window both ways, d=64", 4, 2048, 2048, 16, 16, 64, False, (256, 256),
     0, 0),
    ("window narrower than a tile", 4, 1024, 1024, 16, 4, 128, True, (31, 0),
     0, 0),
    ("window, sq < sk", 4, 512, 1500, 16, 4, 128, True, (300, 0), 0, 0),
    ("window, causal sq > sk (rows with no key)", 2, 900, 500, 16, 4, 128,
     True, (200, 0), 0, 0),
    ("window both ways, sq > sk (rows with no key)", 2, 1000, 600, 16, 16,
     128, False, (100, 50), 0, 0),
    ("attention_chunk 1024", 2, 4096, 4096, 32, 8, 128, True, (-1, -1), 1024,
     0),
    ("4 sinks under a window of 1024", 2, 4096, 4096, 32, 8, 128, True,
     (1023, 0), 0, 4),
    ("window at d=96", 2, 2048, 2048, 64, 64, 96, True, (511, 0), 0, 0),
    ("window at d=256", 2, 2048, 2048, 16, 16, 256, True, (511, 0), 0, 0),
]
BAND_DECODE_CASES = [  # (name, b, sq, h, h_k, d, page (0: linear), keys,
    # window, attention_chunk, num_splits (0: flash_attn_with_kvcache's
    # choice)); keys is each row's cache length after the append. The
    # timed ones: Mistral-7B's static decode's last step (b=2 at 6208
    # keys), the engine's decode step (8 slots of 5152 keys, pages of 256)
    # and its verify step (sq = 5)
    ("Mistral-7B decode step", 2, 1, 32, 8, 128, 0, 6208, MISTRAL_WINDOW, 0,
     0),
    ("Mistral-7B decode step, 1 split", 2, 1, 32, 8, 128, 0, 6208,
     MISTRAL_WINDOW, 0, 1),
    ("Mistral-7B decode step, 8 splits", 2, 1, 32, 8, 128, 0, 6208,
     MISTRAL_WINDOW, 0, 8),
    # tokens 0..4 at 6203..6207 see from 6142..6146: the band's tiles are
    # 95 and 96, one a split, and split 0 lies wholly below tokens 2-4's
    # windows
    ("a split below later tokens' windows", 2, 5, 32, 8, 128, 0, 6208,
     (61, 0), 0, 2),
    ("attention_chunk 1024", 2, 1, 32, 8, 128, 0, 6208, (-1, -1), 1024, 3),
    ("Mistral-7B engine decode step", 8, 1, 32, 8, 128, 256, 5152,
     MISTRAL_WINDOW, 0, 0),
    ("Mistral-7B engine verify step", 8, 5, 32, 8, 128, 256, 5152,
     MISTRAL_WINDOW, 0, 0),
    ("attention_chunk 1024, verify step, pages of 64", 4, 5, 32, 8, 128, 64,
     3000, (-1, -1), 1024, 3),
]
# B8 at Mistral-7B's prefix-cached admission: 8 suffixes of 512 query rows
# over 5120 keys (4608 of a shared prefix), pages of 256; the window's
# lower edge (row 4608 sees from key 513) falls inside the shared pages
BAND_VARLEN_CASE = ("Mistral-7B prefix admission", [512] * 8, [5120] * 8,
                    None, 32, 8, 128, 256, torch.bfloat16, True)
# The band in training: B3's and B2's band instantiations and the packed
# ones (B6's backward, B6's forward, B7) over the same rows. (name, b, sq,
# sk, h, h_k, d, causal, window, attention_chunk, sink_token_length); the
# first is Mistral-7B's training shape (one sequence of 8192 tokens, 32
# query heads on 8 KV heads of 128, window (4095, 0)), timed into the
# kernels line
BAND_BWD_CASES = [
    ("Mistral-7B training", 1, 8192, 8192, 32, 8, 128, True, MISTRAL_WINDOW,
     0, 0),
    ("attention_chunk 1024", 2, 4096, 4096, 32, 8, 128, True, (-1, -1), 1024,
     0),
    ("4 sinks under a window of 700, sq < sk, ragged keys", 2, 1200, 1999, 16,
     4, 128, True, (700, 0), 0, 4),
    ("window both ways", 2, 2048, 2048, 16, 16, 128, False, (256, 256), 0, 0),
    ("window, causal sq > sk (rows with no key)", 2, 900, 500, 16, 4, 128,
     True, (200, 0), 0, 0),
    ("window at d=64", 4, 2048, 2048, 16, 16, 64, True, (511, 0), 0, 0),
    ("window at d=96", 2, 2048, 2048, 64, 64, 96, True, (511, 0), 0, 0),
    ("window at d=256", 2, 2048, 2048, 16, 16, 256, True, (511, 0), 0, 0),
]
