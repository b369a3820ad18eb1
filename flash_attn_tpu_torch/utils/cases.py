"""Shapes shared by ``chip_smoke.py`` and the card tests.

This module imports torch and nothing of the package, so that a tool that
compares trees of the port (``tools/paged_ab.py``) can load it by path
without importing one tree's package before another's.
"""

import math

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
# softcap and ALiBi (dispatch/score.py) on the card. slopes: None, "1d"
# ((h,) broadcast over the batch) or "2d" ((b, h)), from the standard
# schedule of modules/mha.py alibi_slopes ("2d": each batch row's scaled
# by 1 + row / b). Baichuan-13B's shape: 40 heads of 128, ALiBi; the
# 913M GPT's: 16 heads of 128 with Gemma-2's attn_logit_softcapping, 50.
BAICHUAN_HEADS = 40
GEMMA2_SOFTCAP = 50.0
SCORE_FWD_CASES = [  # (name, b, sq, sk, h, h_k, d, causal, softcap, slopes,
    # window, dtype); the first two are timed into the kernels line: the
    # static prefills of Baichuan-13B (8 x 512) and of the softcap GPT
    ("Baichuan-13B prefill", 8, 512, 512, 40, 40, 128, True, 0.0, "1d",
     (-1, -1), torch.bfloat16),
    ("913M softcap prefill", 8, 512, 512, 16, 16, 128, True, GEMMA2_SOFTCAP,
     None, (-1, -1), torch.bfloat16),
    ("cap 30, sq < sk", 2, 700, 1300, 16, 4, 128, True, 30.0, None, (-1, -1),
     torch.bfloat16),
    ("alibi (b, h), not causal, sq < sk", 2, 600, 1000, 16, 4, 128, False,
     0.0, "2d", (-1, -1), torch.bfloat16),
    ("alibi (h,), causal, sq > sk (rows with no key)", 2, 900, 500, 16, 16,
     128, True, 0.0, "1d", (-1, -1), torch.bfloat16),
    ("alibi (b, h), not causal, sq = sk", 2, 1024, 1024, 16, 16, 128, False,
     0.0, "2d", (-1, -1), torch.float16),
    ("both, causal, GQA 32/8", 2, 1024, 1024, 32, 8, 128, True, 50.0, "2d",
     (-1, -1), torch.bfloat16),
    ("both under a window", 2, 2048, 2048, 16, 4, 128, True, 30.0, "1d",
     (255, 0), torch.bfloat16),
    ("both, d=64, fp16", 2, 1000, 1000, 16, 16, 64, True, 5.0, "2d",
     (-1, -1), torch.float16),
    ("both, d=96", 2, 1000, 1000, 16, 16, 96, True, 30.0, "1d", (-1, -1),
     torch.bfloat16),
    ("both, d=256", 2, 1000, 1000, 8, 8, 256, False, 30.0, "2d", (-1, -1),
     torch.bfloat16),
]
SCORE_DECODE_CASES = [  # (name, b, sq, h, h_k, d, page (0: linear), keys,
    # softcap, slopes, num_splits (0: flash_attn_with_kvcache's choice),
    # causal); keys is each row's cache length after the append (the rows
    # of a call get keys, keys - 37, keys - 74, ...). The timed ones:
    # Baichuan-13B's static decode step (b=8, 543 keys), its engine's decode
    # step (16 slots, pages of 256) and verify step (sq = 5), and the
    # softcap GPT's static and engine decode steps (64 slots)
    ("Baichuan-13B decode step", 8, 1, 40, 40, 128, 0, 543, 0.0, "1d", 0,
     True),
    ("Baichuan-13B engine decode step", 16, 1, 40, 40, 128, 256, 543, 0.0,
     "1d", 0, True),
    ("Baichuan-13B engine verify step", 16, 5, 40, 40, 128, 256, 543, 0.0,
     "1d", 0, True),
    ("913M softcap decode step", 8, 1, 16, 16, 128, 0, 543,
     GEMMA2_SOFTCAP, None, 0, True),
    ("913M softcap engine decode step", 64, 1, 16, 16, 128, 256, 543,
     GEMMA2_SOFTCAP, None, 0, True),
    ("alibi, 1 split", 8, 1, 40, 40, 128, 0, 543, 0.0, "2d", 1, True),
    ("both, GQA group 4, 3 splits", 4, 1, 32, 8, 128, 0, 3000, 30.0, "2d", 3,
     True),
    ("both, verify step, GQA group 4, pages of 64", 4, 5, 32, 8, 128, 64,
     3000, 30.0, "2d", 0, True),
    ("alibi, not causal, sq = 5, 1 split, pages of 16", 4, 5, 16, 4, 64, 16,
     900, 0.0, "2d", 1, False),
    ("cap, d=256, sq = 5", 4, 5, 16, 16, 256, 0, 1200, 30.0, None, 0, True),
    ("alibi, d=96", 4, 1, 64, 64, 96, 0, 1200, 0.0, "1d", 0, True),
]
# B8 with the cap: the softcap GPT's prefix-cached admission (VARLEN_CASES'
# first shape), then a window under the cap
SCORE_VARLEN_CASES = [  # (case of VARLEN_CASES' form, softcap, window)
    (VARLEN_CASES[0], GEMMA2_SOFTCAP, (-1, -1)),
    (("ragged, GQA 16/4", [300, 17, 128, 64], [812, 17, 400, 264], None, 16,
      4, 128, 64, torch.bfloat16, True), 30.0, (100, 0)),
]


# softcap and ALiBi in training (the backwards' score instantiations, and
# B6's and B7's forwards over the same rows packed): the two timed shapes
# first, Baichuan-13B's training step (2 x 4096, 40 heads of 128, causal
# ALiBi) and the 913M GPT's with Gemma-2's cap (4 x 2048, 16 heads of 128),
# then the forms the map takes at small sizes. (name, b, sq, sk, h, h_k, d,
# causal, softcap, slopes, window, dtype, fused): slopes and window as
# SCORE_FWD_CASES; fused: B2 (deterministic=False) is checked too.
SCORE_BWD_CASES = [
    ("Baichuan-13B training", 2, 4096, 4096, BAICHUAN_HEADS, BAICHUAN_HEADS,
     128, True, 0.0, "1d", (-1, -1), torch.bfloat16, True),
    ("913M softcap training", 4, 2048, 2048, 16, 16, 128, True,
     GEMMA2_SOFTCAP, None, (-1, -1), torch.bfloat16, True),
    ("cap 30, GQA 32/8, sq < sk", 2, 700, 1300, 32, 8, 128, True, 30.0, None,
     (-1, -1), torch.bfloat16, False),
    ("alibi (b, h), not causal, sq < sk", 2, 600, 1000, 16, 4, 128, False,
     0.0, "2d", (-1, -1), torch.bfloat16, True),
    ("alibi (h,), causal, sq > sk (rows with no key)", 2, 900, 500, 16, 16,
     128, True, 0.0, "1d", (-1, -1), torch.bfloat16, False),
    ("both under a window", 2, 2048, 2048, 16, 4, 128, True, 30.0, "1d",
     (255, 0), torch.bfloat16, False),
    ("both, d=64, fp16, cap 5", 2, 1000, 1000, 16, 16, 64, True, 5.0, "2d",
     (-1, -1), torch.float16, True),
    ("both, d=96", 2, 1000, 1000, 16, 16, 96, True, 30.0, "1d", (-1, -1),
     torch.bfloat16, False),
    ("both, d=256", 2, 1000, 1000, 8, 8, 256, False, 30.0, "2d", (-1, -1),
     torch.bfloat16, True),
]


def score_slopes(kind, b: int, h: int, device=None):
    """The slopes of a SCORE_* case: None, the (h,) schedule, or (b, h) rows
    of it scaled by 1 + row / b."""
    if kind is None:
        return None
    from flash_attn_tpu_torch.modules.mha import alibi_slopes

    s = alibi_slopes(h, device)
    if kind == "1d":
        return s
    return s[None] * (1 + torch.arange(b, device=device)[:, None] / b)


# Quantized KV caches on the card (dispatch/kvquant.py): B4's d = dv route
# over 1-byte caches with per-(row, KV head) descales, every head dim, both
# codes, linear, paged and the verify step (sq = 5), one window and one
# ALiBi case; the first three are the 913M's static decode step, engine
# decode step and verify step with an fp8 cache, timed. (name, b, sq, h,
# h_k, d, page (0: linear), keys, cache dtype, window, slopes (None,
# "1d", "2d"), num_splits (0: flash_attn_with_kvcache's choice)); keys is
# each row's cache length after the append.
KVQUANT_DECODE_CASES = [
    ("913M decode step, fp8", 8, 1, 16, 16, 128, 0, 543,
     torch.float8_e4m3fn, (-1, -1), None, 0),
    ("913M engine decode step, fp8", 64, 1, 16, 16, 128, 256, 543,
     torch.float8_e4m3fn, (-1, -1), None, 0),
    ("913M engine verify step, fp8", 64, 5, 16, 16, 128, 256, 520,
     torch.float8_e4m3fn, (-1, -1), None, 0),
    *((f"{kind}, {form}, d={d}, {dname}", 4, sq, 16, 4, d, page, 700, dt,
       (-1, -1), None, 0)
      for d in (64, 96, 128, 256)
      for dname, dt in (("fp8", torch.float8_e4m3fn), ("int8", torch.int8))
      for kind, form, page, sq in (("GQA 16/4", "linear", 0, 1),
                                   ("GQA 16/4", "pages of 64", 64, 1),
                                   ("GQA 16/4", "verify step", 64, 5))),
    ("window, fp8, 3 splits", 4, 1, 32, 8, 128, 0, 3000,
     torch.float8_e4m3fn, (511, 0), None, 3),
    ("alibi, int8, pages of 16, verify step", 4, 5, 16, 4, 128, 16, 900,
     torch.int8, (-1, -1), "2d", 0),
]
# B8 with descales: the 913M's prefix-cached admission over an fp8 cache
# (timed), each head dim over 1-byte pages, one window and one softcap
# case, and descales over a bf16 cache. (case of VARLEN_CASES' form with
# the cache dtype last, window, softcap)
KVQUANT_VARLEN_CASES = [
    (("prefix admission, fp8", [256] * 8, [512] * 8, None, 16, 16, 128, 256,
      torch.bfloat16, True, torch.float8_e4m3fn), (-1, -1), 0.0),
    *(((f"ragged, GQA 16/4, d={d}, {dname}", [300, 17, 128, 64],
        [812, 17, 400, 264], None, 16, 4, d, 64, torch.bfloat16, True, dt),
       (-1, -1), 0.0)
      for d in (64, 96, 128, 256)
      for dname, dt in (("fp8", torch.float8_e4m3fn), ("int8", torch.int8))),
    (("window, fp8, seqused_q", [128] * 4, [384, 77, 0, 517],
      [128, 77, 0, 5], 16, 4, 128, 256, torch.bfloat16, True,
      torch.float8_e4m3fn), (100, 0), 0.0),
    (("softcap, int8", [256, 256], [600, 256], None, 16, 4, 128, 64,
      torch.bfloat16, True, torch.int8), (-1, -1), 30.0),
    (("descales over a bf16 cache", [200, 56], [300, 256], None, 8, 8, 64,
      64, torch.bfloat16, False, torch.bfloat16), (-1, -1), 0.0),
]


def kv_descales(b: int, h_k: int, device=None):
    """Distinct per-(row, KV head) descales (q, k, v), each in [0.5, 1.5)
    and none equal to 1: a (b, h_k) fp32 grid of three seeded rows."""
    g = torch.Generator().manual_seed(b * 1000 + h_k)
    out = []
    for _ in range(3):
        x = 0.5 + torch.rand(b, h_k, generator=g)
        out.append(torch.where(x == 1.0, x + 0.25, x).to(device))
    return tuple(out)


def kv_codes(x, dtype):
    """x (fp32, of about unit scale) as cache codes of ``dtype`` and the
    value one code step stands for (multiply the descale to pass by it):
    float8_e4m3fn holds x (unit 1), int8 round(32 x) clamped to [-127,
    127] (unit 1 / 32), another type x cast."""
    if dtype == torch.int8:
        return torch.round(x * 32.0).clamp_(-127, 127).to(dtype), 1.0 / 32
    if dtype == torch.float8_e4m3fn:
        return x.clamp(-448.0, 448.0).to(dtype), 1.0
    return x.to(dtype), 1.0


# Head dim 80 on the card (B1, B4 d = dv and B8 at 80, in sources of their
# own). BTLM-3B-8K (cerebras/btlm-3b-8k-base config.json): 32 heads of 80,
# ALiBi, and muP's mup_scale_qk_dot_by_d, a softmax scale of 1/d; the cases
# named after it run at BTLM_SCALE, the rest at 1/sqrt(d).
BTLM_HEADS, BTLM_HEAD_DIM = 32, 80
BTLM_SCALE = 1.0 / BTLM_HEAD_DIM
HD80_FWD_CASES = [  # (b, sq, sk, h, h_k, d, causal), FWD_CASES' form: B1
    # without the band or the map at a GQA shape, and sq < sk not causal
    (2, 2048, 2048, 32, 8, 80, True),
    (2, 1000, 1300, 16, 16, 80, False),
]
HD80_BAND_FWD_CASES = [  # BAND_FWD_CASES' form
    ("window at a GQA shape, d=80", 2, 2048, 2048, 32, 8, 80, True,
     (511, 0), 0, 0),
    ("attention_chunk 512, d=80", 2, 2048, 2048, 16, 4, 80, True, (-1, -1),
     512, 0),
    ("4 sinks under a window of 300, sq < sk, d=80", 2, 1200, 1500, 16, 4, 80,
     True, (300, 0), 0, 4),
]
HD80_SCORE_FWD_CASES = [  # SCORE_FWD_CASES' form; the first is BTLM's static
    # prefill (8 x 512, ALiBi), timed into the kernels line
    ("BTLM-3B-8K prefill", 8, 512, 512, BTLM_HEADS, BTLM_HEADS, 80, True,
     0.0, "1d", (-1, -1), torch.bfloat16),
    ("alibi (b, h), not causal, GQA 32/8, sq < sk, d=80", 2, 600, 1000, 32,
     8, 80, False, 0.0, "2d", (-1, -1), torch.bfloat16),
    ("alibi under a window, causal sq > sk (rows with no key), d=80", 2, 900,
     500, 16, 16, 80, True, 0.0, "1d", (200, 0), torch.bfloat16),
    ("both under a window, d=80, fp16", 2, 1000, 1000, 16, 4, 80, True, 30.0,
     "2d", (255, 0), torch.float16),
]
HD80_SCORE_DECODE_CASES = [  # SCORE_DECODE_CASES' form; the first three
    # timed: BTLM's static decode step (b = 8), its engine's decode step (16
    # slots, pages of 256) and verify step (sq = 5), ALiBi
    ("BTLM-3B-8K decode step", 8, 1, BTLM_HEADS, BTLM_HEADS, 80, 0, 543, 0.0,
     "1d", 0, True),
    ("BTLM-3B-8K engine decode step", 16, 1, BTLM_HEADS, BTLM_HEADS, 80, 256,
     543, 0.0, "1d", 0, True),
    ("BTLM-3B-8K engine verify step", 16, 5, BTLM_HEADS, BTLM_HEADS, 80, 256,
     543, 0.0, "1d", 0, True),
    ("both, GQA group 4, 3 splits, d=80", 4, 1, 32, 8, 80, 0, 3000, 30.0,
     "2d", 3, True),
    ("alibi, not causal, sq = 5, 1 split, pages of 16, d=80", 4, 5, 16, 4,
     80, 16, 900, 0.0, "2d", 1, False),
]
HD80_BAND_DECODE_CASES = [  # BAND_DECODE_CASES' form
    ("window, verify step, pages of 64, d=80", 4, 5, 32, 8, 80, 64, 3000,
     (511, 0), 0, 0),
]
HD80_KVQUANT_DECODE_CASES = [  # KVQUANT_DECODE_CASES' form; the first timed:
    # BTLM's engine decode step over an fp8 page pool with descales (no
    # slopes, so that the timed yardsticks compute the same function; the
    # last case takes them)
    ("BTLM-3B-8K engine decode step, fp8", 16, 1, BTLM_HEADS, BTLM_HEADS, 80,
     256, 543, torch.float8_e4m3fn, (-1, -1), None, 0),
    ("GQA 16/4, linear, d=80, int8", 4, 1, 16, 4, 80, 0, 700, torch.int8,
     (-1, -1), None, 0),
    ("alibi, GQA 16/4, verify step, d=80, fp8", 4, 5, 16, 4, 80, 64, 700,
     torch.float8_e4m3fn, (-1, -1), "2d", 0),
]
# B8 at 80: BTLM's width at the engine's prefix-cached admission (8 chunks
# of 256 over 512 keys, pages of 256; timed), ragged under a window and
# under the cap, then with descales over 1-byte pages (KVQUANT_VARLEN_CASES'
# form)
HD80_VARLEN_CASES = [  # (case of VARLEN_CASES' form, softcap, window)
    (("prefix admission, d=80", [256] * 8, [512] * 8, None, BTLM_HEADS,
      BTLM_HEADS, 80, 256, torch.bfloat16, True), 0.0, (-1, -1)),
    (("ragged, GQA 16/4, window, d=80", [300, 17, 128, 64],
      [812, 17, 400, 264], None, 16, 4, 80, 64, torch.bfloat16, True), 0.0,
     (100, 0)),
    (("ragged, GQA 16/4, cap, d=80, fp16", [300, 17, 128, 64],
      [812, 17, 400, 264], None, 16, 4, 80, 64, torch.float16, True), 30.0,
     (-1, -1)),
]
HD80_KVQUANT_VARLEN_CASES = [
    (("prefix admission, fp8, d=80", [256] * 8, [512] * 8, None, BTLM_HEADS,
      BTLM_HEADS, 80, 256, torch.bfloat16, True, torch.float8_e4m3fn),
     (-1, -1), 0.0),
    (("ragged, GQA 16/4, d=80, int8", [300, 17, 128, 64],
      [812, 17, 400, 264], None, 16, 4, 80, 64, torch.bfloat16, True,
      torch.int8), (-1, -1), 0.0),
]
# Head dim 80 in training and on packed input (B2, B3, B6's backward and
# their preprocess, the packed forwards B6 and B7 at 80, in sources of
# their own): the plain form at a GQA shape, not causal with sq < sk and
# ragged keys, fp16, and causal sq > sk (rows that see no key); the band's
# window, chunk and sinks; the score map, whose first case is BTLM-3B-8K's
# training shape (b = 1 x 8192, 32 heads of 80, causal ALiBi over (h,)
# slopes, timed into the kernels line at BTLM_SCALE), then the cap at a GQA
# shape, (b, h) slopes not causal, both under a window in fp16, and rows
# with no key. No case runs sq = sk = 1 causal (JAX's dv fault at one row,
# ROADMAP.md queue C).
HD80_BWD_CASES = [  # BWD_CASES' form (b, sq, sk, h, h_k, d, causal, dtype)
    (2, 1024, 1024, 32, 8, 80, True, torch.bfloat16),
    (2, 1000, 1300, 16, 16, 80, False, torch.bfloat16),
    (2, 700, 900, 8, 8, 80, True, torch.float16),
    (2, 300, 200, 8, 2, 80, True, torch.bfloat16),
]
HD80_BAND_BWD_CASES = [  # BAND_BWD_CASES' form
    ("window at a GQA shape, d=80", 2, 2048, 2048, 32, 8, 80, True, (511, 0),
     0, 0),
    ("attention_chunk 512, d=80", 2, 2048, 2048, 16, 4, 80, True, (-1, -1),
     512, 0),
    ("4 sinks under a window of 300, sq < sk, d=80", 2, 1200, 1500, 16, 4, 80,
     True, (300, 0), 0, 4),
    ("window both ways, d=80", 2, 1000, 1000, 16, 16, 80, False, (128, 128),
     0, 0),
]
HD80_SCORE_BWD_CASES = [  # SCORE_BWD_CASES' form
    ("BTLM-3B-8K training", 1, 8192, 8192, BTLM_HEADS, BTLM_HEADS, 80, True,
     0.0, "1d", (-1, -1), torch.bfloat16, True),
    ("cap 30, GQA 32/8, sq < sk, d=80", 2, 700, 1300, 32, 8, 80, True, 30.0,
     None, (-1, -1), torch.bfloat16, True),
    ("alibi (b, h), not causal, sq < sk, d=80", 2, 600, 1000, 16, 4, 80,
     False, 0.0, "2d", (-1, -1), torch.bfloat16, False),
    ("both under a window, d=80, fp16", 2, 2048, 2048, 16, 4, 80, True, 30.0,
     "1d", (255, 0), torch.float16, True),
    ("alibi (h,), causal, sq > sk (rows with no key), d=80", 2, 900, 500, 16,
     16, 80, True, 0.0, "1d", (-1, -1), torch.bfloat16, False),
]


def case_scale(name: str):
    """The softmax scale of a named HD80_* case: BTLM_SCALE for the cases
    named after BTLM-3B-8K, else None (1/sqrt(d))."""
    return BTLM_SCALE if name.startswith("BTLM") else None


# The learnable sink (gpt-oss-20b: a natural-log logit a query head, 64 heads
# on 8 KV heads of 64, alternating a sliding window of 128 keys and full
# causal attention). B1, and B6's forward and B7 over the same rows packed:
# gpt-oss's two layer forms, then the edges (rows that see no key, a window
# that leaves rows empty, the cap, ALiBi, head dims 80, 128 and 256, fp16).
# (name, b, sq, sk, h, h_k, d, causal, window, softcap, slopes, dtype);
# slopes as SCORE_FWD_CASES.
GPT_OSS_WINDOW = (127, 0)
SINK_FWD_CASES = [
    ("gpt-oss sliding layer", 2, 1000, 1000, 64, 8, 64, True, GPT_OSS_WINDOW,
     0.0, None, torch.bfloat16),
    ("gpt-oss full layer", 2, 1000, 1000, 64, 8, 64, True, (-1, -1), 0.0,
     None, torch.bfloat16),
    ("causal, sq > sk (rows with no key), d=128", 2, 300, 129, 8, 2, 128,
     True, (-1, -1), 0.0, None, torch.bfloat16),
    ("window (10, 10) leaves rows empty, fp16", 1, 400, 200, 8, 4, 64, False,
     (10, 10), 0.0, None, torch.float16),
    ("cap 30, not causal, d=256", 1, 200, 260, 4, 4, 256, False, (-1, -1),
     30.0, None, torch.bfloat16),
    ("alibi, d=80", 2, 257, 257, 8, 8, 80, True, (-1, -1), 0.0, "1d",
     torch.bfloat16),
]
# B8 with a sink: its VARLEN_CASES' shapes (rows past seqused_q and a
# sequence with no key among them) under gpt-oss's window and the cap
SINK_VARLEN_CASES = [  # (case of VARLEN_CASES' form, softcap, window)
    (VARLEN_CASES[0], 0.0, GPT_OSS_WINDOW),
    (VARLEN_CASES[2], 0.0, (-1, -1)),
    (VARLEN_CASES[3], 30.0, (-1, -1)),
    (("gpt-oss prefix admission", [256] * 8, [512] * 8, None, 64, 8, 64, 256,
      torch.bfloat16, True), 0.0, GPT_OSS_WINDOW),
]


def sink_logits(h: int, keys: int, device=None, gen=None):
    """(h,) fp32 sink logits that bite at ``keys`` keys of N(0, 1) scores
    (a row's log-sum about log keys + 1/2): every fourth head's 4 above it,
    the next near -30, the next at 0, the rest drawn from N(lse - 1, 1)."""
    lse = float(torch.tensor(max(keys, 1)).log()) + 0.5
    s = torch.randn(h, generator=gen, device=device) + (lse - 1.0)
    idx = torch.arange(h, device=device) % 4
    s = torch.where(idx == 0, lse + 4.0, s)
    s = torch.where(idx == 1, -30.0, s)
    return torch.where(idx == 2, 0.0, s).float()


# q/k head dim 192 beside v head dim 128 (dispatch/config.py
# HEAD_DIM_PAIRS): DeepSeek-V3's attention when its MLA is not absorbed
# (deepseek-ai/DeepSeek-V3 config.json: qk_nope_head_dim 128 +
# qk_rope_head_dim 64, v_head_dim 128, 128 heads; arXiv 2412.19437 §4.2),
# at its softmax scale: 192^-0.5 times mscale^2, mscale = 0.1 ln(40) + 1
# from its YaRN rope_scaling (factor 40, mscale_all_dim 1.0), as HF's
# modeling_deepseek.py applies it.
DSV3_D, DSV3_DV, DSV3_HEADS, DSV3_SEQ, DSV3_LAYERS = 192, 128, 128, 4096, 61
DSV3_SCALE = (0.1 * math.log(40.0) + 1.0) ** 2 / math.sqrt(DSV3_D)
DV_CASES = [  # (name, b, sq, sk, h, h_k, causal, dtype, sink): B1, B3, B2
    # and the preprocess at 192 / 128; the first is one DeepSeek-V3 layer
    # at its training shape and scale, the rest at 1/sqrt(192)
    ("DeepSeek-V3 layer", 1, DSV3_SEQ, DSV3_SEQ, DSV3_HEADS, DSV3_HEADS,
     True, torch.bfloat16, False),
    ("GQA 16/4", 2, 640, 640, 16, 4, True, torch.bfloat16, False),
    ("non-causal, ragged", 1, 700, 700, 8, 8, False, torch.bfloat16, False),
    ("sq < sk", 2, 333, 1000, 8, 8, True, torch.bfloat16, False),
    ("sq > sk, rows that see no key", 1, 1000, 333, 8, 8, True,
     torch.bfloat16, False),
    ("learnable sink", 2, 512, 512, 8, 8, True, torch.bfloat16, True),
    ("fp16 at GQA 8/2", 1, 777, 777, 8, 2, True, torch.float16, False),
]


def dv_case_scale(name: str):
    """A DV_CASES case's softmax scale: DSV3_SCALE for DeepSeek-V3's,
    the default (None) for the rest."""
    return DSV3_SCALE if name.startswith("DeepSeek") else None
