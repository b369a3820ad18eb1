"""Static-batch generation: prefill, then a Python token loop of decode
steps (port of flash_attn_tpu/serving/generation.py). Each step runs the
model eagerly; capturing the step in a CUDA graph is later work."""

import dataclasses
from typing import Optional

import torch

__all__ = ["GenerationConfig", "decode", "sample_token"]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_length: int = 128
    top_k: int = 1           # 1 = greedy
    top_p: float = 0.0       # 0 = disabled
    min_p: float = 0.0
    temperature: float = 1.0
    eos_token_id: Optional[int] = None


def sample_token(logits, generator: Optional[torch.Generator],
                 cfg: GenerationConfig):
    """Top-k / top-p / min-p / temperature sampling of (b, vocab) logits;
    greedy (argmax, first index on ties) when top_k == 1 and top_p == 0."""
    logits = logits.float()
    if cfg.top_k == 1 and cfg.top_p == 0.0:
        return logits.argmax(dim=-1)
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    neg_inf = float("-inf")
    if cfg.top_k > 1:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg_inf)
    if cfg.top_p > 0.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        cum = sorted_logits.softmax(dim=-1).cumsum(dim=-1)
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1, keepdim=True).clamp(
            max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, neg_inf)
    if cfg.min_p > 0.0:
        probs = logits.softmax(dim=-1)
        pmax = probs.amax(dim=-1, keepdim=True)
        logits = logits.masked_fill(probs < cfg.min_p * pmax, neg_inf)
    probs = logits.softmax(dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


@torch.inference_mode()
def decode(input_ids, model, cfg: GenerationConfig,
           generator: Optional[torch.Generator] = None,
           output_scores: bool = False, teacher_outputs=None):
    """Prefill + token loop over ``model`` (a GPTLMHeadModel).

    Returns (sequences (b, max_length) int64, final length); with
    ``output_scores`` also the per-step logits (max_new_tokens, b, vocab)
    fp32, step t being the logits that produced token prompt_len + t
    (unreached steps are zero). ``teacher_outputs`` (b, >= max_length)
    forces the tokens. After the prefill token there are
    max_length - prompt_len - 1 decode steps, fewer when every row has
    emitted ``eos_token_id``."""
    b, prompt_len = input_ids.shape
    max_len = cfg.max_length
    device = input_ids.device
    if generator is None and not (cfg.top_k == 1 and cfg.top_p == 0.0):
        generator = torch.Generator(device=device).manual_seed(0)

    cache = model.new_cache()
    last = torch.full((b,), prompt_len - 1, dtype=torch.long, device=device)
    logits = model(input_ids, mode="prefill", cache=cache,
                   logits_positions=last)[:, -1]
    tok = sample_token(logits, generator, cfg)
    if teacher_outputs is not None:
        tok = teacher_outputs[:, prompt_len].to(device, torch.long)
    seqs = torch.zeros((b, max_len), dtype=torch.long, device=device)
    seqs[:, :prompt_len] = input_ids
    seqs[:, prompt_len] = tok
    scores = None
    if output_scores:
        scores = torch.zeros((max_len - prompt_len, b, logits.shape[-1]),
                             dtype=torch.float32, device=device)
        scores[0] = logits
    eos = cfg.eos_token_id
    done = (tok == eos) if eos is not None else None

    pos = prompt_len + 1
    while pos < max_len and not (eos is not None and bool(done.all())):
        logits = model(tok[:, None], mode="decode", cache=cache)[:, -1]
        nxt = sample_token(logits, generator, cfg)
        if teacher_outputs is not None:
            nxt = teacher_outputs[:, pos].to(device, torch.long)
        if eos is not None:
            nxt = torch.where(done, eos, nxt)
            done = done | (nxt == eos)
        seqs[:, pos] = nxt
        if output_scores:
            scores[pos - prompt_len] = logits
        tok = nxt
        pos += 1
    if output_scores:
        return seqs, pos, scores
    return seqs, pos
