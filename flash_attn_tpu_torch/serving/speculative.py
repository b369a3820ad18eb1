"""Speculative decoding: a draft model proposes k tokens, the target model
scores them in one forward and keeps the longest run the acceptance test
allows (port of flash_attn_tpu/serving/speculative.py).

``sample_speculative`` is Algorithm 1 of Leviathan et al.
(arXiv:2211.17192): draft token t_i is accepted with probability
min(1, p_target(t_i) / p_draft(t_i)); at the first rejection a token is
drawn from clamp(p_target - p_draft, 0), and when all k are accepted a
bonus token from the target's last distribution. Sampling gives tokens
distributed as the target's (filtered) distribution. Greedy decoding
(top_k=1, top_p=0, as in ``sample_token``) takes each distribution as the
one-hot of its argmax, the first index on ties: a proposal is accepted when
it is the target's argmax, and the first rejection emits that argmax, so
the tokens are the target model's own greedy decode's with no random draw.
(JAX's greedy round keeps every tied maximum in its filter and draws among
them; with bf16 logits ties are common, and its tokens then leave the
target's greedy decode at random.)

The target scores [current token, p_1..p_k] in one decode call (sq = k+1,
through the decode kernel's GQA-packed rows). The caches keep per-row
offsets, so each row's rejected suffix is dropped by rewinding its offset
in place (:func:`_rewind_cache`): entries past an offset are dead and are
overwritten by the next appends. ``decode_speculative`` keeps JAX's host
loop, committing each round's accepted tokens on the host; the serving
engine runs the same round as one captured graph
(:mod:`flash_attn_tpu_torch.serving.engine`).
"""

from typing import Optional

import numpy as np
import torch

from flash_attn_tpu_torch.serving.generation import (
    GenerationConfig,
    sample_token,
)

__all__ = ["decode_speculative", "sample_speculative", "speculative_round"]


def _filter_logits(logits, top_k: int, top_p: float, temperature: float,
                   min_p: float = 0.0):
    """fp32 logits with temperature, then everything outside the top k,
    the top-p nucleus and the min-p floor set to -inf. Applied to both the
    target's and the draft's logits, so that the ratio test compares the
    distributions the tokens are drawn from."""
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / temperature
    neg_inf = float("-inf")
    if top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]),
                         dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg_inf)
    if 0.0 < top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        cum = sorted_logits.softmax(dim=-1).cumsum(dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(
            max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, neg_inf)
    if min_p > 0.0:
        probs = logits.softmax(dim=-1)
        pmax = probs.amax(dim=-1, keepdim=True)
        logits = logits.masked_fill(probs < min_p * pmax, neg_inf)
    return logits


def sample_speculative(logits, logits_draft, tokens_draft,
                       generator: Optional[torch.Generator] = None,
                       top_k: int = 1, top_p: float = 0.0,
                       temperature: float = 1.0, min_p: float = 0.0):
    """Vectorised acceptance over the batch, with no host read.

    logits (b, k+1, vocab): the target's after each of [cur, p_1..p_k];
    logits_draft (b, k, vocab): the draft's after each of [cur,
    p_1..p_{k-1}]; tokens_draft (b, k): the proposals p_1..p_k. Returns
    (tokens (b, k+1) int64, of which the first ``num`` of a row are valid,
    num (b,) int64 in [1, k+1])."""
    b, k1, vocab = logits.shape
    k = k1 - 1
    tokens_draft = tokens_draft.long()
    greedy = top_k == 1 and top_p == 0.0
    if greedy:  # each distribution the one-hot of its argmax
        best = logits.argmax(dim=-1)                          # (b, k+1)
        accepted = tokens_draft == best[:, :-1]
    else:
        pt = _filter_logits(logits, top_k, top_p, temperature,
                            min_p).softmax(-1)
        pd = _filter_logits(logits_draft, top_k, top_p, temperature,
                            min_p).softmax(-1)
        u = torch.rand((b, k), generator=generator, device=logits.device)
        p_draft = pd.gather(-1, tokens_draft[..., None])[..., 0]
        p_target = pt[:, :-1].gather(-1, tokens_draft[..., None])[..., 0]
        accepted = u * p_draft <= p_target
    first_rej = torch.where(accepted.all(dim=-1), k,
                            accepted.int().argmin(dim=-1))
    if greedy:
        fill = best.gather(1, first_rej[:, None])[:, 0]
    else:
        # the resampling distribution at the first rejection; the bonus
        # token's (the target's last) when every proposal was accepted
        resample_probs = torch.cat([(pt[:, :-1] - pd).clamp(min=0.0),
                                    pt[:, -1:]], dim=1)
        at = first_rej[:, None, None].expand(b, 1, vocab)
        at_rej = resample_probs.gather(1, at)[:, 0]
        # p_t - p_d is all zero where the two distributions agree: draw
        # from the target's distribution there
        at_rej = torch.where(at_rej.sum(-1, keepdim=True) > 0, at_rej,
                             pt.gather(1, at)[:, 0])
        fill = torch.multinomial(at_rej, 1, generator=generator)[:, 0]
    tokens = torch.cat([tokens_draft, tokens_draft.new_zeros((b, 1))], 1)
    hit = torch.arange(k + 1, device=logits.device)[None] == first_rej[:, None]
    return torch.where(hit, fill[:, None], tokens), first_rej + 1


def _rewind_cache(cache, delta) -> None:
    """Subtract delta, an int or a (b,) tensor, from every layer's offsets,
    in place."""
    if torch.is_tensor(delta):
        delta = delta.to(cache[0].offset.device, torch.int32)
    for layer in cache:
        layer.offset -= delta


def speculative_round(target_model, draft_model, t_cache, d_cache, cur,
                      prev2, active, k: int, cfg: GenerationConfig,
                      generator: Optional[torch.Generator] = None,
                      block_table=None):
    """One round of every row, with no host read: the draft, fed (prev2,
    cur) and then its own proposals, proposes k tokens from the filtered
    distribution that the acceptance test uses; the target verifies [cur] +
    proposals in one decode call (sq = k+1, over ``block_table`` when its
    cache is paged); ``sample_speculative`` keeps each row's run; both
    caches are rewound in place. Returns (tokens (b, k+1), num (b,)), the
    first num of a row committed.

    The target appended k+1 entries and keeps num; the draft appended k+1
    ([prev2, cur, p_1..p_{k-1}]) and goes back to the committed tokens but
    two. Rows not ``active`` rewind all they appended, so that their cache
    rows never grow."""
    feed = torch.stack([prev2, cur], dim=1)
    proposals, d_logits = [], []
    for _ in range(k):
        dl = draft_model(feed, mode="decode", cache=d_cache)[:, -1]
        nxt = sample_token(dl, generator, cfg)
        proposals.append(nxt)
        d_logits.append(dl)
        feed = nxt[:, None]
    tokens_draft = torch.stack(proposals, dim=1)                # (b, k)
    logits = target_model(torch.cat([cur[:, None], tokens_draft], 1),
                          mode="decode", cache=t_cache,
                          block_table=block_table)
    tokens, num = sample_speculative(
        logits, torch.stack(d_logits, dim=1), tokens_draft, generator,
        top_k=cfg.top_k, top_p=cfg.top_p, temperature=cfg.temperature,
        min_p=cfg.min_p)
    delta = torch.where(active, k + 1 - num, k + 1)
    _rewind_cache(t_cache, delta)
    _rewind_cache(d_cache, delta)
    return tokens, num


@torch.inference_mode()
def decode_speculative(input_ids, target_model, draft_model,
                       cfg: GenerationConfig, speculative_k: int = 4,
                       generator: Optional[torch.Generator] = None):
    """Speculative decoding of (b, prompt_len) prompts, greedy or sampled,
    b >= 1, both models on linear caches.

    Returns (sequences (b, max_length) int64, padded with eos_token_id or 0
    past each row's end, and the number of target forwards, the prefill
    included). The draft cache holds the committed tokens but the last
    two at every round start: the round feeds those two first, so that
    every rewind stays non-negative even when all k proposals are
    accepted (the draft never saw p_k)."""
    b, prompt_len = input_ids.shape
    max_len = cfg.max_length
    k = speculative_k
    device = input_ids.device
    greedy = cfg.top_k == 1 and cfg.top_p == 0.0
    if generator is None and not greedy:
        generator = torch.Generator(device=device).manual_seed(0)

    t_cache = target_model.allocate_cache(b)
    d_cache = draft_model.allocate_cache(b)
    last = torch.full((b,), prompt_len - 1, dtype=torch.long, device=device)
    logits_last = target_model(input_ids, mode="prefill", cache=t_cache,
                               logits_positions=last)[:, -1]
    if prompt_len > 1:
        draft_model.transformer(input_ids[:, :-1], mode="prefill",
                                cache=d_cache)
    if greedy:
        first_tok = logits_last.argmax(dim=-1)
    else:
        first_tok = torch.multinomial(_filter_logits(
            logits_last, cfg.top_k, cfg.top_p, cfg.temperature,
            cfg.min_p).softmax(-1), 1, generator=generator)[:, 0]
    num_target_calls = 1

    ids_np = input_ids.cpu().numpy()
    seqs = [list(map(int, row)) + [int(t)]
            for row, t in zip(ids_np, first_tok.cpu().numpy())]
    done = [False] * b
    cur = first_tok.long()                      # (b,) last committed token
    prev2 = input_ids[:, -1].long()             # (b,) the one before it
    while not all(done) and min(len(s) for s in seqs) < max_len:
        active = torch.as_tensor([not d for d in done], device=device)
        tokens, num = speculative_round(
            target_model, draft_model, t_cache, d_cache, cur, prev2, active,
            k, cfg, generator)
        num_target_calls += 1
        tokens_np, num_np = tokens.cpu().numpy(), num.cpu().numpy()
        for i in range(b):
            if not done[i]:
                commit = [int(x) for x in tokens_np[i, :int(num_np[i])]]
                commit = commit[:max_len - len(seqs[i])]
                seqs[i].extend(commit)
                if (cfg.eos_token_id is not None
                        and cfg.eos_token_id in commit) \
                        or len(seqs[i]) >= max_len:
                    done[i] = True
        cur = torch.as_tensor([s[-1] for s in seqs], device=device)
        prev2 = torch.as_tensor([s[-2] for s in seqs], device=device)

    out = np.full((b, max_len), cfg.eos_token_id or 0, np.int64)
    for i, row in enumerate(seqs):
        out[i, :len(row)] = row[:max_len]
    return torch.from_numpy(out).to(device), num_target_calls
