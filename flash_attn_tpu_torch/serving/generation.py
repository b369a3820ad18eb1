"""Static-batch generation: prefill, then a token loop of decode steps
(port of flash_attn_tpu/serving/generation.py).

The JAX package runs the token loop as one jitted ``lax.while_loop``; the
port's counterpart on the card captures one decode step (the model
forward, ``sample_token``, the eos masking, the writes of the token and of
the scores) in a CUDA graph and replays it for every remaining position
(:mod:`flash_attn_tpu_torch.serving.graphs`; the reference's
``decode(cg=True)``). The step reads and writes only static buffers: the
KV caches, the current token, the position and the prompt length as device
scalars, the sequences, scores, eos flags and forced tokens. The model
keeps one such set and its graph, for one (batch, sampling config with
max_length, output_scores, teacher forcing), and replaces it when a call
changes them, as the reference's ``update_graph_cache`` does; each call's
prefill writes into those caches in place. On the CPU, or with
``cg=False``, the same step runs eagerly on fresh caches that the call
frees: the plain path and the graph's oracle."""

import dataclasses
from typing import List, Optional

import torch

from flash_attn_tpu_torch.serving.graphs import CapturedProgram

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


@dataclasses.dataclass
class _DecodeState:
    """The static buffers of one decode shape and the graph over them."""
    key: tuple                   # (b, cfg, output_scores, forced)
    cache: List                  # per-layer KVCache, filled by each prefill
    tok: torch.Tensor            # (b,) int64, the last token
    pos: torch.Tensor            # (1,) int64, the position it is written at
    prompt_len: torch.Tensor     # (1,) int64
    seqs: torch.Tensor           # (b, max_length) int64
    scores: Optional[torch.Tensor]   # (rows, b, vocab) fp32
    done: Optional[torch.Tensor]     # (b,) bool, eos reached
    teacher: Optional[torch.Tensor]  # (b, max_length) int64, forced tokens
    generator: Optional[torch.Generator]
    graph: Optional[CapturedProgram]


def _new_state(model, key, cache, score_rows: int, sampled: bool,
               graphed: bool, device) -> _DecodeState:
    b, cfg, output_scores, forced = key
    max_len = cfg.max_length

    def zeros(*shape, dtype=torch.long):
        return torch.zeros(shape, dtype=dtype, device=device)

    gen = torch.Generator(device=device) if sampled and graphed else None
    return _DecodeState(
        key=key, cache=cache, tok=zeros(b), pos=zeros(1),
        prompt_len=zeros(1), seqs=zeros(b, max_len),
        scores=(zeros(score_rows, b, model.config.vocab_size,
                      dtype=torch.float32) if output_scores else None),
        done=zeros(b, dtype=torch.bool) if cfg.eos_token_id is not None
        else None,
        teacher=zeros(b, max_len) if forced else None, generator=gen,
        graph=CapturedProgram(() if gen is None else (gen,))
        if graphed else None)


def _graphed_state(model, key, sampled: bool, device) -> _DecodeState:
    """The model's one graphed decode state: kept while calls keep its key,
    replaced, the old buffers and graph freed first, when the key changes
    (the reference's ``update_graph_cache``). The prompt length is not in
    the key: it is a device scalar that each prefill writes."""
    st = getattr(model, "_decode_state", None)
    if st is not None and st.key == key:
        return st
    model._decode_state = st = None
    st = _new_state(model, key, model.allocate_cache(key[0]),
                    key[1].max_length - 1, sampled, True, device)
    model._decode_state = st
    return st


def _decode_step(model, st: _DecodeState, cfg: GenerationConfig,
                 generator: Optional[torch.Generator]) -> None:
    """One token of every row, in place on ``st``'s buffers, with no host
    read: the step that a graph captures."""
    logits = model(st.tok[:, None], mode="decode", cache=st.cache)[:, -1]
    nxt = sample_token(logits, generator, cfg)
    if st.teacher is not None:
        nxt = st.teacher.index_select(1, st.pos)[:, 0]
    if st.done is not None:
        nxt = torch.where(st.done, cfg.eos_token_id, nxt)
        st.done |= nxt == cfg.eos_token_id
    st.seqs.index_copy_(1, st.pos, nxt[:, None])
    if st.scores is not None:
        st.scores.index_copy_(0, st.pos - st.prompt_len, logits[None])
    st.tok.copy_(nxt)
    st.pos += 1


@torch.inference_mode()
def decode(input_ids, model, cfg: GenerationConfig,
           generator: Optional[torch.Generator] = None,
           output_scores: bool = False, teacher_outputs=None,
           cg: Optional[bool] = None):
    """Prefill + token loop over ``model`` (a GPTLMHeadModel on a linear
    cache).

    Returns (sequences (b, max_length) int64, final length); with
    ``output_scores`` also the per-step logits (max_new_tokens, b, vocab)
    fp32, step t being the logits that produced token prompt_len + t
    (unreached steps are zero). ``teacher_outputs`` (b, >= max_length)
    forces the tokens. After the prefill token there are
    max_length - prompt_len - 1 decode steps, fewer when every row has
    emitted ``eos_token_id`` (read on the host after each step).

    ``cg`` (default: on the card) replays a CUDA graph of the decode step;
    ``cg=False`` runs the same step eagerly on fresh caches, the graph's
    oracle. The graph and its static buffers (a full KV cache) stay on the
    model for the next call with the same batch, config, output_scores and
    teacher forcing, whatever its prompt length; a call with another of
    these replaces them. The graph reads the model's weights where they lay
    when it was captured: after rebinding them
    (``load_state_dict(assign=True)``), set ``model._decode_state = None``.
    A sampling ``generator`` advances as it would eagerly; without one,
    sampling draws from a generator seeded with 0 at each call."""
    b, prompt_len = input_ids.shape
    max_len = cfg.max_length
    device = input_ids.device
    graphed = device.type == "cuda" if cg is None else cg
    if graphed and device.type != "cuda":
        raise ValueError("decode(cg=True) needs the input on the CUDA card")
    sampled = not (cfg.top_k == 1 and cfg.top_p == 0.0)
    if sampled and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    key = (b, cfg, output_scores, teacher_outputs is not None)
    if graphed:
        st = _graphed_state(model, key, sampled, device)
    else:  # fresh caches and buffers, freed when the call returns
        st = _new_state(model, key, model.new_cache(), max_len - prompt_len,
                        sampled, False, device)
    gen = generator
    if st.generator is not None:
        # the graph's registered generator takes over the caller's stream
        st.generator.set_state(generator.get_state())
        gen = st.generator

    last = torch.full((b,), prompt_len - 1, dtype=torch.long, device=device)
    logits = model(input_ids, mode="prefill", cache=st.cache,
                   logits_positions=last)[:, -1]
    tok = sample_token(logits, gen, cfg)
    if teacher_outputs is not None:
        st.teacher.copy_(teacher_outputs[:, :max_len])
        tok = st.teacher[:, prompt_len]
    st.seqs.zero_()
    st.seqs[:, :prompt_len] = input_ids
    st.seqs[:, prompt_len] = tok
    if output_scores:
        st.scores.zero_()
        st.scores[0] = logits
    eos = cfg.eos_token_id
    if eos is not None:
        st.done.copy_(tok == eos)
    st.tok.copy_(tok)
    st.pos.fill_(prompt_len + 1)
    st.prompt_len.fill_(prompt_len)

    pos = prompt_len + 1
    while pos < max_len and not (eos is not None and bool(st.done.all())):
        if graphed:
            st.graph(lambda: _decode_step(model, st, cfg, gen))
        else:
            _decode_step(model, st, cfg, gen)
        pos += 1
    if st.generator is not None:
        generator.set_state(st.generator.get_state())
    if output_scores:
        return st.seqs.clone(), pos, st.scores[:max_len - prompt_len].clone()
    return st.seqs.clone(), pos
