"""Continuous-batching inference engine (port of
flash_attn_tpu/serving/engine.py ``Request``, ``PagePool`` and
``InferenceEngine``).

Requests are admitted into free KV-cache slots as others finish, with no
barrier between sequences. Admission runs one slot-mapped prefill that
writes only the admitted slots' cache rows (or pages); decoding runs all
slots in blocks of ``decode_block_size`` steps, the sampled token fed back
on the device with no host sync inside a block. Over a paged cache a
``PagePool`` hands out pages (page 0 is the null page), and with
``prefix_cache`` full prompt pages are chain-hashed and shared, so that
admission prefills only each prompt's suffix through the paged-varlen
kernel. Where the JAX engine jits its prefill and its decode block, this
one runs them eagerly; capturing the decode block in a CUDA graph is
ROADMAP.md queue A, item 3b.
"""

import dataclasses
import hashlib
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flash_attn_tpu_torch.serving.generation import (
    GenerationConfig,
    sample_token,
)
from flash_attn_tpu_torch.utils.device import resolve_device

__all__ = ["InferenceEngine", "PagePool", "Request"]


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int = 64
    # filled by the engine:
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class PagePool:
    """Free-list page allocator of the paged KV cache, on the host.

    Page 0 is the null page and is never allocated: every block-table entry
    that owns no page points there, so the writes that cannot be skipped
    (the decode block's appends for inactive slots, any write past a slot's
    allocation) land in memory that holds no sequence. Shared pages are
    refcounted; a page whose count drops to zero but that backs a
    registered prefix is retained (an insertion-ordered dict, so least
    recently released first) and reclaimed under pool pressure through
    ``evict_cb``."""

    def __init__(self, num_pages: int, page_size: int, max_pages_per_seq: int,
                 max_batch: int):
        self.page_size = page_size
        self.free = list(range(1, num_pages))  # page 0 = null page
        self.table = np.zeros((max_batch, max_pages_per_seq), np.int32)
        self.pages_of: Dict[int, List[int]] = {}
        self.rc: Dict[int, int] = {}
        self.retained: Dict[int, None] = {}
        self.protected: set = set()   # pages backing prefix-index entries
        self.evict_cb = None          # called with the page id on eviction

    def _take_free(self):
        if self.free:
            return self.free.pop()
        if self.retained:
            pg = next(iter(self.retained))
            del self.retained[pg]
            self.protected.discard(pg)
            if self.evict_cb is not None:
                self.evict_cb(pg)
            return pg
        return None

    def alloc(self, slot: int, tokens_needed: int) -> bool:
        """Ensure ``slot`` has pages covering ``tokens_needed``; False when
        the pool or the slot's table row runs out."""
        have = len(self.pages_of.get(slot, []))
        need = -(-tokens_needed // self.page_size)
        if need > self.table.shape[1]:
            return False
        while have < need:
            pg = self._take_free()
            if pg is None:
                return False
            self.rc[pg] = 1
            self.pages_of.setdefault(slot, []).append(pg)
            self.table[slot, have] = pg
            have += 1
        return True

    def share(self, slot: int, pages: List[int]):
        """Attach resident pages (a cached prefix) to a fresh slot: count
        them once more and revive retained ones. Precedes alloc()."""
        assert not self.pages_of.get(slot)
        for i, pg in enumerate(pages):
            if pg in self.retained:
                del self.retained[pg]
            self.rc[pg] = self.rc.get(pg, 0) + 1
            self.pages_of.setdefault(slot, []).append(pg)
            self.table[slot, i] = pg

    def release(self, slot: int):
        for pg in self.pages_of.pop(slot, []):
            self.rc[pg] = self.rc.get(pg, 1) - 1
            if self.rc[pg] > 0:
                continue
            del self.rc[pg]
            if pg in self.protected:
                self.retained[pg] = None   # kept warm for prefix reuse
            else:
                self.free.append(pg)
        self.table[slot, :] = 0  # back to the null page


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


class InferenceEngine:
    """Continuous batching of ``model`` (a GPTLMHeadModel, whose weights it
    uses as they are) over ``max_batch`` cache slots.

    ``page_pool`` selects the paged cache (the model's configuration must
    set ``paged_kv_num_pages`` and ``paged_kv_page_size`` to the pool's).
    ``max_admit_tokens`` caps rows x padded length of one admission
    prefill; ``bucket_admission`` pads admissions to power-of-two rows
    (with zero-length dummies on free slots) and lengths (>= 16), recording
    the shapes in ``prefill_shapes``. ``decode_block_size`` n decodes n
    tokens per host round trip. ``generator`` drives sampling (greedy needs
    none). ``device`` defaults to the CUDA card and raises without one; the
    model must live there. A draft model (speculative rounds) is not ported
    yet and raises NotImplementedError."""

    def __init__(self, model, max_batch: int, gen_cfg: GenerationConfig,
                 generator: Optional[torch.Generator] = None,
                 page_pool: Optional[PagePool] = None,
                 max_admit_tokens: Optional[int] = None,
                 bucket_admission: bool = True,
                 decode_block_size: int = 1,
                 prefix_cache: bool = False, draft_model=None, device=None):
        if draft_model is not None:
            raise NotImplementedError(
                "InferenceEngine: speculative rounds (draft_model=) and "
                "serving/speculative.py are not ported yet: ROADMAP.md "
                "queue A, item 3a")
        self.device = resolve_device(device)
        weights = next(model.parameters())
        if weights.device.type != self.device.type:
            raise ValueError(f"InferenceEngine on {self.device}, model "
                             f"weights on {weights.device}")
        cfg = model.config
        if (page_pool is not None) != (cfg.paged_kv_num_pages > 0) or (
                page_pool is not None
                and page_pool.page_size != cfg.paged_kv_page_size):
            raise ValueError(
                "InferenceEngine: a page pool needs a model configured for "
                "the same paged cache (paged_kv_num_pages, "
                "paged_kv_page_size), and a paged model needs a pool")
        self.model = model
        self.B = max_batch
        self.cfg = gen_cfg
        self.generator = generator
        self.pool = page_pool
        self.max_admit_tokens = max_admit_tokens
        self.bucket_admission = bucket_admission
        self.prefill_shapes: set = set()
        self.decode_block = max(1, decode_block_size)

        self.queue: deque = deque()
        self.requests: Dict[int, Request] = {}
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.slot_tok = np.zeros((max_batch,), np.int32)
        self.slot_new = np.zeros((max_batch,), np.int32)  # generated count
        self._next_id = 0
        self.cache = None
        # The decode block dispatched at step k is read at step k + 1, after
        # block k + 1 is dispatched: the device feeds the last token of
        # block k into block k + 1, and the copy of block k's tokens to the
        # host overlaps block k + 1. _pending = (tokens on the device, their
        # host copy, the event that completes it, the slot -> request
        # snapshot at dispatch).
        self._pending = None
        self._table_dev = None  # device copy of pool.table (see _table)
        self.prefix_cache = prefix_cache
        if prefix_cache:
            if page_pool is None:
                raise ValueError("prefix_cache needs a page pool")
            self._prefix_index: Dict[bytes, int] = {}
            self._page_keys: Dict[int, bytes] = {}
            self.prefix_hit_pages = 0
            index, page_keys = self._prefix_index, self._page_keys

            def _evict(pg):
                key = page_keys.pop(pg, None)
                if key is not None and index.get(key) == pg:
                    del index[key]

            page_pool.evict_cb = _evict

    # ------------------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy goes
        through pinned memory without blocking the host, so that an upload
        made while a decode block runs does not wait for it."""
        t = torch.from_numpy(np.array(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _prefix_keys(self, prompt: np.ndarray):
        """Chain hash per FULL prompt page (key i commits to pages 0..i)."""
        ps = self.pool.page_size
        keys = []
        key = b""
        for i in range(len(prompt) // ps):
            h = hashlib.sha1(key)
            h.update(np.ascontiguousarray(
                prompt[i * ps:(i + 1) * ps], dtype=np.int32).tobytes())
            key = h.digest()
            keys.append(key)
        return keys

    def _match_prefix(self, keys):
        """Longest cached run of pages for this chain (resident or
        retained)."""
        pages = []
        for key in keys:
            pg = self._prefix_index.get(key)
            if pg is None:
                break
            pages.append(pg)
        return pages

    def _register_prefix(self, slot, keys):
        for i, key in enumerate(keys):
            pg = self.pool.pages_of[slot][i]
            if key not in self._prefix_index:
                self._prefix_index[key] = pg
                self._page_keys[pg] = key
                self.pool.protected.add(pg)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _prefill(self, ids, slot_ids, lengths, prefixes):
        """One admission prefill; returns the first token of every row."""
        lengths_dev = self._upload(lengths)
        logits = self.model(
            self._upload(ids), mode="prefill", cache=self.cache,
            slot_ids=self._upload(slot_ids), prefill_lengths=lengths_dev,
            logits_positions=lengths_dev - 1, block_table=self._table(),
            prefix_lengths=None if prefixes is None else self._upload(prefixes))
        return sample_token(logits[:, 0], self.generator, self.cfg)

    @torch.no_grad()
    def _decode_block_fn(self, toks):
        """decode_block_size decode steps of every slot, each step's token
        fed to the next on the device; returns the tokens (n, B)."""
        table = self._table()
        ys = []
        for _ in range(self.decode_block):
            logits = self.model(toks[:, None], mode="decode", cache=self.cache,
                                block_table=table)
            toks = sample_token(logits[:, -1], self.generator, self.cfg)
            ys.append(toks)
        return torch.stack(ys)

    def warmup(self, prefill_shapes=None):
        """Run the admission prefill at the given (rows, padded_len) shapes
        and one decode block before traffic, on zero-length dummy rows of
        free slots, leaving the engine's state as it was (offsets re-zeroed
        afterwards). The default shape is the full-budget one that bucketed
        admission gives under ``max_admit_tokens``. Eagerly run, this warms
        the kernels' build and PyTorch's allocator; graph capture per shape
        is ROADMAP.md queue A, item 3b."""
        if self.cache is None:
            self._init_cache()
        if prefill_shapes is None:
            cap = getattr(getattr(self.model, "config", None),
                          "max_decode_seqlen", 0) or 512
            plen = _next_pow2(max(16, cap - self.decode_block - 16))
            rows = self.B
            if self.max_admit_tokens is not None:
                rows = max(1, self.max_admit_tokens // plen)
            rows = min(_next_pow2(rows), self.B)
            prefill_shapes = [(rows, plen)]
        for rows, plen in prefill_shapes:
            self._prefill(np.zeros((rows, plen), np.int32),
                          np.arange(rows, dtype=np.int32),
                          np.zeros((rows,), np.int32), None)
            self.prefill_shapes.add((rows, plen))
        # decode block: the appends land on inactive slots (the null page,
        # or position 0), which any real admission overwrites
        self._decode_block_fn(self._upload(self.slot_tok))
        self._set_inactive_offsets_zero()

    def reset(self):
        """Clear all requests and slots but keep the cache tensors."""
        if self.pool is not None:
            for slot in list(self.pool.pages_of):
                self.pool.release(slot)
            self._table_dev = None
        self.queue.clear()
        self.requests.clear()
        self._pending = None
        self.slots = [None] * self.B
        self.slot_tok[:] = 0
        self.slot_new[:] = 0
        if self.cache is not None:
            self._set_inactive_offsets_zero()

    def close(self):
        """Release the KV cache."""
        self.cache = None
        self.reset()

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 64) -> int:
        req = Request(self._next_id, np.asarray(prompt, np.int32),
                      max_new_tokens)
        self._next_id += 1
        self.queue.append(req)
        self.requests[req.req_id] = req
        return req.req_id

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _offsets(self) -> np.ndarray:
        return self.cache[0].offset.cpu().numpy()

    @torch.no_grad()
    def _set_inactive_offsets_zero(self):
        active = self._upload(np.array([r is not None for r in self.slots]))
        for layer in self.cache:
            layer.offset.masked_fill_(~active, 0)

    def _table(self):
        # device table cached between admission and release events: a
        # fresh upload per step would put a copy on the decode path
        if self.pool is None:
            return None
        if self._table_dev is None:
            self._table_dev = self._upload(self.pool.table)
        return self._table_dev

    def _init_cache(self):
        self.cache = self.model.allocate_cache(self.B)

    # ------------------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """One engine step: admit queued requests into free slots (one
        prefill), dispatch one decode block for all active slots, then
        process the PREVIOUS step's block, whose tokens reached the host
        while this one was dispatched. Returns the (req_id, token) pairs
        emitted this step; decode tokens lag dispatch by one step."""
        if self.cache is None:
            self._init_cache()
        emitted: List[Tuple[int, int]] = []

        # ---- admission ----
        free = self._free_slots()
        # admit tuples: (slot, request, shared_prefix_tokens, chain_keys)
        admit: List[Tuple[int, Request, int, list]] = []
        # in-batch sharing: chain keys of rows admitted in this batch resolve
        # to their freshly allocated pages; every row's KV write completes
        # before any row's attention reads in the one prefill call
        batch_keys: Dict[bytes, int] = {}
        while free and self.queue:
            req = self.queue[0]
            slot = free[0]
            keys: list = []
            shared_pages: List[int] = []
            if self.prefix_cache:
                keys = self._prefix_keys(req.prompt)
                shared_pages = self._match_prefix(keys)
                if len(shared_pages) < len(keys):
                    for key in keys[len(shared_pages):]:
                        pg = batch_keys.get(key)
                        if pg is None:
                            break
                        shared_pages.append(pg)
                # never share ALL the prompt's pages of a page-aligned
                # prompt: the suffix must keep >= 1 token so that the
                # prefill gives this request's first logits
                max_share = (len(req.prompt) - 1) // self.pool.page_size
                shared_pages = shared_pages[:max_share]
            n_shared = len(shared_pages) * (self.pool.page_size
                                            if self.pool else 0)
            suffix = len(req.prompt) - n_shared
            if self.max_admit_tokens is not None and admit:
                # the padded prefill costs rows * max_len: admit the request
                # only if the padded batch stays within the token budget
                max_len = max(suffix,
                              max(len(r.prompt) - ns
                                  for _, r, ns, _k in admit))
                if self.bucket_admission:
                    max_len = _next_pow2(max(max_len, 16))
                if (len(admit) + 1) * max_len > self.max_admit_tokens:
                    break  # admit the rest next step
            if self.pool is not None:
                # a request that finishes mid-block decodes on until the
                # next dispatch sees it gone: n - 1 wasted steps plus one
                # stale block
                margin = 2 * self.decode_block - 1
                if shared_pages:
                    self.pool.share(slot, shared_pages)
                if not self.pool.alloc(
                        slot, len(req.prompt) + req.max_new_tokens + margin):
                    self.pool.release(slot)
                    break  # out of pages: wait for completions
                if shared_pages:
                    # counted once the request is in: a failed alloc
                    # retries the same hit next step
                    self.prefix_hit_pages += len(shared_pages)
            free.pop(0)
            self.queue.popleft()
            admit.append((slot, req, n_shared, keys))
            self._table_dev = None
            if self.prefix_cache:
                pages = self.pool.pages_of.get(slot, [])
                for i, key in enumerate(keys):
                    if i < len(pages):
                        batch_keys.setdefault(key, pages[i])
        if admit:
            rows = len(admit)
            max_len = max(len(r.prompt) - ns for _, r, ns, _k in admit)
            dummies: List[int] = []
            if self.bucket_admission:
                # rows -> next pow2 with zero-length dummies on still-free
                # slots (they write nothing: new_lengths masks the paged
                # writes and the slot's offset stays 0); length -> next
                # pow2 (>= 16), never past the model's cache length
                want = _next_pow2(rows)
                dummies = free[:want - rows]
                pad_len = _next_pow2(max(max_len, 16))
                cap = getattr(getattr(self.model, "config", None),
                              "max_decode_seqlen", 0)
                if cap:
                    pad_len = min(pad_len, max(cap, max_len))
                max_len = pad_len
            rows_p = rows + len(dummies)
            ids = np.zeros((rows_p, max_len), np.int32)
            lengths = np.zeros((rows_p,), np.int32)
            prefixes = np.zeros((rows_p,), np.int32)
            slot_ids = np.asarray(
                [s for s, _r, _n, _k in admit] + dummies, np.int32)
            for j, (slot, req, n_shared, _keys) in enumerate(admit):
                suffix = req.prompt[n_shared:]
                ids[j, :len(suffix)] = suffix
                lengths[j] = len(suffix)
                prefixes[j] = n_shared
                self.slots[slot] = req
                self.slot_new[slot] = 0
            self.prefill_shapes.add((rows_p, max_len))
            nxt = self._prefill(ids, slot_ids, lengths,
                                prefixes if self.prefix_cache else None)
            if self.prefix_cache:
                # register this batch's FULL prompt pages for future reuse
                for slot, req, _n, keys in admit:
                    self._register_prefix(slot, keys)
            nxt = nxt.cpu().numpy()
            for j, (slot, req, _n, _keys) in enumerate(admit):
                tok = int(nxt[j])
                req.generated.append(tok)
                self.slot_tok[slot] = tok
                self.slot_new[slot] = 1
                emitted.append((req.req_id, tok))
                self._maybe_finish(slot, req, tok)

        # ---- dispatch this step's decode block BEFORE reading the
        # previous one: block k's last tokens feed block k + 1 on the
        # device; newly admitted slots' prefill tokens are merged in ----
        new_pending = None
        if any(r is not None for r in self.slots):
            if self._pending is None:
                toks = self._upload(self.slot_tok).long()
            else:
                toks = self._pending[0][-1].clone()
                if admit:
                    idx = np.asarray([s for s, _r, _n, _k in admit], np.int64)
                    toks[self._upload(idx)] = self._upload(
                        self.slot_tok[idx]).long()
            ys = self._decode_block_fn(toks)
            # start the copy to the host now: it runs as soon as the block
            # completes, so the next step finds the tokens there
            if self.device.type == "cuda":
                host = torch.empty(ys.shape, dtype=ys.dtype, pin_memory=True)
                host.copy_(ys, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = ys, None
            new_pending = (ys, host, done, list(self.slots))

        # ---- process the PREVIOUS block. Tokens are attributed by the
        # slot -> request snapshot taken at ITS dispatch (a slot may since
        # have finished and been re-admitted). A request that finishes
        # mid-block keeps decoding until the next dispatch sees it gone;
        # the tail tokens are discarded, and admission reserved the 2n - 1
        # page margin for them ----
        if self._pending is not None:
            _ys_dev, host, done, snap = self._pending
            if done is not None:
                done.synchronize()
            ys = host.numpy()  # (n, B)
            finished: List[int] = []
            for t in range(ys.shape[0]):
                for slot, req in enumerate(snap):
                    if req is None or req.done or self.slots[slot] is not req:
                        continue
                    tok = int(ys[t, slot])
                    req.generated.append(tok)
                    self.slot_tok[slot] = tok
                    self.slot_new[slot] += 1
                    emitted.append((req.req_id, tok))
                    self._maybe_finish(slot, req, tok, defer=finished)
            if finished:
                for slot in finished:
                    self.slots[slot] = None
                    if self.pool is not None:
                        self.pool.release(slot)
                        self._table_dev = None
                # offsets of freed slots are reset before any reuse; steps
                # where nothing finishes skip it
                self._set_inactive_offsets_zero()
        self._pending = new_pending
        return emitted

    def _maybe_finish(self, slot: int, req: "Request", tok: int, defer=None):
        eos = self.cfg.eos_token_id
        if (eos is not None and tok == eos) or (
                self.slot_new[slot] >= req.max_new_tokens):
            req.done = True
            if defer is not None:
                defer.append(slot)
                return
            self.slots[slot] = None
            if self.pool is not None:
                self.pool.release(slot)
                self._table_dev = None

    def cancel(self, req_id: int) -> bool:
        """Cancel a request: drop it from the queue, or release its slot
        (tokens decoded meanwhile are discarded like a post-eos tail).
        Returns False for unknown or finished ids."""
        req = self.requests.get(req_id)
        if req is None or req.done:
            return False
        req.done = True  # processing skips done requests
        for i, qreq in enumerate(self.queue):
            if qreq.req_id == req_id:
                del self.queue[i]
                return True
        for slot, sreq in enumerate(self.slots):
            if sreq is req:
                self.slots[slot] = None
                if self.pool is not None:
                    self.pool.release(slot)
                    self._table_dev = None
                self._set_inactive_offsets_zero()
                break
        return True

    def stats(self) -> Dict[str, object]:
        """Slot and pool occupancy, admission shapes, prefix-cache hits."""
        out: Dict[str, object] = {
            "active_slots": sum(s is not None for s in self.slots),
            "max_batch": self.B,
            "queued": len(self.queue),
            "prefill_shapes": sorted(self.prefill_shapes),
            "pending_block": self._pending is not None,
        }
        if self.pool is not None:
            out.update(
                pool_free_pages=len(self.pool.free),
                pool_retained_pages=len(self.pool.retained),
                pool_active_pages=len(self.pool.rc),
            )
        if self.prefix_cache:
            out.update(prefix_hit_pages=self.prefix_hit_pages,
                       prefix_index_entries=len(self._prefix_index))
        return out

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Run until the queue and the slots drain; returns {req_id:
        generated}."""
        for _ in range(max_steps):
            if (not self.queue and self._pending is None
                    and all(r is None for r in self.slots)):
                break
            self.step()
        return {rid: r.generated for rid, r in self.requests.items()}
