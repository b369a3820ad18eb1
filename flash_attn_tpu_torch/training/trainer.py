"""Single-GPU training of the GPT: train step, optimizer, checkpoint/resume.

Port of flash_attn_tpu/training/trainer.py for one device: ``TrainConfig``
(:43), ``model_flops_per_token`` (:97), the four LR schedules and the optax
chain clip_by_global_norm -> AdamW (fp32 moments, as ``optax.adamw``) or
``adamw_bf16`` (bf16 moments with the same stochastic rounding, :115-191),
gradient accumulation in fp32, dynamic loss scaling, EMA, ``fit``,
``evaluate``, ``causality_check`` and checkpoints with exact resume.
``data_parallel``, ``model_parallel`` and ``seq_parallel`` above 1 raise
NotImplementedError (ROADMAP.md queue A, item 8); ``zero1``/``zero2`` are
no-ops on one device, as in JAX at dp = 1.

Weights: the model keeps its Dense and embedding weights in the compute
type, as serving does. The Trainer keeps an fp32 master copy of every
parameter, updates the masters, and after each update writes them back into
the module by round-to-nearest: the cast flax makes at every call. JAX
differentiates through that cast, so the gradient of a Dense kernel comes
out of a dot in the compute type and is then cast to fp32; upcasting the
module's low-precision ``.grad`` loses nothing JAX keeps. The exception is
the tied embedding: autograd sums its two gradients (the lookup's and the
lm_head's) in the compute type, where JAX sums them in fp32.

Checkpoints are written with ``torch.save`` (masters, moments, loss scaler,
EMA, step count, sampler state); they are not orbax checkpoints and do not
move between the two packages.
"""

import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from flash_attn_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    _check_ported,
    jax_param_arrays,
    lm_head_weights,
)
from flash_attn_tpu_torch.ops.cross_entropy import (
    cross_entropy_loss,
    fused_linear_cross_entropy,
)
from flash_attn_tpu_torch.utils.device import resolve_device

__all__ = ["TrainConfig", "Trainer", "model_flops_per_token", "make_schedule"]


@dataclasses.dataclass
class TrainConfig:
    model: GPTConfig = dataclasses.field(default_factory=GPTConfig)
    batch_size: int = 8
    seqlen: int = 1024
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    # cosine (default) | linear | constant | step (decay 10x at 60%/85% of
    # total), all after a linear warmup from 0
    lr_schedule: str = "cosine"
    grad_clip: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    data_parallel: int = 1
    model_parallel: int = 1
    seq_parallel: int = 1
    # micro-batches per step, their fp32 gradients averaged
    accumulate_steps: int = 1
    zero1: bool = True
    zero2: bool = False
    # fused lm_head + chunked cross-entropy: no (b, s, vocab) logits
    fused_ce: bool = True
    fused_ce_chunk: int = 4096
    ema_decay: float = 0.0   # 0 disables
    # dynamic loss scaling for fp16 training; 0 disables (bf16 needs none)
    loss_scale_init: float = 0.0
    loss_scale_growth_interval: int = 200
    # Adam moment storage: "float32" or "bfloat16" (stochastic rounding)
    opt_state_dtype: str = "float32"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 500
    log_every: int = 10
    seed: int = 0


def model_flops_per_token(cfg: GPTConfig, seqlen: int) -> float:
    """6*N + attention flops (the reference's flop_count.py MFU recipe)."""
    n_params = (
        cfg.n_layer * (
            cfg.n_embd * (cfg.n_embd + 2 * (cfg.n_head_kv or cfg.n_head)
                          * (cfg.n_embd // cfg.n_head))
            + cfg.n_embd * cfg.n_embd
            + (3 if cfg.glu_act else 2) * cfg.n_embd
            * (cfg.n_inner or 4 * cfg.n_embd)
        )
        + cfg.vocab_size * cfg.n_embd
    )
    attn = 12 * cfg.n_layer * cfg.n_embd * seqlen / 2  # causal
    return 6 * n_params + attn


# ---------------------------------------------------------------------------
# LR schedules: optax's, as functions of the update count (the first update
# uses schedule(0), which is 0 during warmup).

def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float):
    if decay_steps <= 0:
        raise ValueError(f"cosine schedule needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count):
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps)
                                     / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def _piecewise(init: float, boundaries_and_scales: Dict[int, float]):
    def schedule(count):
        v = init
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if count >= threshold:
                v = v * scale
        return v
    return schedule


def _join(schedules, boundaries):
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return schedule


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The LR at each update count, as trainer.py:212-234 builds it."""
    warmup = _linear(0.0, cfg.lr, cfg.warmup_steps)
    if cfg.lr_schedule == "cosine":
        alpha = 0.0 if cfg.lr == 0.0 else 0.1
        tail = _cosine(cfg.lr, cfg.total_steps - cfg.warmup_steps, alpha)
    elif cfg.lr_schedule == "linear":
        tail = _linear(cfg.lr, cfg.lr * 0.1, cfg.total_steps - cfg.warmup_steps)
    elif cfg.lr_schedule == "constant":
        tail = lambda count: cfg.lr  # noqa: E731
    elif cfg.lr_schedule == "step":
        tail = _piecewise(cfg.lr, {int(cfg.total_steps * 0.6): 0.1,
                                   int(cfg.total_steps * 0.85): 0.1})
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    return _join([warmup, tail], [cfg.warmup_steps])


# ---------------------------------------------------------------------------
# The optimizer.

def _mul32(h, c: int):
    """(h * c) mod 2^32 for int64 h in [0, 2^32) and a 32-bit constant c,
    in two 16-bit halves of c so that no product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _stochastic_round_bf16(x32, salt: int):
    """fp32 -> bf16 with unbiased stochastic rounding, bit-identical to the
    JAX package's (trainer.py:115): the dither is a xorshift-multiply hash
    of the value's bits and a per-step salt, computed here in int64 with the
    uint32 wrap-around made explicit."""
    bits = x32.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    h = bits ^ (bits >> 15)
    h = (_mul32(h, 0x9E3779B1) + salt) & 0xFFFFFFFF
    h = _mul32(h ^ (h >> 13), 0x85EBCA6B)
    rounded = (bits + (h & 0xFFFF)) & 0xFFFF0000
    rounded = torch.where(rounded >= 2 ** 31, rounded - 2 ** 32, rounded)
    y = rounded.to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x32), y, x32).to(torch.bfloat16)


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None):
        for name in ("data_parallel", "model_parallel", "seq_parallel"):
            if getattr(cfg, name) > 1:
                raise NotImplementedError(
                    f"TrainConfig.{name} > 1: multi-device training is "
                    "ROADMAP.md queue A, item 8")
        if cfg.opt_state_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"opt_state_dtype {cfg.opt_state_dtype!r}")
        _check_ported(cfg.model)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.schedule = make_schedule(cfg)
        self.model = GPTLMHeadModel(cfg.model, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.model.reset_parameters(gen)
        self.params = dict(self.model.named_parameters())
        self.step_count = 0
        self._set_masters({n: p.detach().float() for n, p in self.params.items()})
        self.scaler = ({"scale": float(cfg.loss_scale_init), "good_steps": 0}
                       if cfg.loss_scale_init > 0 else None)

    def _set_masters(self, masters: Dict[str, torch.Tensor]) -> None:
        """fp32 masters (copied), fresh optimizer state and EMA, and the
        module's weights rounded from the masters."""
        self.masters = {n: m.to(self.device, torch.float32, copy=True)
                        for n, m in masters.items()}
        moment = (torch.bfloat16 if self.cfg.opt_state_dtype == "bfloat16"
                  else torch.float32)
        self.opt_state = {
            "count": 0,
            "mu": {n: torch.zeros_like(m, dtype=moment)
                   for n, m in self.masters.items()},
            "nu": {n: torch.zeros_like(m, dtype=moment)
                   for n, m in self.masters.items()},
        }
        self.ema = ({n: m.clone() for n, m in self.masters.items()}
                    if self.cfg.ema_decay > 0 else None)
        self._write_weights(self.masters)

    @torch.no_grad()
    def _write_weights(self, values: Dict[str, torch.Tensor]) -> None:
        for name, p in self.params.items():
            p.copy_(values[name])

    def load_jax_params(self, params) -> None:
        """Start from a flax GPTLMHeadModel param tree (nested dicts of
        numpy arrays): the masters take its fp32 values, the module their
        rounding; the optimizer state starts afresh."""
        arrays = jax_param_arrays(self.model, params)
        self._set_masters({n: torch.from_numpy(np.array(a, dtype=np.float32))
                           for n, a in arrays.items()})

    # ------------------------------------------------------------------
    def compute_loss(self, input_ids, labels):
        """Mean token loss of one batch (trainer.py:283 compute_loss)."""
        cfg, mcfg = self.cfg, self.cfg.model
        if cfg.fused_ce:
            hidden = self.model.forward_hidden(input_ids)
            kernel, transpose = lm_head_weights(self.model)
            return fused_linear_cross_entropy(
                hidden.to(mcfg.dtype), kernel, labels,
                transpose_kernel=transpose, chunk_size=cfg.fused_ce_chunk,
                logit_scale=mcfg.mup_output_multiplier * mcfg.mup_width_scale)
        return cross_entropy_loss(self.model(input_ids), labels)

    def _grads(self, input_ids, labels):
        """(mean loss, fp32 grads by name) over the step's micro-batches,
        the loss scaled for the backward when a scaler is on."""
        a = self.cfg.accumulate_steps
        if input_ids.shape[0] % a:
            raise ValueError(f"batch {input_ids.shape[0]} does not split into "
                             f"{a} micro-batches")
        scale = self.scaler["scale"] if self.scaler is not None else None
        grads, loss_sum = None, 0.0
        for ids, labs in zip(input_ids.chunk(a), labels.chunk(a)):
            for p in self.params.values():
                p.grad = None
            loss = self.compute_loss(ids, labs)
            (loss * scale if scale is not None else loss).backward()
            loss_sum = loss_sum + loss.detach()
            g = {n: p.grad.float() for n, p in self.params.items()}
            grads = g if grads is None else {
                n: grads[n] + g[n] for n in grads}
        for p in self.params.values():
            p.grad = None
        if a > 1:
            grads = {n: g / a for n, g in grads.items()}
        if scale is not None:
            inv = 1.0 / scale
            grads = {n: g * inv for n, g in grads.items()}
        return loss_sum / a, grads

    @torch.no_grad()
    def _update(self, grads: Dict[str, torch.Tensor], gnorm) -> None:
        """clip_by_global_norm -> Adam(W) or adamw_bf16 -> apply, on the
        masters (optax's operation order)."""
        cfg, st = self.cfg, self.opt_state
        b1, b2, eps = cfg.adam_b1, cfg.adam_b2, 1e-8
        lr = self.schedule(st["count"])
        c = st["count"] + 1
        bc1, bc2 = 1.0 - b1 ** c, 1.0 - b2 ** c
        keep = gnorm < cfg.grad_clip
        bf16 = cfg.opt_state_dtype == "bfloat16"
        salt_mu = (c * 0x9E3779B9) & 0xFFFFFFFF
        salt_nu = salt_mu ^ 0x5851F42D
        for name, master in self.masters.items():
            g = torch.where(keep, grads[name], grads[name] / gnorm * cfg.grad_clip)
            mu = (1 - b1) * g + b1 * st["mu"][name].float()
            nu = (1 - b2) * g.square() + b2 * st["nu"][name].float()
            upd = (mu / bc1) / ((nu / bc2).sqrt() + eps)
            if bf16:
                mu = _stochastic_round_bf16(mu, salt_mu)
                nu = _stochastic_round_bf16(nu, salt_nu)
            st["mu"][name], st["nu"][name] = mu, nu
            upd = upd + cfg.weight_decay * master
            master.add_(upd * -lr)
        st["count"] = c

    def train_step(self, input_ids, labels):
        """One optimizer step on a (b, s) batch; returns (loss, grad norm)
        as device scalars (the norm of the unclipped, unscaled grads)."""
        loss, grads = self._grads(input_ids, labels)
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        if self.scaler is None:
            self._update(grads, gnorm)
        else:
            # torch GradScaler semantics, as the JAX step: non-finite grads
            # skip the update and halve the scale; after growth_interval
            # clean steps the scale doubles.
            finite = bool(torch.isfinite(gnorm))
            if finite:
                self._update(grads, gnorm)
            sc = self.scaler
            grown = sc["good_steps"] + 1 >= self.cfg.loss_scale_growth_interval
            if finite:
                sc["scale"] = sc["scale"] * 2.0 if grown else sc["scale"]
                sc["good_steps"] = 0 if grown else sc["good_steps"] + 1
            else:
                sc["scale"] = max(sc["scale"] * 0.5, 1.0)
                sc["good_steps"] = 0
        self._write_weights(self.masters)
        if self.ema is not None:
            d = self.cfg.ema_decay
            for name, e in self.ema.items():
                e.mul_(d).add_(self.masters[name], alpha=1 - d)
        return loss, gnorm

    def _batch(self, arr):
        return torch.from_numpy(np.asarray(arr)).to(self.device, torch.long)

    # ------------------------------------------------------------------
    def fit(self, dataloader, steps: Optional[int] = None,
            log_fn: Callable[[Dict[str, Any]], None] = None,
            val_dataloader=None, eval_every: int = 0, eval_steps: int = 20):
        """Train for ``steps`` (default total_steps) batches, logging loss,
        grad norm, tokens/s and TFLOP/s every log_every steps; checkpoints
        every ckpt_every steps and on an exception when ckpt_dir is set."""
        cfg = self.cfg
        steps = steps or cfg.total_steps
        log_fn = log_fn or (lambda m: print(json.dumps(m), flush=True))
        flops_per_token = model_flops_per_token(cfg.model, cfg.seqlen)
        tokens_per_step = cfg.batch_size * cfg.seqlen
        it = iter(dataloader)
        t_last = time.perf_counter()
        try:
            for _ in range(steps):
                inp, lab = next(it)
                loss, gnorm = self.train_step(self._batch(inp), self._batch(lab))
                self.step_count += 1
                if (val_dataloader is not None and eval_every > 0
                        and self.step_count % eval_every == 0):
                    vl = self.evaluate(val_dataloader, steps=eval_steps)
                    log_fn({"step": self.step_count, "val_loss": round(vl, 4)})
                if self.step_count % cfg.log_every == 0:
                    loss_v = float(loss)  # waits for the device
                    now = time.perf_counter()
                    dt = (now - t_last) / cfg.log_every
                    t_last = now
                    tps = tokens_per_step / dt
                    metrics = {
                        "step": self.step_count,
                        "loss": round(loss_v, 4),
                        "grad_norm": round(float(gnorm), 4),
                        "tokens_per_s": round(tps, 1),
                        "tflops_per_s": round(tps * flops_per_token / 1e12, 2),
                    }
                    if self.scaler is not None:
                        metrics["loss_scale"] = float(self.scaler["scale"])
                    log_fn(metrics)
                if cfg.ckpt_dir and self.step_count % cfg.ckpt_every == 0:
                    self.save_checkpoint(dataloader)
        except Exception:
            if cfg.ckpt_dir:
                self.save_checkpoint(dataloader, tag="crash")
            raise

    # ------------------------------------------------------------------
    @torch.no_grad()
    def causality_check(self, seqlen: int = 32,
                        splits=(1, 8, 16)) -> Dict[str, float]:
        """Max |delta logits| strictly before position k when the tokens at
        positions >= k change: exactly 0 for a causal model. Returns
        {"causality_leak_<k>": max_abs_delta}. The tokens come from a torch
        generator (seed 1234), not JAX's."""
        vocab = self.cfg.model.vocab_size
        gen = torch.Generator().manual_seed(1234)
        ids = torch.randint(0, vocab, (2, seqlen), generator=gen).to(self.device)
        base = self.model(ids)
        stats = {}
        for k in splits:
            if not 0 < k < seqlen:
                continue
            edited = ids.clone()
            edited[:, k:] = (ids[:, k:] + 7) % vocab
            alt = self.model(edited)
            stats[f"causality_leak_{k}"] = float(
                (alt[:, :k] - base[:, :k]).float().abs().max())
        return stats

    @torch.no_grad()
    def evaluate(self, dataloader, steps: int = 50) -> float:
        """Mean loss over ``steps`` batches, with the EMA weights when EMA
        is on; no parameter changes."""
        if self.ema is not None:
            self._write_weights(self.ema)
        try:
            total, it = 0.0, iter(dataloader)
            for _ in range(steps):
                inp, lab = next(it)
                total += float(self.compute_loss(self._batch(inp),
                                                 self._batch(lab)))
        finally:
            if self.ema is not None:
                self._write_weights(self.masters)
        return total / max(steps, 1)

    # ------------------------------------------------------------------
    def save_checkpoint(self, dataloader=None, tag: Optional[str] = None) -> str:
        """Write ``<ckpt_dir>/<tag or step_N>.pt`` and return its path."""
        path = os.path.join(os.path.abspath(self.cfg.ckpt_dir),
                            f"{tag or f'step_{self.step_count}'}.pt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        state = {"step": self.step_count, "masters": self.masters,
                 "opt_state": self.opt_state, "scaler": self.scaler,
                 "ema": self.ema}
        if dataloader is not None and hasattr(dataloader, "state_dict"):
            state["sampler"] = dataloader.state_dict()
        torch.save(state, path)
        return path

    def load_checkpoint(self, path: str, dataloader=None) -> None:
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.masters = state["masters"]
        self.opt_state = state["opt_state"]
        self.scaler = state["scaler"]
        self.ema = state["ema"]
        self.step_count = int(state["step"])
        self._write_weights(self.masters)
        if dataloader is not None and "sampler" in state:
            dataloader.load_state_dict(state["sampler"])
