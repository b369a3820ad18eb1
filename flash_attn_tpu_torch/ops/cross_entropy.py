"""Cross-entropy loss with label smoothing, z-loss, ignore_index and
logit_scale, and the fused chunked lm_head + cross-entropy.

Port of flash_attn_tpu/ops/cross_entropy.py ``cross_entropy_loss`` (:25)
and ``fused_linear_cross_entropy`` (:61). The vocab-parallel loss (:149)
waits for tensor parallelism (ROADMAP.md queue A, item 8).
"""

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy_loss", "fused_linear_cross_entropy"]


def _token_losses(logits, labels, label_smoothing: float,
                  lse_square_scale: float, ignore_index: int):
    """Per-token losses and lse from fp32 logits (already scaled); ignored
    positions give 0."""
    lse = torch.logsumexp(logits, dim=-1)
    lab = labels.clamp(0, logits.shape[-1] - 1)
    logit_label = logits.gather(-1, lab[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        losses = (lse - (1 - label_smoothing) * logit_label
                  - label_smoothing * logits.mean(-1))
    else:
        losses = lse - logit_label
    losses = losses + lse_square_scale * lse.square()
    return torch.where(labels != ignore_index, losses, 0.0), lse


def _reduce(losses, labels, ignore_index: int, reduction: str):
    if reduction == "none":
        return losses
    if reduction == "sum":
        return losses.sum()
    denom = (labels != ignore_index).sum().clamp(min=1)
    return losses.sum() / denom


def cross_entropy_loss(
    logits,          # (..., vocab)
    labels,          # (...,) int
    label_smoothing: float = 0.0,
    logit_scale: float = 1.0,
    lse_square_scale: float = 0.0,
    ignore_index: int = -100,
    reduction: str = "mean",
):
    """loss = lse - logit[label] (smoothed) + lse_square_scale * lse^2 on
    fp32 logits * logit_scale; ignored positions contribute 0 and the mean
    is over the others."""
    logits = logits.float() * logit_scale
    losses, _ = _token_losses(logits, labels, label_smoothing,
                              lse_square_scale, ignore_index)
    return _reduce(losses, labels, ignore_index, reduction)


class _FusedLinearCE(torch.autograd.Function):
    """Per-token losses of x @ weight^T, one (chunk, vocab) fp32 logits
    slice at a time. The backward recomputes each slice and turns it into
    d_logits in place, so the (tokens, vocab) logits never exist: the JAX
    function gets the same from jax.checkpoint around each scanned chunk."""

    @staticmethod
    def forward(ctx, x, weight, labels, chunk, logit_scale, label_smoothing,
                lse_square_scale, ignore_index):
        losses = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        for start in range(0, x.shape[0], chunk):
            sl = slice(start, start + chunk)
            logits = F.linear(x[sl], weight).float()
            if logit_scale != 1.0:
                logits *= logit_scale
            losses[sl], _ = _token_losses(logits, labels[sl], label_smoothing,
                                          lse_square_scale, ignore_index)
        ctx.save_for_backward(x, weight, labels)
        ctx.args = (chunk, logit_scale, label_smoothing, lse_square_scale,
                    ignore_index)
        return losses

    @staticmethod
    def backward(ctx, g):
        x, weight, labels = ctx.saved_tensors
        chunk, logit_scale, eps, z_scale, ignore_index = ctx.args
        vocab = weight.shape[0]
        dx = torch.empty_like(x)
        dw = torch.zeros(weight.shape, dtype=torch.float32, device=x.device)
        for start in range(0, x.shape[0], chunk):
            sl = slice(start, start + chunk)
            xc, lab = x[sl], labels[sl]
            logits = F.linear(xc, weight).float()
            if logit_scale != 1.0:
                logits *= logit_scale
            lse = torch.logsumexp(logits, dim=-1)
            gi = torch.where(lab != ignore_index, g[sl].float(), 0.0)
            # d loss / d logit_j = p_j (1 + 2 z lse) - (1 - eps) [j = label]
            # - eps / vocab, times the token's cotangent.
            dlogits = logits.sub_(lse[:, None]).exp_()
            dlogits *= (gi * (1 + 2 * z_scale * lse))[:, None]
            dlogits.scatter_add_(
                1, lab.clamp(0, vocab - 1)[:, None].long(),
                (-(1 - eps) * gi)[:, None])
            if eps > 0.0:
                dlogits -= (gi * (eps / vocab))[:, None]
            if logit_scale != 1.0:
                dlogits *= logit_scale
            dl = dlogits.to(x.dtype)
            dx[sl] = dl @ weight
            dw += (dl.t() @ xc).float()
        return dx, dw.to(weight.dtype), None, None, None, None, None, None


def fused_linear_cross_entropy(
    hidden,          # (..., d) activations going into the lm_head
    kernel,          # (vocab, d) if transpose_kernel else (d, vocab)
    labels,          # (...,) int
    transpose_kernel: bool = False,
    chunk_size: int = 4096,
    label_smoothing: float = 0.0,
    logit_scale: float = 1.0,
    lse_square_scale: float = 0.0,
    ignore_index: int = -100,
    reduction: str = "mean",
):
    """lm_head matmul + cross-entropy without the full (tokens, vocab)
    logits: :func:`cross_entropy_loss` of ``hidden @ kernel[.T] *
    logit_scale``, computed ``chunk_size`` tokens at a time (the last chunk
    may be short). The matmul runs in the inputs' type; the logits and the
    loss are fp32. The kernel's gradient is summed over chunks in fp32."""
    d = hidden.shape[-1]
    x = hidden.reshape(-1, d)
    y = labels.reshape(-1)
    weight = kernel if transpose_kernel else kernel.t()
    chunk = max(1, min(chunk_size, x.shape[0]))
    losses = _FusedLinearCE.apply(x, weight, y, chunk, logit_scale,
                                  label_smoothing, lse_square_scale,
                                  ignore_index)
    if reduction == "none":
        return losses.reshape(labels.shape)
    return _reduce(losses, y, ignore_index, reduction)
