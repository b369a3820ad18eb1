"""The learnable sink: one more logit in every attention row's softmax, a
natural-log value per query head (gpt-oss), as the JAX package's forward
kernels take it in their epilogues (flash_attn_tpu/kernels/flash_fwd.py:
340-356) and its gradient as an epilogue of the backward
(flash_attn_tpu/interface.py:185-200, :384-394).

The sink is not multiplied by the softmax scale, not capped and not biased
by ALiBi: it enters only the softmax's denominator, lse = log(e^sink +
sum_j e^(s_j)), and out = sum_j e^(s_j - lse) v_j. A row that sees no key
gives out 0 and lse = sink, and so does every row a kernel leaves unwritten
(rows past seqused_q, the packed tail): the wrappers fill lse with the
sink. dq, dk and dv need nothing new, since P = e^(S - lse) folds the sink
in through the lse; the sink's own gradient is dsink_h = -sum over the
head's rows of e^(sink_h - lse) rowsum(dO * O), the rows whose lse is not
finite weighing 0.

Here: the sink as the kernels read it (:func:`sink_arg`), the wrappers' lse
fill (:func:`lse_fill`), the plain versions' lse (:func:`with_sink`) and the
gradient (:func:`sink_grad`).
"""

import torch


def sink_arg(name: str, learnable_sink, h: int, device):
    """``learnable_sink`` as the kernels read it, (h,) contiguous fp32 on
    ``device`` (q's), detached; None stays None. Raises ValueError for
    another shape, a type that is not floating point, or another device."""
    if learnable_sink is None:
        return None
    if tuple(learnable_sink.shape) != (h,) \
            or not learnable_sink.is_floating_point():
        raise ValueError(
            f"{name}: learnable_sink is {tuple(learnable_sink.shape)} "
            f"{learnable_sink.dtype}, want a ({h},) floating-point tensor "
            "(one logit per query head)")
    if learnable_sink.device != device:
        raise ValueError(f"{name}: learnable_sink is on "
                         f"{learnable_sink.device}, q on {device}")
    return learnable_sink.detach().to(torch.float32).contiguous()


def sink_ptr(sink):
    """The C entry points' sink pointer: :func:`sink_arg`'s data, or None."""
    return None if sink is None else sink.data_ptr()


def lse_fill(sink, h: int, rows: int, device):
    """(h, rows) fp32 lse as a packed layout's wrapper allocates it before
    the kernel writes its rows: -inf, or each head's sink."""
    if sink is None:
        return torch.full((h, rows), float("-inf"), dtype=torch.float32,
                          device=device)
    return sink[:, None].expand(h, rows).contiguous()


def with_sink(lse, sink):
    """The plain versions' lse with the sink: log(e^lse + e^sink), lse's
    last dim the rows and ``sink`` broadcast against the dims before it
    ((h,), or (h_k, group) for grouped heads); lse without a sink."""
    if sink is None:
        return lse
    return torch.logaddexp(lse, sink[..., None])


def sink_grad(sink, lse, delta, head_dim: int):
    """dsink (h,) fp32 = -sum of e^(sink - lse) delta over every dim of lse
    but ``head_dim``, delta = rowsum(dO * O) in lse's shape; a row whose lse
    is not finite weighs 0 (JAX interface.py:193-200)."""
    shape = [1] * lse.dim()
    shape[head_dim] = -1
    live = torch.isfinite(lse)
    w = torch.exp(sink.view(shape) - torch.where(live, lse, 0.0))
    dims = [i for i in range(lse.dim()) if i != head_dim]
    return -torch.where(live, w * delta, 0.0).sum(dims)
