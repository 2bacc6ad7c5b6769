"""Language-model losses (port of ``deepspeed_tpu/ops/losses.py``).

:func:`dense_lm_loss` builds the whole ``[N, V]`` f32 logits.
:func:`chunked_lm_loss` never does: its forward sweeps vocab chunks with an
online logsumexp, and its backward (:class:`_ChunkedNLL`, the twin of the
JAX custom VJP ``_chunked_nll``) recomputes each chunk's logits from the
saved lse while it accumulates ``dx`` in f32 and writes ``dhead`` chunk by
chunk, so the loss holds one ``[N, Vc]`` block at a time.

Every LM-head product goes through :func:`f32_matmul`: bf16 (or fp16)
operands with an f32 result, the JAX package's ``dot(x, head,
preferred_element_type=float32)``, so no f32 copy of the head is made.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch


class _F32MatMul(torch.autograd.Function):
    """``a @ b`` of two bf16 or fp16 CUDA tensors with an f32 result
    (``aten::mm.dtype``, which has no autograd formula).  The backward is
    the transpose rule of JAX's ``preferred_element_type=float32`` dot:
    the f32 cotangent times the other operand (upcast), each product in
    f32, rounded to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        a2 = a.reshape(-1, a.shape[-1])
        out = torch.mm(a2, b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = (g2 @ b.float().T).to(a.dtype).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            db = (a.reshape(-1, a.shape[-1]).float().T @ g2).to(b.dtype)
        return da, db


def f32_matmul(a, b):
    """f32 product of ``a`` [..., K] and ``b`` [K, N] (the JAX package's
    ``preferred_element_type=float32`` dot).  Two bf16 or fp16 CUDA
    operands go to the tensor cores as they are; otherwise (the CPU, where
    ``aten::mm.dtype`` has no kernel, and f32) both are upcast, which
    gives the same values."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16,
                                                        torch.float16):
        return _F32MatMul.apply(a, b)
    return a.float() @ b.float()


# (axes, ranks) of the global-mean block the caller is in, innermost last
_GLOBAL_MEAN: list = []


@contextlib.contextmanager
def global_batch_mean(axes: Sequence[str], world: int):
    """Inside this block a masked mean over this rank's rows of a batch
    split over ``axes`` (``world`` ranks in all) divides by the global
    count: :func:`mean_denominator`.  The training engine's exact step
    enters it, so that its sum of each rank's ``loss / world`` is the mean
    over the whole microbatch, as the JAX engine's GSPMD step takes it."""
    _GLOBAL_MEAN.append((tuple(axes), int(world)))
    try:
        yield
    finally:
        _GLOBAL_MEAN.pop()


def mean_denominator(count: torch.Tensor) -> torch.Tensor:
    """What a masked mean of this rank's rows divides by: ``max(count,
    1)``; inside :func:`global_batch_mean`, the count summed over the axes
    that split the batch, clamped, over the ranks' number (equal counts
    give back the local count, bit for bit)."""
    count = count.detach().float()
    if not _GLOBAL_MEAN:
        return torch.clamp(count, min=1.0)
    from deepspeed_tpu_torch import comm

    axes, world = _GLOBAL_MEAN[-1]
    total = count.clone()
    for a in axes:
        comm.all_reduce_(total, a)
    return torch.clamp(total, min=1.0) / world


def _masked_mean(nll, mask, denom=None):
    mask = mask.float()
    if denom is None:
        denom = mean_denominator(mask.sum())
    return (nll * mask).sum() / denom


def dense_lm_loss(x, head, targets, mask=None, denom=None):
    """Mean (masked) NLL of ``softmax(x @ head)``: x [N, D], head [D, V],
    targets [N] int, mask optional [N] (1 = count) -> f32 scalar.
    ``denom``: the masked mean's divisor (default
    :func:`mean_denominator` of the mask's count)."""
    logp = torch.log_softmax(f32_matmul(x, head), dim=-1)
    nll = -logp.gather(-1, targets.long()[:, None])[:, 0]
    if mask is None:
        return nll.mean()
    return _masked_mean(nll, mask, denom)


def lm_loss_sum(logits, targets, mask=None):
    """(sum of the (masked) NLL, count of counted rows) of f32 ``logits``
    [..., V] against ``targets`` [...]: the two halves of
    :func:`dense_lm_loss`'s mean, for a loss whose rows are spread over
    ranks (the sums are all-reduced before the division)."""
    logits = logits.reshape(-1, logits.shape[-1])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.reshape(-1).long()[:, None])[:, 0]
    if mask is None:
        return nll.sum(), torch.full((), float(nll.shape[0]),
                                     device=nll.device)
    mask = mask.reshape(-1).float()
    return (nll * mask).sum(), mask.sum()


def _chunk_fwd(x, head, targets, chunk: int, v_real: int):
    """Online-logsumexp sweep over vocab chunks of ``head`` (zero-padded
    past ``v_real``; padded columns are -inf) -> (nll [N], lse [N]) f32."""
    N = x.shape[0]
    dev = x.device
    m = torch.full((N,), float("-inf"), dtype=torch.float32, device=dev)
    s = torch.zeros((N,), dtype=torch.float32, device=dev)
    tgt = torch.zeros((N,), dtype=torch.float32, device=dev)
    col = torch.arange(chunk, device=dev)
    tl = targets.long()
    for base in range(0, head.shape[1], chunk):
        logits = f32_matmul(x, head[:, base:base + chunk])
        logits = logits.masked_fill((base + col >= v_real)[None, :],
                                    float("-inf"))
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(-1)
        m = m_new
        local = tl - base
        hit = (local >= 0) & (local < chunk)
        picked = logits.gather(-1, local.clamp(0, chunk - 1)[:, None])[:, 0]
        tgt = tgt + torch.where(hit, picked, 0.0)
    lse = m + torch.log(s)
    return lse - tgt, lse


class _ChunkedNLL(torch.autograd.Function):
    """Masked-mean NLL over vocab chunks with the recomputing backward of
    ``_chunked_nll_bwd``: the running ``dx`` accumulates in f32 (rounding
    each chunk's contribution would compound across V/Vc chunks) and
    padded columns get p = 0 through their -inf logits."""

    @staticmethod
    def forward(ctx, x, head, targets, mask, denom, chunk: int, v_real: int):
        nll, lse = _chunk_fwd(x, head, targets, chunk, v_real)
        ctx.save_for_backward(x, head, targets, mask, lse, denom)
        ctx.chunk, ctx.v_real = chunk, v_real
        return _masked_mean(nll, mask, denom)

    @staticmethod
    def backward(ctx, g):
        x, head, targets, mask, lse, denom = ctx.saved_tensors
        chunk, v_real = ctx.chunk, ctx.v_real
        maskf = mask.float()
        w = g.float() * maskf / denom   # [N]
        col = torch.arange(chunk, device=x.device)
        tl = targets.long()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        # a frozen head (LoRA's base) needs no gradient: XLA drops that
        # work under stop_gradient, and so does this loop
        dhead = xf = None
        if ctx.needs_input_grad[1]:
            dhead, xf = torch.empty_like(head), x.float()
        for base in range(0, head.shape[1], chunk):
            hc = head[:, base:base + chunk]
            logits = f32_matmul(x, hc).masked_fill(
                (base + col >= v_real)[None, :], float("-inf"))
            p = torch.exp(logits - lse[:, None])
            local = tl - base
            hit = (local >= 0) & (local < chunk)
            onehot = torch.zeros_like(p)
            onehot.scatter_(-1, local.clamp(0, chunk - 1)[:, None],
                            hit[:, None].float())
            dl = (p - onehot) * w[:, None]
            dx += dl @ hc.float().T
            if dhead is not None:
                dhead[:, base:base + chunk] = (xf.T @ dl).to(head.dtype)
        return dx.to(x.dtype), dhead, None, None, None, None, None


def chunked_lm_loss(x, head, targets, mask=None, chunk: int = 8192):
    """Drop-in for :func:`dense_lm_loss` that never holds the full logits.
    ``chunk`` is the vocab block width; a vocab that is not a multiple of
    it is zero-padded (the pad columns are masked to -inf).  ``chunk >= V``
    takes the dense path.  Inputs [B, T, D] / [B, T] are flattened."""
    if x.dim() == 3:
        B, T, D = x.shape
        x = x.reshape(B * T, D)
        targets = targets.reshape(B * T)
        if mask is not None:
            mask = mask.reshape(B * T)
    V = head.shape[1]
    chunk = min(chunk, V)
    if mask is None:
        # every row counts, the same number on every rank: no exchange
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = mean_denominator(mask.float().sum())
    if V <= chunk:
        return dense_lm_loss(x, head, targets, mask, denom)
    pad = (-V) % chunk
    if pad:
        head = torch.cat([head, head.new_zeros((head.shape[0], pad))], dim=1)
    return _ChunkedNLL.apply(x, head, targets, mask, denom, chunk, V)
