"""Language-model losses (port of ``deepspeed_tpu/ops/losses.py``).

:func:`dense_lm_loss` builds the whole ``[N, V]`` f32 logits.
:func:`chunked_lm_loss` never does: its forward sweeps vocab chunks with an
online logsumexp, and its backward (:class:`_ChunkedNLL`, the twin of the
JAX custom VJP ``_chunked_nll``) recomputes each chunk's logits from the
saved lse while it accumulates ``dx`` in f32 and writes ``dhead`` chunk by
chunk, so the loss holds one ``[N, Vc]`` block at a time.
"""

from __future__ import annotations

import torch


def _logits(x, head):
    """f32 logits of ``x @ head`` (the JAX package's
    ``preferred_element_type=float32`` product)."""
    return x.float() @ head.float()


def _masked_mean(nll, mask):
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def dense_lm_loss(x, head, targets, mask=None):
    """Mean (masked) NLL of ``softmax(x @ head)``: x [N, D], head [D, V],
    targets [N] int, mask optional [N] (1 = count) -> f32 scalar."""
    logp = torch.log_softmax(_logits(x, head), dim=-1)
    nll = -logp.gather(-1, targets.long()[:, None])[:, 0]
    if mask is None:
        return nll.mean()
    return _masked_mean(nll, mask)


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
        logits = _logits(x, head[:, base:base + chunk])
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
    def forward(ctx, x, head, targets, mask, chunk: int, v_real: int):
        nll, lse = _chunk_fwd(x, head, targets, chunk, v_real)
        ctx.save_for_backward(x, head, targets, mask, lse)
        ctx.chunk, ctx.v_real = chunk, v_real
        return _masked_mean(nll, mask)

    @staticmethod
    def backward(ctx, g):
        x, head, targets, mask, lse = ctx.saved_tensors
        chunk, v_real = ctx.chunk, ctx.v_real
        maskf = mask.float()
        w = g.float() * maskf / torch.clamp(maskf.sum(), min=1.0)   # [N]
        col = torch.arange(chunk, device=x.device)
        tl = targets.long()
        xf = x.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dhead = torch.empty_like(head)
        for base in range(0, head.shape[1], chunk):
            hc = head[:, base:base + chunk]
            logits = _logits(x, hc).masked_fill(
                (base + col >= v_real)[None, :], float("-inf"))
            p = torch.exp(logits - lse[:, None])
            local = tl - base
            hit = (local >= 0) & (local < chunk)
            onehot = torch.zeros_like(p)
            onehot.scatter_(-1, local.clamp(0, chunk - 1)[:, None],
                            hit[:, None].float())
            dl = (p - onehot) * w[:, None]
            dx += dl @ hc.float().T
            dhead[:, base:base + chunk] = (xf.T @ dl).to(head.dtype)
        return dx.to(x.dtype), dhead, None, None, None, None


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
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    if V <= chunk:
        return dense_lm_loss(x, head, targets, mask)
    pad = (-V) % chunk
    if pad:
        head = torch.cat([head, head.new_zeros((head.shape[0], pad))], dim=1)
    return _ChunkedNLL.apply(x, head, targets, mask, chunk, V)
