"""Attention dispatch (port of ``deepspeed_tpu/ops/attention.py``).

``flash_attention`` runs :class:`FlashAttention`, a
``torch.autograd.Function`` whose forward is the flash kernel and whose
backward is the dQ and dK/dV kernels
(:mod:`deepspeed_tpu_torch.ops.attention_cuda`) for CUDA tensors, and the
plain versions of the same three for CPU tensors, so the CPU tests exercise
the Function that the card runs.  :func:`_reference` is the plain attention
that autograd differentiates, the oracle of all three.  The TPU kernel's
shape gates (T % 128, T >= 256, D in {64, 128}) do not carry over: the CUDA
kernels mask ragged tails themselves, and a shape they cannot take raises.
"""

from __future__ import annotations

import math

import torch

from deepspeed_tpu_torch.ops.attention_cuda import flash_bwd, flash_fwd


def _reference(q, k, v, causal: bool = True, segment_ids=None):
    """Plain attention, [B,T,H,Dh] x [B,S,KV,Dh]^2 -> [B,T,H,Dh]: f32
    scores and softmax, probabilities cast to q's dtype before P.V (as the
    JAX reference does)."""
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    if KV != H:
        rep = H // KV
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(),
                          k.float()) / math.sqrt(Dh)
    if causal:
        mask = torch.ones((T, k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        scores = scores.masked_fill(~same, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward (the custom VJP of
    ``attention_pallas._flash_bhtd``): the forward keeps (q, k, v, o, lse)
    and the backward recomputes the probabilities from lse."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal: bool):
        o, lse = flash_fwd(q, k, v, causal=causal, seg=segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), seg,
                               ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, segment_ids=None,
                    force_reference: bool = False):
    """[B,T,H,Dh] x [B,S,KV,Dh]^2 -> [B,T,H,Dh] through
    :class:`FlashAttention` (kernels on CUDA, their plain versions on the
    CPU); ``force_reference`` takes :func:`_reference`.  ``segment_ids``
    [B, T] (T == S) confines each position to its own packed segment."""
    if force_reference:
        return _reference(q, k, v, causal=causal, segment_ids=segment_ids)
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device,
                                     dtype=torch.int32).contiguous()
    return FlashAttention.apply(q, k, v, segment_ids, causal)
