"""Norms, activations, softmax and dropout with the reference's dtype
discipline (port of ``deepspeed_tpu/ops/fused_ops.py``): f32 statistics,
data path in the input dtype."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    scale = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * scale).to(dt) * weight.to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 mean and variance; the normalised value is cast
    to x's dtype before ``* weight + bias`` in that dtype, the JAX
    package's rounding order."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * weight.to(dt) + bias.to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor) -> torch.Tensor:
    """silu(x @ w_gate) * (x @ w_up)."""
    return F.silu(x @ w_gate) * (x @ w_up)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """GPT-2 style MLP: gelu(x @ w_in + b_in) @ w_out + b_out."""
    return gelu(x @ w_in + b_in) @ w_out + b_out


def fused_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  scale: float = 1.0) -> torch.Tensor:
    """Scaled softmax in f32 over the last axis; where ``mask`` is False the
    score is -inf first."""
    s = scores.float() * scale
    if mask is not None:
        s = s.masked_fill(~mask.bool(), float("-inf"))
    return torch.softmax(s, dim=-1)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = False) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and scale it by
    ``1 / (1 - rate)``; zero the rest.  The draws come from ``generator``
    (a ``torch.Generator`` on x's device): JAX's threefry bits have no
    PyTorch twin, so only the keep rate and the scaling match."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
