"""Fused Adam/AdamW on Hopper: the wrapper of ``csrc/fused_adam.cu``, its
plain PyTorch version, and the ``fused_adam`` optimizer built on them.

Replaces ``deepspeed_tpu/ops/adam_pallas.py::_adam_kernel`` (with
``adam_update_flat`` / ``fused_adam``).  The update is elementwise, ~11
flops per element over 24-28 bytes, so it is bound by bytes: one pass reads
g, m, v and p once and writes u, m and v once.  The kernel is a
grid-stride loop over one flat leaf; one launch per leaf, as the JAX
wrapper calls once per leaf.  The TPU-measured size gate
(``_PALLAS_MIN_PARAMS``) does not carry over: on CUDA the kernel runs at
every size.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch._tree import (tree_leaves, tree_map,
                                      tree_unflatten_like)
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.optim import Optimizer, ScalarOrSchedule, _lr_at


def adam_scalars(b1: float, b2: float, step: int):
    """(c1, c2) = (1/(1-b1^t), 1/(1-b2^t)) at t = step + 1, in float32 as
    ``adam_update_flat`` computes them."""
    t = np.float32(step) + np.float32(1.0)
    one = np.float32(1.0)
    return (float(one / (one - np.float32(b1) ** t)),
            float(one / (one - np.float32(b2) ** t)))


def adam_update_reference(g, m, v, p, c1: float, c2: float, lr: float, *,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8, wd: float = 0.0):
    """Plain version of the kernel (the twin of ``_adam_update_xla``):
    returns (u, m_new, v_new), all f32."""
    g = g.float()
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    upd = (m * c1) / (torch.sqrt(v * c2) + eps)
    if wd:
        upd = upd + wd * p.float()
    return -lr * upd, m, v


def adam_update(g, m, v, p, c1: float, c2: float, lr: float, *,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                wd: float = 0.0):
    """One fused Adam pass over a leaf -> (u, m_new, v_new) f32.  g and p
    are float32 or bfloat16, m and v float32, all of one shape and
    contiguous.  CPU tensors take :func:`adam_update_reference`; CUDA
    tensors launch the kernel or raise."""
    if g.device.type == "cpu":
        return adam_update_reference(g, m, v, p, c1, c2, lr, b1=b1, b2=b2,
                                     eps=eps, wd=wd)
    if not g.is_cuda:
        raise ValueError(f"fused_adam: unsupported device {g.device}")
    for name, t in (("g", g), ("m", m), ("v", v), ("p", p)):
        if t.device != g.device or t.shape != g.shape:
            raise ValueError(f"fused_adam: {name} is {tuple(t.shape)} on "
                             f"{t.device}, g is {tuple(g.shape)} on {g.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_adam: {name} is not contiguous")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"fused_adam: m/v must be float32, got "
                         f"{m.dtype}/{v.dtype}")
    if g.dtype not in _build.F32_BF16 or p.dtype not in _build.F32_BF16:
        raise ValueError(f"fused_adam: g/p dtype {g.dtype}/{p.dtype} not in "
                         "float32/bfloat16")
    u = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    m_out = torch.empty_like(m)
    v_out = torch.empty_like(v)
    if g.numel():
        err = _build.lib().dstt_fused_adam(
            g.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(),
            u.data_ptr(), m_out.data_ptr(), v_out.data_ptr(), g.numel(),
            b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, c1, c2, lr,
            _build.DTYPE_CODES[g.dtype], _build.DTYPE_CODES[p.dtype],
            _build.stream_of(g))
        _build.check("dstt_fused_adam", err)
        adam_update.launches += 1
    return u, m_out, v_out


adam_update.launches = 0


class FusedAdamState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def fused_adam(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999),
               eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Optimizer-contract wrapper over the kernel (drop-in for
    ``ops.optim.adam``; AdamW decoupled decay).  Each leaf is one
    :func:`adam_update` call: the kernel on CUDA tensors."""
    return _leafwise_adam(adam_update, "fused_adam_cuda", lr, betas, eps,
                          weight_decay)


def _leafwise_adam(update_fn, name: str, lr: ScalarOrSchedule, betas,
                   eps: float, weight_decay: float) -> Optimizer:
    """The ``Optimizer`` contract over one ``update_fn`` call per leaf
    (``update_fn`` takes :func:`adam_update`'s arguments)."""
    b1, b2 = betas

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        return FusedAdamState(0, tree_map(z, params), tree_map(z, params))

    def update(grads, state, params):
        # LR at step+1, matching ops.optim.adam's schedule convention and
        # the kernel's bias correction at t = step + 1
        lr_val = _lr_at(lr, state.step + 1)
        c1, c2 = adam_scalars(b1, b2, state.step)
        outs = [update_fn(g, m, v, p, c1, c2, lr_val, b1=b1, b2=b2,
                          eps=eps, wd=weight_decay)
                for g, m, v, p in zip(*map(tree_leaves, (
                    grads, state.mu, state.nu, params)))]
        u, mu, nu = (tree_unflatten_like(grads, [o[i] for o in outs])
                     for i in range(3))
        return u, FusedAdamState(state.step + 1, mu, nu)

    return Optimizer(init=init, update=update, name=name)
