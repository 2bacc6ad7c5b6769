"""1-bit optimizers (port of ``deepspeed_tpu/ops/onebit.py``; ref:
deepspeed/runtime/fp16/onebit/{adam,lamb}.py).

After a full-precision warmup the Adam variance is frozen and only
``sign(momentum)`` and one L1 scale a group cross the wire (int8 signs and
f32 scales all-gathered over ``axis_name``), with each rank's
error feedback keeping the compression unbiased over time.  The optimizers
take local (unreduced) grads, as the reference's do: the optimizer owns
the exchange.  ``axis_name=None`` runs no exchange at all (exact Adam or
LAMB with a frozen variance).

State: ``mu`` and ``nu`` are the same on every rank (they follow the
shared compressed momentum), ``err`` is this rank's own error feedback
(the JAX package stacks these ``[world, ...]``, a row a device; a rank of
the port keeps just its row).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch._tree import tree_leaves, tree_map, \
    tree_unflatten_like
from deepspeed_tpu_torch.ops.optim import (Optimizer, ScalarOrSchedule,
                                           _lr_at, _zeros_f32)


def _groups_for(size: int, num_groups: int) -> int:
    """Per-leaf group count: 1 when the leaf does not divide."""
    return num_groups if num_groups > 0 and size % num_groups == 0 else 1


def _compress(v: torch.Tensor, num_groups: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sign (+1 at 0) and the per-group mean |v| (onebit Adam's basis)."""
    g = v.reshape(_groups_for(v.numel(), num_groups), -1)
    scale = g.abs().mean(1)
    signs = torch.where(g >= 0, 1, -1).to(torch.int8)
    return signs, scale


def _decompress(signs: torch.Tensor, scale: torch.Tensor,
                shape) -> torch.Tensor:
    return (signs.float() * scale[..., None]).reshape(shape)


def onebit_allreduce(x: torch.Tensor, err: torch.Tensor, axis_name: str,
                     num_groups: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback sign-compressed mean over ``axis_name`` -> (mean,
    new error)."""
    v = x + err
    signs, scale = _compress(v, num_groups)
    new_err = v - _decompress(signs, scale, v.shape)
    sg = comm.all_gather(signs, axis_name, tiled=False)    # int8 on the wire
    sc = comm.all_gather(scale, axis_name, tiled=False)
    avg = _decompress(sg, sc, (sg.shape[0],) + tuple(v.shape)).mean(0)
    return avg, new_err


class OneBitState(NamedTuple):
    step: int
    mu: Any            # momentum (shared)
    nu: Any            # variance (frozen after warmup)
    err: Any           # this rank's compression error


def onebit_adam(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999),
                eps: float = 1e-8, weight_decay: float = 0.0,
                freeze_step: int = 100, axis_name: Optional[str] = "data",
                num_groups: int = 1) -> Optimizer:
    """ref: onebit/adam.py OnebitAdam (``freeze_step`` = warmup length; no
    bias correction, as the reference)."""
    b1, b2 = betas

    def init(params):
        return OneBitState(0, tree_map(_zeros_f32, params),
                           tree_map(_zeros_f32, params),
                           tree_map(_zeros_f32, params))

    def update(grads, state, params):
        step = state.step + 1
        in_warmup = step <= freeze_step
        lr_t = _lr_at(lr, step)

        def leaf(g, m, v, e, p):
            g = g.float()
            if in_warmup:
                # one exchange pattern a step: warmup pays the exact mean
                g_exact = comm.all_reduce(g, axis_name, comm.ReduceOp.AVG) \
                    if axis_name is not None else g
                m_new = b1 * m + (1 - b1) * g_exact
                v_new = b2 * v + (1 - b2) * torch.square(g_exact)
                e_new = e
            else:
                m_local = b1 * m + (1 - b1) * g
                if axis_name is not None:
                    m_new, e_new = onebit_allreduce(m_local, e, axis_name,
                                                    num_groups)
                else:
                    m_new, e_new = m_local, e
                v_new = v                  # variance frozen post-warmup
            upd = m_new / (torch.sqrt(v_new) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return -lr_t * upd, m_new, v_new, e_new

        outs = [leaf(*a) for a in zip(*map(tree_leaves, (
            grads, state.mu, state.nu, state.err, params)))]
        unflat = lambda i: tree_unflatten_like(grads, [o[i] for o in outs])
        return unflat(0), OneBitState(step, unflat(1), unflat(2), unflat(3))

    return Optimizer(init=init, update=update, name="onebit_adam",
                     axis_name=axis_name)


def onebit_lamb(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999),
                eps: float = 1e-6, weight_decay: float = 0.0,
                freeze_step: int = 100, axis_name: Optional[str] = "data",
                num_groups: int = 1,
                min_trust: float = 0.01, max_trust: float = 10.0
                ) -> Optimizer:
    """ref: onebit/lamb.py OnebitLamb: 1-bit momentum exchange and the
    layer-wise trust ratio on the decompressed update."""
    base = onebit_adam(1.0, betas, eps, 0.0, freeze_step, axis_name,
                       num_groups)

    def update(grads, state, params):
        raw_upd, new_state = base.update(grads, state, params)
        lr_t = _lr_at(lr, new_state.step)

        def leaf(u, p):
            p32 = p.float()
            upd = -u          # base returns -1.0 * the Adam direction
            if weight_decay:
                upd = upd + weight_decay * p32
            wn = torch.linalg.vector_norm(p32)
            un = torch.linalg.vector_norm(upd)
            trust = torch.where((wn > 0) & (un > 0),
                                torch.clamp(wn / un, min_trust, max_trust),
                                torch.ones_like(wn))
            return -lr_t * trust * upd

        return tree_map(leaf, raw_upd, params), new_state

    return Optimizer(init=base.init, update=update, name="onebit_lamb",
                     axis_name=axis_name)
