"""Optimizer core (port of ``deepspeed_tpu/ops/optim.py``; ref:
deepspeed/ops/adam/fused_adam.py, lamb/fused_lamb.py, lion, adagrad).

The same functional ``(init, update)`` pair over the param tree as the JAX
package: ``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)``; the engine adds the updates.  States are NamedTuples
whose first field is the step (a Python int) and whose other fields are
trees shaped like the params (f32), so the engine can run ``update`` one
leaf at a time.  Every rule is elementwise or per leaf, in f32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch._tree import tree_map

ScalarOrSchedule = Union[float, Callable[[int], float]]


def _lr_at(lr: ScalarOrSchedule, step: int) -> float:
    return float(lr(step)) if callable(lr) else float(np.float32(lr))


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _bias_corrections(b1, b2, step: int):
    """(1 - b1^t, 1 - b2^t) in float32, t = step."""
    t = np.float32(step)
    return (float(np.float32(1) - np.float32(b1) ** t),
            float(np.float32(1) - np.float32(b2) ** t))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A gradient transformation: functional mirror of the reference's
    torch.optim.Optimizer subclasses."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]  # (grads, state, params) -> (updates, state)
    name: str = "optimizer"
    # named axis the optimizer communicates over (1-bit family)
    axis_name: Optional[str] = None


class AdamState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adam(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0, adamw: bool = True,
         bias_correction: bool = True, name: str = "adamw") -> Optimizer:
    """Adam/AdamW (ref: FusedAdam — ``adam_w_mode`` selects decoupled
    weight decay)."""
    b1, b2 = betas

    def init(params):
        return AdamState(0, tree_map(_zeros_f32, params),
                         tree_map(_zeros_f32, params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        if weight_decay and not adamw:
            # classic L2: fold wd*p into the gradient before the moments
            grads = tree_map(lambda g, p: g.float() + weight_decay * p.float(),
                             grads, params)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        c1, c2 = _bias_corrections(b1, b2, step) if bias_correction \
            else (1.0, 1.0)

        def upd(m, v, p):
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay and adamw:
                u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype)

        return tree_map(upd, mu, nu, params), AdamState(step, mu, nu)

    return Optimizer(init, update, name)


def adamw(lr: ScalarOrSchedule = 1e-3, **kw) -> Optimizer:
    return adam(lr, adamw=True, name="adamw", **kw)


# the mesh axes over which the leaf an update sees is one block (set by the
# engine around each update of a split leaf; empty: a whole leaf)
_BLOCK_AXES: tuple = ()


@contextlib.contextmanager
def whole_leaf_norms(axes):
    """Within the block, a per-leaf norm (LAMB's trust ratio) is the whole
    leaf's: each rank's sums of squares of its block are all-reduced over
    ``axes``, one call for the pair (under GSPMD the JAX engine gets the
    whole-leaf norm from the sharded reduction itself)."""
    global _BLOCK_AXES
    prev, _BLOCK_AXES = _BLOCK_AXES, tuple(axes)
    try:
        yield
    finally:
        _BLOCK_AXES = prev


def _norms(a: torch.Tensor, b: torch.Tensor):
    """The 2-norms of ``a`` and ``b`` over the whole leaves they are
    blocks of."""
    if not _BLOCK_AXES:
        return torch.linalg.vector_norm(a), torch.linalg.vector_norm(b)
    from deepspeed_tpu_torch import comm

    sq = torch.stack([torch.sum(torch.square(a)), torch.sum(torch.square(b))])
    for axis in _BLOCK_AXES:
        comm.all_reduce_(sq, axis)
    return torch.sqrt(sq[0]), torch.sqrt(sq[1])


class LambState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def lamb(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
         weight_decay: float = 0.0, min_trust: float = 0.01,
         max_trust: float = 10.0) -> Optimizer:
    """LAMB with a per-leaf trust ratio (ref: fused_lamb.py)."""
    b1, b2 = betas

    def init(params):
        return LambState(0, tree_map(_zeros_f32, params),
                         tree_map(_zeros_f32, params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        c1, c2 = _bias_corrections(b1, b2, step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)

        def upd(m, v, p):
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            wn, un = _norms(p.float(), u)
            trust = torch.where((wn > 0) & (un > 0),
                                torch.clamp(wn / un, min_trust, max_trust),
                                torch.ones_like(wn))
            return (-lr_t * trust * u).to(p.dtype)

        return tree_map(upd, mu, nu, params), LambState(step, mu, nu)

    return Optimizer(init, update, "lamb")


class LionState(NamedTuple):
    step: int
    mu: Any


def lion(lr: ScalarOrSchedule = 1e-4, betas=(0.9, 0.99),
         weight_decay: float = 0.0) -> Optimizer:
    """Lion (ref: deepspeed/ops/lion/fused_lion.py)."""
    b1, b2 = betas

    def init(params):
        return LionState(0, tree_map(_zeros_f32, params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = _lr_at(lr, step)

        def upd(m, p, g):
            u = torch.sign(b1 * m + (1 - b1) * g.float())
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype)

        updates = tree_map(upd, state.mu, params, grads)
        mu = tree_map(lambda m, g: b2 * m + (1 - b2) * g.float(),
                      state.mu, grads)
        return updates, LionState(step, mu)

    return Optimizer(init, update, "lion")


class AdagradState(NamedTuple):
    step: int
    accum: Any


def adagrad(lr: ScalarOrSchedule = 1e-2, eps: float = 1e-10,
            weight_decay: float = 0.0) -> Optimizer:
    """Adagrad (ref: deepspeed/ops/adagrad/cpu_adagrad.py)."""

    def init(params):
        return AdagradState(0, tree_map(_zeros_f32, params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        accum = tree_map(lambda a, g: a + torch.square(g.float()),
                         state.accum, grads)

        def upd(a, p, g):
            u = g.float() / (torch.sqrt(a) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype)

        return (tree_map(upd, accum, params, grads),
                AdagradState(step, accum))

    return Optimizer(init, update, "adagrad")


class SgdState(NamedTuple):
    step: int
    momentum: Any


def sgd(lr: ScalarOrSchedule = 1e-2, momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        return SgdState(0, tree_map(_zeros_f32, params) if momentum else None)

    def update(grads, state, params):
        step = state.step + 1
        lr_t = _lr_at(lr, step)

        def g32(p, g):
            g = g.float()
            return g + weight_decay * p.float() if weight_decay else g

        gs = tree_map(g32, params, grads)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g, state.momentum, gs)
            eff = (tree_map(lambda m, g: g + momentum * m, mom, gs)
                   if nesterov else mom)
        else:
            mom, eff = None, gs
        updates = tree_map(lambda p, u: (-lr_t * u).to(p.dtype), params, eff)
        return updates, SgdState(step, mom)

    return Optimizer(init, update, "sgd")


# Per-optimizer default LRs (match each constructor's default above).
_DEFAULT_LR = {"adam": 1e-3, "adamw": 1e-3, "fusedadam": 1e-3, "lamb": 1e-3,
               "fusedlamb": 1e-3, "lion": 1e-4, "adagrad": 1e-2, "sgd": 1e-2}


def default_lr(name: str) -> float:
    return _DEFAULT_LR.get(name.lower(), 1e-3)


_REGISTRY = {
    "adam": lambda **kw: adam(adamw=kw.pop("adam_w_mode", True), **kw),
    "adamw": adamw,
    # the config name maps to the plain adam, as in the JAX package; the
    # Hopper kernel is reached through ops.adam_cuda.fused_adam(...)
    "fusedadam": lambda **kw: adam(adamw=kw.pop("adam_w_mode", True), **kw),
    "lamb": lamb,
    "fusedlamb": lamb,
    "lion": lion,
    "adagrad": adagrad,
    "sgd": sgd,
}


def _register_onebit():
    from deepspeed_tpu_torch.ops import onebit

    _REGISTRY["onebitadam"] = onebit.onebit_adam
    _REGISTRY["onebitlamb"] = onebit.onebit_lamb
    # 0/1 Adam maps to the same exchange
    _REGISTRY["zerooneadam"] = onebit.onebit_adam


def from_config(name: str, params: dict) -> Optimizer:
    """Build from the config ``optimizer`` block (ref:
    deepspeed/runtime/engine.py _configure_basic_optimizer)."""
    name = name.lower()
    if name.startswith("onebit") or name.startswith("zeroone"):
        _register_onebit()   # deferred: onebit imports this module
        # outside the engine's compressed step nothing names the axis, so
        # axis_name defaults to None: no compressed exchange happens.  The
        # engine passes axis_name="data" when its step runs one
        params = dict(params)
        if params.setdefault("axis_name", None) is None:
            logging.getLogger(__name__).warning(
                "%s built with axis_name=None: momentum compression is "
                "INACTIVE (updates are exact Adam/LAMB with frozen "
                "variance). Use it through TrainingEngine on a "
                "data-parallel mesh to get compressed communication.", name)
    if name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(_REGISTRY)}")
    kw = dict(params)
    if "lr" in kw and not callable(kw["lr"]):
        kw["lr"] = float(kw["lr"])
    if "betas" in kw:
        kw["betas"] = tuple(kw["betas"])
    kw.pop("torch_adam", None)
    return _REGISTRY[name](**kw)
