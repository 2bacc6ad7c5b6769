"""Mixed precision and loss scaling (port of ``deepspeed_tpu/precision.py``;
ref: deepspeed/runtime/fp16/loss_scaler.py, bf16_optimizer.py).

Master params live in float32; compute runs in bfloat16 (or float16 with
the reference's dynamic loss scaler: halve on overflow, floored at
``min_loss_scale``; double after ``loss_scale_window`` clean steps).  The
scaler state is two host numbers: the engine reads the overflow flag once
per step to decide whether to commit, so nothing here needs to stay on the
device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from deepspeed_tpu_torch._tree import tree_leaves, tree_map
from deepspeed_tpu_torch.config import PrecisionConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_FLOATS = tuple(_DTYPES.values())


class ScalerState(NamedTuple):
    """ref: DynamicLossScaler attributes (cur_scale, cur_iter)."""

    scale: float        # f32 value (a power of two under the dynamic rule)
    good_steps: int     # consecutive overflow-free steps


def compute_dtype(cfg: PrecisionConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def master_dtype(cfg: PrecisionConfig) -> torch.dtype:
    return _DTYPES[cfg.master_dtype]


def cast_for_compute(params: Any, cfg: PrecisionConfig) -> Any:
    dt = compute_dtype(cfg)
    return tree_map(lambda p: p.to(dt) if p.dtype in _FLOATS else p, params)


def scaler_init(cfg: PrecisionConfig) -> ScalerState:
    if cfg.is_fp16:
        init = (cfg.loss_scale if cfg.loss_scale > 0
                else float(2 ** cfg.initial_scale_power))
    else:
        init = 1.0
    return ScalerState(float(init), 0)


def scale_loss(loss, state: ScalerState, cfg: PrecisionConfig):
    return loss * state.scale if cfg.is_fp16 else loss


def finite_all(tree: Any) -> bool:
    """True when every floating leaf is finite (one device sync)."""
    flags = [torch.isfinite(l).all() for l in tree_leaves(tree)
             if l.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True


def unscale_and_check(grads: Any, state: ScalerState,
                      cfg: PrecisionConfig,
                      agree: Optional[Callable[[bool], bool]] = None
                      ) -> Tuple[Any, bool, ScalerState]:
    """Unscale grads; return (grads, is_finite, new_scaler_state).

    Mirrors DynamicLossScaler.update_scale: on overflow divide the scale by
    2 (floored at ``min_loss_scale``; hysteresis folded into the backoff as
    in the JAX package), after ``loss_scale_window`` clean steps double it.
    Float32 grads are unscaled in place (the engine owns them).  ``agree``
    turns this rank's finite flag into the ranks' common one (grads held
    as shards are checked shard by shard)."""
    agree = agree or (lambda ok: ok)
    if not cfg.is_fp16:
        return grads, agree(finite_all(grads)), state
    inv = 1.0 / state.scale
    grads = tree_map(
        lambda g: g.mul_(inv) if g.dtype == torch.float32
        else g.float() * inv, grads)
    ok = agree(finite_all(grads))
    if cfg.loss_scale > 0:          # static scale
        return grads, ok, state
    if not ok:
        return grads, ok, ScalerState(max(state.scale / 2.0,
                                          float(cfg.min_loss_scale)), 0)
    if state.good_steps + 1 >= cfg.loss_scale_window:
        return grads, ok, ScalerState(state.scale * 2.0, 0)
    return grads, ok, ScalerState(state.scale, state.good_steps + 1)
