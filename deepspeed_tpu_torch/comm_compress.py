"""Compressed gradient and weight communication in the engine (port of
``deepspeed_tpu/comm_compress.py``; ref: deepspeed/runtime/fp16/onebit/
{adam,lamb}.py and ZeRO++ ``zero_quantized_gradients`` /
``zero_quantized_weights``).

Three modes, each chosen by the user config alone (:func:`resolve_mode`):

* ``qgz``: local grads -> quantized reduce-scatter (int8 all-to-all) ->
  int8 all-gather of the reduced shard, then the engine's usual tail
  (stages 0-2);
* ``onebit``: the 1-bit optimizers own the exchange; after warmup only
  ``sign(momentum)`` and group scales travel, with each rank's error
  feedback in its own state (stage 0);
* ``qwz``: a manual ZeRO-3 whose f32 master is one flat ``[world, chunk]``
  buffer of which rank r keeps row r; every step the rows travel as int8
  codes and scales to rebuild the compute leaves, and the flat gradient is
  reduce-scattered back to its row (quantized too with qgZ).

The wire itself is :mod:`~deepspeed_tpu_torch.comm.collectives`, one
implementation: :func:`make_reduce_fn` routes qgZ's all-reduce there
(``hierarchical_all_reduce``, whose flat schedule is the one-level
quantized all-reduce) and :func:`make_weight_gather` qwZ's row gather
(``hpz_weight_gather``, whose flat schedule is the int8 all-gather).

The JAX module needs ``shard_map`` to give each device its local batch;
here every rank already holds its rows, so the local-gradient harness is
the engine's own loop and :func:`accumulate_local_grads`.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Callable, Optional, Tuple

import torch

from deepspeed_tpu_torch._tree import tree_map

logger = logging.getLogger(__name__)

AXIS = "data"
_GROUP = 512          # quantization group size (f32 scale per _GROUP elems)


# ------------------------------------------------------------------ gating
def resolve_mode(config, ms, optimizer_name: str,
                 has_aux: bool) -> Optional[str]:
    """The compressed-comm mode ('qgz' | 'qwz' | 'onebit' | None) the config
    asks for, raising on combinations that would not deliver it."""
    name = optimizer_name.lower()
    wants_onebit = name.startswith("onebit") or name.startswith("zeroone")
    wants_qgz = bool(config.zero.zeropp_quantized_gradients)
    wants_qwz = bool(config.zero.zeropp_quantized_weights)
    if not (wants_onebit or wants_qgz or wants_qwz):
        return None
    what = ("1-bit optimizer" if wants_onebit
            else "ZeRO++ quantized weights" if wants_qwz
            else "ZeRO++ quantized gradients")

    others = [a for a in ("pipe", "model", "seq", "expert") if ms.size(a) > 1]
    if others:
        raise ValueError(
            f"{what} requires a pure data-parallel mesh (the compressed "
            f"step exchanges whole local gradients); mesh has {others} > 1")
    if has_aux:
        raise ValueError(
            f"{what} does not support has_aux loss functions yet")
    if ms.size(AXIS) <= 1:
        logger.warning(
            "%s requested but data-parallel world is 1 — nothing to "
            "compress, running the plain path", what)
        return None
    if wants_onebit:
        if wants_qwz:
            raise ValueError(
                "1-bit optimizers cannot combine with zero_quantized_weights "
                "(1-bit needs stage 0; qwZ is a stage-3 feature)")
        if config.zero.stage > 0:
            raise ValueError(
                "1-bit optimizers are incompatible with ZeRO stages >= 1 "
                "(per-device error feedback needs the full local momentum; "
                "the reference has the same restriction)")
        if config.precision.is_fp16:
            raise ValueError(
                "1-bit optimizers require bf16/fp32 here (dynamic fp16 "
                "loss scaling would interact with frozen variance); use "
                '"bf16": {"enabled": true}')
        return "onebit"
    if wants_qwz:
        if config.zero.stage != 3:
            raise ValueError(
                "zero_quantized_weights is a stage-3 feature (it compresses "
                "the stage-3 param all-gather, ref ZeRO++ qwZ); set "
                "zero_optimization.stage: 3 or drop the flag")
        if config.precision.is_fp16:
            raise ValueError(
                "zero_quantized_weights requires bf16/fp32 (the flat-shard "
                'step has no fp16 loss-scaling path); use "bf16": '
                '{"enabled": true}')
        if not any(n in name for n in
                   ("adam", "lion", "sgd", "adagrad", "momentum")):
            raise ValueError(
                f"zero_quantized_weights runs the optimizer on flat 1/dp "
                f"shards, which needs elementwise update math; {name!r} "
                f"(per-tensor trust ratios etc.) is not supported")
        return "qwz"
    if config.zero.stage >= 3:
        raise ValueError(
            "zero_quantized_gradients alone supports stages 0-2; for "
            "stage 3 also enable zero_quantized_weights — the combined "
            "qwZ step carries int8 both directions")
    return "qgz"


# ------------------------------------------------ local grad harness
def accumulate_local_grads(grad_fn: Callable, params: Any, batch: Any,
                           accum: int) -> Tuple[Any, torch.Tensor]:
    """Microbatch-accumulated local grads: ``grad_fn(params, mb) ->
    (grads, loss)`` over ``accum`` leading chunks of this rank's batch ->
    (mean f32 grads, mean loss), with no exchange."""
    if accum > 1:
        gacc, lsum = None, None
        for i in range(accum):
            mb = tree_map(lambda x: x.reshape(
                (accum, x.shape[0] // accum) + tuple(x.shape[1:]))[i], batch)
            g, loss = grad_fn(params, mb)
            if gacc is None:
                gacc = tree_map(lambda t: t.float().clone(), g)
                lsum = loss
            else:
                tree_map(lambda a, b: a.add_(b.float()), gacc, g)
                lsum = lsum + loss
        return tree_map(lambda g: g / accum, gacc), lsum / accum
    grads, loss = grad_fn(params, batch)
    return tree_map(lambda g: g.float(), grads), loss


# ------------------------------------------- comm-config routing (v2)
def make_reduce_fn(comm_cfg, ms, bits: Optional[int] = None):
    """``CommConfig`` -> ``(reduce_fn(grad_tree) -> mean tree, Hierarchy)``:
    the two-level path of :mod:`~deepspeed_tpu_torch.comm.collectives`
    with the block's ``hierarchy_size``, ``codec`` and ``bucket_mb``."""
    from deepspeed_tpu_torch.comm import collectives as _hc

    world = ms.size(AXIS)
    h = _hc.resolve_hierarchy(world, comm_cfg.hierarchy_size, ms=ms)
    be = _hc.bucket_elems_for(comm_cfg.bucket_mb, world, comm_cfg.codec)
    fn = functools.partial(
        _hc.hierarchical_all_reduce_tree, axis_name=AXIS, h=h,
        bits=int(bits if bits is not None else comm_cfg.bits),
        codec=comm_cfg.codec, bucket_elems=be)
    return fn, h


def make_weight_gather(comm_cfg, ms, bits: Optional[int] = None):
    """``CommConfig`` -> ``(gather(row) -> [world * chunk], Hierarchy)``,
    qwZ's row gather: hpZ's two hops under a hierarchy, the flat int8
    gather otherwise (bit for bit the same)."""
    from deepspeed_tpu_torch.comm import collectives as _hc

    world = ms.size(AXIS)
    h = _hc.resolve_hierarchy(world, comm_cfg.hierarchy_size, ms=ms)
    b = int(bits if bits is not None else comm_cfg.bits)

    def gather(row):
        return _hc.hpz_weight_gather(
            row, AXIS, h, bits=b, num_groups=row.shape[0] // _GROUP
        ).reshape(-1)

    return gather, h
