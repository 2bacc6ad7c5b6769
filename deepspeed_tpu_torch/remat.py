"""Activation checkpointing policies (port of ``deepspeed_tpu/remat.py``;
ref: deepspeed/runtime/activation_checkpointing/checkpointing.py).

Each policy trades recompute for memory through
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: a wrapped
function keeps only what the policy names between its forward and its
backward, and runs its forward again in the backward for the rest.

- ``none``: no checkpointing.
- ``full``: each block keeps only its input (JAX's ``nothing_saveable``).
- ``save_dots``: each block keeps the outputs of its matrix products
  (``aten.mm``, ``bmm``, ``addmm``, ``baddbmm``) and recomputes the rest
  (JAX's ``checkpoint_dots``); ``save_dots_no_batch`` keeps only the 2-D
  products, the weight products that ``x @ W`` folds into, and recomputes
  the batched ones (JAX's ``checkpoint_dots_with_no_batch_dims``).  Both are
  selective-checkpoint policies over the ops PyTorch dispatches.  The flash
  kernels launch through ctypes inside their ``autograd.Function``, which
  the dispatcher does not see, so they are recomputed, as the Pallas call
  is under JAX's policies (it is not a ``dot_general``).
- ``save_attn``: each block keeps the two tensors the JAX model tags with
  ``checkpoint_name``: ``attn_out`` (the attention context) and ``mlp_out``
  (the FFN inner activation).  The model checkpoints the two stages that
  produce them (:func:`checkpoint_named`), so everything inside a stage is
  recomputed and the stage outputs are kept, plus the residual stream
  between the stages.

Every policy but ``none`` runs the flash forward (B1) again in the backward,
so B1 launches twice per layer and microbatch.  The JAX package's
``offload_*`` policies move the saved tensors to host memory; they raise
here (ROADMAP A1, the offload remat policies), and so does any other name
(``ValueError``, as in JAX).  No policy is swapped for another.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = ("none", "full", "save_dots", "save_dots_no_batch", "save_attn")
_OFFLOAD = ("offload_attn", "offload_dots_no_batch")

_aten = torch.ops.aten
_DOTS = {
    "save_dots": (_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
                  _aten.baddbmm.default),
    "save_dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


def check(name) -> str:
    """``name`` if it is a ported policy (None means ``"none"``); the
    offload policies raise ``NotImplementedError``, any other name
    ``ValueError``."""
    name = "none" if name is None else name
    if name in _OFFLOAD:
        raise NotImplementedError(
            f"remat policy {name!r}: the host-offload remat policies are not "
            "ported yet (ROADMAP A1)")
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}")
    return name


def _saves(ops):
    def decide(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return decide


def policy(name: str):
    """The selective-checkpoint policy function of ``save_dots`` /
    ``save_dots_no_batch`` (``(ctx, op, *args) -> CheckpointPolicy``); None
    for the policies that need none (``none``, ``full``, ``save_attn``)."""
    ops = _DOTS.get(check(name))
    return None if ops is None else _saves(ops)


def checkpoint_block(fn, name: str = "full"):
    """Wrap a layer function with the named policy.  ``save_attn`` leaves
    the block as it is: its model checkpoints the named stages inside it
    (:func:`checkpoint_named`)."""
    name = check(name)
    if name in ("none", "save_attn"):
        return fn
    decide = policy(name)
    kw = {} if decide is None else {
        "context_fn": lambda: create_selective_checkpoint_contexts(decide)}

    @functools.wraps(fn)
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def checkpoint_named(fn, name: str):
    """Under ``save_attn``: ``fn``'s output (a tensor the JAX model names
    with ``checkpoint_name``) is kept, and everything ``fn`` computes on the
    way is recomputed in the backward.  Under any other policy ``fn`` is
    returned as it is."""
    if check(name) != "save_attn":
        return fn

    @functools.wraps(fn)
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return wrapped
