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
- ``offload_attn`` and ``offload_dots_no_batch`` (the reference's
  ``cpu_checkpointing``): each keeps exactly the tensors of its on-device
  twin (:data:`OFFLOAD`: ``save_attn``, ``save_dots_no_batch``), but
  between the forward and the backward those tensors live in pinned host
  memory (:class:`HostOffload`).  ``offload_attn`` moves the named stage
  outputs through ``torch.autograd.graph.saved_tensors_hooks``;
  ``offload_dots_no_batch`` moves the kept products through a pair of
  dispatch modes that take the place of the selective-checkpoint contexts.
  No policy is swapped for another: JAX's ``resolve_policy`` downgrade is a
  limit of XLA's CPU mesh and is not copied.  On a CPU tensor the move is
  the identity, and the policy still runs.

Every policy but ``none`` runs the flash forward (B1) again in the
backward, so B1 launches twice per layer and microbatch.  Any other name
raises ``ValueError``, as in JAX.
"""

from __future__ import annotations

import collections
import functools
import itertools
import weakref
from typing import Optional

import torch
from torch.autograd.graph import saved_tensors_hooks
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = ("none", "full", "save_dots", "save_dots_no_batch", "save_attn")
# offload policy -> its on-device twin, which keeps the same tensors
OFFLOAD = {"offload_attn": "save_attn",
           "offload_dots_no_batch": "save_dots_no_batch"}

_aten = torch.ops.aten
_DOTS = {
    "save_dots": (_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
                  _aten.baddbmm.default),
    "save_dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}
# saved tensors the backward reads next that are copied back ahead of use
PREFETCH = 2


def check(name) -> str:
    """``name`` if it is a policy (None means ``"none"``); any other name
    raises ``ValueError``."""
    name = "none" if name is None else name
    if name not in POLICIES and name not in OFFLOAD:
        raise ValueError(f"unknown remat policy {name!r}")
    return name


def _saves(ops):
    def decide(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return decide


def policy(name: str):
    """The selective-checkpoint policy function of ``save_dots`` /
    ``save_dots_no_batch`` and of ``offload_dots_no_batch``, which keeps the
    same products (``(ctx, op, *args) -> CheckpointPolicy``); None for the
    policies that need none (``none``, ``full``, ``save_attn``,
    ``offload_attn``)."""
    name = check(name)
    ops = _DOTS.get(OFFLOAD.get(name, name))
    return None if ops is None else _saves(ops)


# ------------------------------------------------------------ host offload
class _Offloaded:
    """One saved CUDA tensor in pinned host memory: copied out on the
    offload stream when it is saved, and copied back into a fresh card
    buffer (on that stream, ahead of use where the backward's order allows)
    when the backward asks for it.  ``prev`` (set by the saved-tensor hooks
    of ``offload_attn``) is the tensor saved just before this one, which
    the backward reads after it."""

    __slots__ = ("owner", "host", "device", "prev", "_buf", "_ready",
                 "_loaded", "__weakref__")

    def __init__(self, owner: "HostOffload", t: torch.Tensor):
        self.owner, self.device = owner, t.device
        side = owner.stream(t.device)
        self.host = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                                        device="cpu", pin_memory=True)
        # the copy starts once the producer of t has run on the main stream,
        # and t's block is not handed out again before the copy has read it
        side.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(side):
            self.host.copy_(t, non_blocking=True)
        t.record_stream(side)
        self.prev = None
        self._buf: Optional[torch.Tensor] = None
        self._ready: Optional[torch.cuda.Event] = None
        self._loaded = False

    def _copy_back(self) -> None:
        """Copy the host tensor into a fresh card buffer on the offload
        stream.  The buffer comes from the main stream's pool, so the
        offload stream first waits for the main stream's work so far (the
        buffer's earlier users), and the buffer records the offload stream,
        so that dropping it unread cannot hand its block out again while
        the copy may still be writing it."""
        side = self.owner.stream(self.device)
        buf = torch.empty_strided(self.host.size(), self.host.stride(),
                                  dtype=self.host.dtype, device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            buf.copy_(self.host, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record(side)
        buf.record_stream(side)
        self._buf = buf

    def fetch(self) -> None:
        """Start the copy back ahead of use: once, and not after the
        tensor was loaded."""
        if self._buf is None and not self._loaded:
            self._copy_back()

    def load(self) -> torch.Tensor:
        """The tensor back on the card, ordered before the main stream's
        next kernels; the next ``PREFETCH`` tensors of the ``prev`` chain
        (those saved just before this one) start their copies."""
        if self._buf is None:
            self._copy_back()
        torch.cuda.current_stream(self.device).wait_event(self._ready)
        out, self._buf, self._loaded = self._buf, None, True
        nxt = self.prev and self.prev()
        for _ in range(PREFETCH):
            if nxt is None:
                break
            nxt.fetch()
            nxt = nxt.prev and nxt.prev()
        return out


class HostOffload:
    """Moves saved tensors to pinned host memory between the forward and
    the backward (the offload policies' storage).  ``tensors`` / ``bytes``
    count what was moved (on the CPU, what would have been: the move is the
    identity there).  One side stream per card carries the copies."""

    def __init__(self):
        self.tensors = 0
        self.bytes = 0
        self._streams = {}
        self._last = None            # weakref to the latest named _Offloaded
        self._named = []             # weakrefs to live named stage outputs

    def reset(self) -> None:
        self.tensors = self.bytes = 0

    def stream(self, device) -> torch.cuda.Stream:
        s = self._streams.get(device.index)
        if s is None:
            s = self._streams[device.index] = torch.cuda.Stream(device)
        return s

    def pack(self, t: torch.Tensor):
        self.tensors += 1
        self.bytes += t.numel() * t.element_size()
        return _Offloaded(self, t) if t.is_cuda else t

    @staticmethod
    def unpack(x) -> torch.Tensor:
        return x.load() if isinstance(x, _Offloaded) else x

    # offload_attn: only the named stage outputs move
    def name(self, out: torch.Tensor) -> torch.Tensor:
        """Mark ``out`` as a named stage output for as long as it lives."""
        self._named = [r for r in self._named if r() is not None]
        self._named.append(weakref.ref(out))
        return out

    def _is_named(self, t: torch.Tensor) -> bool:
        ptr = t.untyped_storage().data_ptr()
        return ptr != 0 and any(
            o is not None and o.untyped_storage().data_ptr() == ptr
            for o in (r() for r in self._named))

    def pack_named(self, t: torch.Tensor):
        """A named stage output goes to host, linked to the one saved just
        before it (the backward reads them in the reverse order)."""
        if not self._is_named(t):
            return t
        x = self.pack(t)
        if isinstance(x, _Offloaded):
            x.prev, self._last = self._last, weakref.ref(x)
        return x

    def named_hooks(self) -> saved_tensors_hooks:
        return saved_tensors_hooks(self.pack_named, self.unpack)


offload = HostOffload()


class _OffloadDots(TorchDispatchMode):
    """``offload_dots_no_batch``'s contexts: in the forward, each kept
    product's output is moved to host (``offload.pack``) into ``store``; in
    the recompute, each such op returns its stored output, copied back,
    instead of running (the selective-checkpoint contexts, with the host in
    place of the card).  The recompute copies the next ``PREFETCH``
    products back ahead of use, but never the block's last: non-reentrant
    ``checkpoint`` stops the recompute once the last saved tensor is back,
    which is before a block's final product when nothing saves its output,
    and that copy would be read by no one."""

    def __init__(self, ops, store, recompute: bool):
        super().__init__()
        self.ops, self.store, self.recompute = ops, store, recompute

    def _prefetch(self) -> None:
        ahead = max(0, min(PREFETCH, len(self.store) - 1))
        for x in itertools.islice(self.store, ahead):
            if isinstance(x, _Offloaded):
                x.fetch()

    def __enter__(self):
        if self.recompute:
            self._prefetch()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.ops and self.recompute:
            out = offload.unpack(self.store.popleft())
            self._prefetch()
            return out
        out = func(*args, **(kwargs or {}))
        if func in self.ops:
            self.store.append(offload.pack(out))
        return out


def _offload_dots_contexts(ops):
    store = collections.deque()
    return (_OffloadDots(ops, store, False), _OffloadDots(ops, store, True))


def checkpoint_block(fn, name: str = "full"):
    """Wrap a layer function with the named policy.  ``save_attn`` leaves
    the block as it is: its model checkpoints the named stages inside it
    (:func:`checkpoint_named`); ``offload_attn`` runs the block under the
    saved-tensor hooks that move those stages' outputs to host."""
    name = check(name)
    if name in ("none", "save_attn"):
        return fn
    if name == "offload_attn":
        @functools.wraps(fn)
        def hooked(*args):
            with offload.named_hooks():
                return fn(*args)

        return hooked
    if name == "offload_dots_no_batch":
        ops = _DOTS[OFFLOAD[name]]
        kw = {"context_fn": lambda: _offload_dots_contexts(ops)}
    else:
        decide = policy(name)
        kw = {} if decide is None else {
            "context_fn": lambda: create_selective_checkpoint_contexts(
                decide)}

    @functools.wraps(fn)
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def checkpoint_named(fn, name: str):
    """Under ``save_attn`` and ``offload_attn``: ``fn``'s output (a tensor
    the JAX model names with ``checkpoint_name``) is kept, on the card or
    in host memory, and everything ``fn`` computes on the way is recomputed
    in the backward.  Under any other policy ``fn`` is returned as it
    is."""
    name = check(name)
    if OFFLOAD.get(name, name) != "save_attn":
        return fn

    @functools.wraps(fn)
    def wrapped(*args):
        out = checkpoint(fn, *args, use_reentrant=False)
        return offload.name(out) if name == "offload_attn" else out

    return wrapped
