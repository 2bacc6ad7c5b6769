"""Weight-only int8 inference (port of ``deepspeed_tpu/inference/
quantized.py``; ref: deepspeed ``init_inference(dtype=torch.int8)`` and the
quantizer op family under deepspeed/ops/quantizer).

Weights live on the card as int8 codes plus one f32 scale per group of
(by default) 128 contiguous elements along the last axis: 0.516x the bf16
bytes, so a model about twice the size fits one card.  Every matrix leaf is
quantized by the group-quantize kernel B9 on CUDA (its plain version on the
CPU).  Dequantization is plain PyTorch, ``f32(code) * scale`` rounded to
bfloat16 as the JAX package computes it; the Llama forward
(:mod:`~deepspeed_tpu_torch.models.llama`) dequantizes one layer at a time,
so the bf16 copy on the card is one layer's, never the model's; such
forwards carry the :func:`takes_quantized` mark and get the quantized tree
as it is.  :func:`quantized_apply` wraps any other forward and dequantizes
the whole tree per call, as the JAX package does for every forward.
``shard_quantized`` comes with the distributed slice.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, NamedTuple

import torch

from deepspeed_tpu_torch._tree import _is_namedtuple
from deepspeed_tpu_torch.ops.quant import dequantize, quantize

logger = logging.getLogger(__name__)

# the dtype the JAX package's quantized_apply dequantizes to
DEQUANT_DTYPE = torch.bfloat16


class QuantizedTensor(NamedTuple):
    """A group-quantized weight: int8 codes + per-group f32 scales.

    Groups are contiguous runs along the LAST axis, so the scale is stored
    ``q.shape[:-1] + (groups_per_row,)``: the same leading dims as the
    weight, so a slice of the leading dims (one layer of a stacked leaf,
    the rows of an embedding) slices both alike."""

    q: torch.Tensor          # int8, original shape
    scale: torch.Tensor      # f32, q.shape[:-1] + (groups_per_row,)

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())


def _is_qt(x) -> bool:
    return isinstance(x, QuantizedTensor)


def take(w, index=...):
    """Leaf ``w`` at ``index`` of its leading dims as a dense tensor: a
    :class:`QuantizedTensor` gathers its codes and scale rows first and
    dequantizes only those to :data:`DEQUANT_DTYPE` (one layer of a stacked
    leaf, the embedding rows of a batch); a tensor is indexed as it is."""
    if _is_qt(w):
        return dequantize(w.q[index], w.scale[index], dtype=DEQUANT_DTYPE)
    return w[index]


def _map(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over a param tree of dicts, lists and tuples,
    :class:`QuantizedTensor` counting as one leaf; ``name`` is the leaf's
    last dict key ("" inside a list or tuple).  Module-level recursion (no
    self-calling closure, so no reference cycle pins the leaves)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, str(k)) for k, v in tree.items()}
    if _is_qt(tree) or not isinstance(tree, (list, tuple)):
        return fn(name, tree)
    items = [_map(fn, v) for v in tree]
    return type(tree)(*items) if _is_namedtuple(tree) else type(tree)(items)


def _leaves(tree):
    """Leaves in :func:`_map` order, :class:`QuantizedTensor` as one."""
    out = []
    _map(lambda _, leaf: out.append(leaf), tree)
    return out


def _pick_groups(leaf, group_size: int) -> int:
    """Number of groups for ``leaf``: the widest divisor of the LAST dim
    that is <= ``group_size`` (so every group sits inside one row and the
    scale reshapes to ``leaf.shape[:-1] + (-1,)``).  A last dim with no
    usable divisor (e.g. prime) degrades to one group per row, and a row
    much wider than asked for logs a warning."""
    n = leaf.numel()
    last = leaf.shape[-1] if leaf.dim() else n
    gs = min(max(group_size, 1), last)
    while last % gs:
        gs -= 1
    if gs * 8 <= group_size:
        # per-element-ish groups would spend 4 scale bytes per weight
        # byte: per-row groups cost less (the reference's row fallback)
        gs = last
    if gs > 8 * group_size:
        logger.warning(
            "int8 quantization of a %s-shaped weight uses groups of %d "
            "elements (requested %d): expect elevated quantization error",
            tuple(leaf.shape), gs, group_size)
    return n // gs


def quantize_params(params: Any, *, bits: int = 8, group_size: int = 128,
                    min_ndim: int = 2, skip_paths=()) -> Any:
    """Quantize every floating leaf with ``ndim >= min_ndim`` to int8
    groups (one B9 launch per leaf on CUDA; its plain version on the
    CPU).  ``skip_paths``: leaf key names kept exact
    whatever their ndim (a stacked tree's ``[L, d]`` norm gains pass the
    ndim gate).  Leaves that are already :class:`QuantizedTensor` pass
    through, so a quantized tree may be handed to another engine."""
    if bits != 8:
        raise NotImplementedError("weight-only inference quant: int8 only")
    skip = set(skip_paths)

    def one(name, leaf):
        if _is_qt(leaf) or name in skip or leaf.dim() < min_ndim \
                or not leaf.is_floating_point():
            return leaf
        q, scale, _ = quantize(leaf, bits=8,
                               num_groups=_pick_groups(leaf, group_size))
        return QuantizedTensor(q=q, scale=scale.reshape(
            leaf.shape[:-1] + (-1,)))

    return _map(one, params)


def dequantize_params(params: Any, dtype=DEQUANT_DTYPE) -> Any:
    """Inverse of :func:`quantize_params`: every :class:`QuantizedTensor`
    to a dense ``dtype`` tensor, other leaves as they are."""
    return _map(lambda _, leaf: dequantize(leaf.q, leaf.scale, dtype=dtype)
                if _is_qt(leaf) else leaf, params)


def quantized_apply(apply_fn, dtype=DEQUANT_DTYPE):
    """Wrap ``apply_fn(params, *args)`` to accept quantized params: the
    whole tree dequantizes on each call (for a forward that does not take
    :class:`QuantizedTensor` leaves itself)."""
    def fn(qparams, *args, **kw):
        return apply_fn(dequantize_params(qparams, dtype), *args, **kw)

    return fn


def takes_quantized(fn):
    """Mark ``fn(params, ...)`` as a forward that reads
    :class:`QuantizedTensor` leaves itself, dequantizing each where it is
    read (the Llama forwards): :func:`quantize_for_inference` then hands it
    the quantized tree instead of wrapping it in :func:`quantized_apply`."""
    fn.takes_quantized = True
    return fn


def _takes_quantized(fn) -> bool:
    while isinstance(fn, functools.partial):
        fn = fn.func
    return getattr(fn, "takes_quantized", False)


def quantize_for_inference(params: Any, *apply_fns,
                           weight_dtype: str = "int8",
                           group_size: int = 128, dtype=DEQUANT_DTYPE,
                           skip_paths=()):
    """One-stop weight-only quantization for an inference path: validates
    ``weight_dtype``, quantizes the params and wraps every forward with
    :func:`quantized_apply`, but for a :func:`takes_quantized` forward (or a
    ``functools.partial`` of one), which gets the quantized tree as it is.
    Returns ``(qparams, fn, ...)``."""
    if weight_dtype != "int8":
        raise NotImplementedError(
            f"weight-only quantized inference supports 'int8' only, got "
            f"{weight_dtype!r}")
    qparams = quantize_params(params, group_size=group_size,
                              skip_paths=skip_paths)
    return (qparams, *[f if _takes_quantized(f) else quantized_apply(f, dtype)
                       for f in apply_fns])


def param_bytes(params: Any) -> int:
    """Bytes the leaves of a (possibly quantized) tree hold."""
    return sum(leaf.nbytes() if _is_qt(leaf)
               else leaf.numel() * leaf.element_size()
               for leaf in _leaves(params))


def quantization_error(params: Any, qparams: Any) -> float:
    """Max relative L2 error across quantized leaves (diagnostics)."""
    worst = 0.0
    for a, b in zip(_leaves(params), _leaves(qparams)):
        if _is_qt(b):
            d = dequantize(b.q, b.scale, dtype=torch.float32)
            a = a.float()
            num = float(torch.linalg.vector_norm(a - d))
            den = float(torch.linalg.vector_norm(a)) or 1.0
            worst = max(worst, num / den)
    return worst
