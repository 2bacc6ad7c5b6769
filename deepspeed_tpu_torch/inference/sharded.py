"""Model-parallel placement of a serving or inference param tree (port of
``_shard_params_for_serving``, ``_quantized_shard_params`` and
``quantized.shard_quantized`` of the JAX package; ref: module_inject's
TP injection, int8 + ``mp_size``).

Every rank of a serving replica holds the whole tree on the host (or the
card) and keeps its own block of each leaf under the model's specs
(:func:`~deepspeed_tpu_torch.zero.local_shard` over ``model`` and
``expert``).  Three placements, as in the JAX package:

- exact: the block, in the leaf's dtype;
- int8 weights (``weight_dtype="int8"``): the whole leaf quantized on the
  card (B9), then its codes cut like the weight and its per-row group
  scales cut alongside (a split last dim splits the groups), so the
  codes and scales are the unsharded engine's;
- the int8 wire (``comm.quantized_serving``): each float leaf of at least
  1024 elements is quantized on the host with the wire codec (symmetric
  int8 over the flattened leaf in groups of 4096 elements, one group when
  4096 does not divide it), its round trip gated by ``serving_rtol``; the
  rank uploads its block's codes and the leaf's scales and dequantizes on
  the card into the leaf's dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import zero
from deepspeed_tpu_torch.inference.quantized import (QuantizedTensor, _is_qt,
                                                     _pick_groups)
from deepspeed_tpu_torch.topology import fused_parts

# the wire codec's group (the JAX codec's 8 x 512 block) and the leaves it
# leaves exact: below this, scales would outweigh the payload saved, and
# tiny leaves are the accuracy-critical ones (norm gains, biases)
WIRE_BLOCK_ELEMS = 8 * 512
WIRE_MIN_ELEMS = 1024


def shard_quantized(qt: QuantizedTensor, spec, ms) -> QuantizedTensor:
    """This rank's block of an int8 leaf: the codes cut like the weight,
    the scales (``q.shape[:-1] + (groups,)``) cut on the same leading dims
    and, where the spec splits the last dim, on their groups, which must
    then split evenly with it (a single group a row stays whole; a fused
    spec's parts each split so)."""
    q = zero.local_shard(qt.q, spec, ms)
    sspec = spec
    if len(spec) == qt.q.dim() and spec[-1] is not None:
        ways = qt.q.shape[-1] // q.shape[-1]
        groups = qt.scale.shape[-1]
        parts = fused_parts(spec)
        if groups == 1:
            # one group a row covers every block of the row: each rank
            # keeps the row's scale (JAX replicates a scale dim the mesh
            # cannot divide)
            sspec = tuple(spec)[:-1] + (None,)
        elif groups % (ways * parts):
            raise ValueError(
                f"an int8 leaf of {groups} groups a row does not split "
                f"{ways} ways with its weight"
                + (f" in each of its {parts} fused parts" if parts > 1
                   else "")
                + ": pick a quant_group_size that divides the rank's block")
    return QuantizedTensor(q=q.contiguous(), scale=zero.local_shard(
        qt.scale, sspec, ms).contiguous())


def wire_quantize_np(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The host wire codec (the JAX ``quantize_for_wire_np``): symmetric
    int8 codes of ``a`` and f32 scales over its flattened elements in
    groups of :data:`WIRE_BLOCK_ELEMS` (one group when that does not divide
    the size), rounding half to even, a zero group scale 1."""
    g = a.size // WIRE_BLOCK_ELEMS if (
        a.size and a.size % WIRE_BLOCK_ELEMS == 0) else 1
    grouped = a.astype(np.float32).reshape(g, -1)
    scale = np.abs(grouped).max(axis=1) / 127.0
    scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
    q = np.clip(np.round(grouped / scale[:, None]), -127, 127).astype(
        np.int8)
    return q.reshape(a.shape), scale


def _block_flat_index(shape, spec, ms, device) -> torch.Tensor:
    """The flattened whole-leaf index of every element of this rank's
    block (int64, the block's shape), summed from one range a dim."""
    idx, stride = None, 1
    strides = []
    for n in reversed(shape):
        strides.append(stride)
        stride *= n
    strides.reverse()
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        ways, i = (1, 0) if entry is None else zero._entry_index(entry, ms)
        runs = (zero._split_runs(n, ways, i, fused_parts(spec))
                if ways > 1 else [(0, n)])
        pos = torch.cat([torch.arange(a, a + c, device=device)
                         for a, c in runs])
        view = [1] * len(shape)
        view[d] = pos.numel()
        part = (pos * strides[d]).view(view)
        idx = part if idx is None else idx + part
    return idx


def _wire_place(leaf: torch.Tensor, spec, ms, dev, rtol: float,
                stats: Dict[str, Any], name: str) -> torch.Tensor:
    a = leaf.detach().float().cpu().numpy()
    q, s = wire_quantize_np(a)
    deq = (q.astype(np.float32).reshape(s.size, -1)
           * s[:, None]).reshape(a.shape)
    ref = float(np.abs(a).max()) or 1.0
    rel = float(np.abs(deq - a).max()) / ref
    if rel > rtol:
        raise ValueError(
            f"comm.quantized_serving: leaf {name!r} {tuple(a.shape)} "
            f"round-trips at rel err {rel:.3e} > serving_rtol {rtol:g}: "
            "raise the tolerance or serve this model unquantized")
    qb = zero.local_shard(torch.from_numpy(q), spec, ms).contiguous()
    stats["leaves_quantized"] += 1
    stats["bytes_on_wire_int8"] += qb.numel() + s.nbytes
    stats["bytes_on_wire_f32"] += qb.numel() * 4
    stats["max_rel_err"] = max(stats["max_rel_err"], rel)
    # the upload is the wire: int8 codes and f32 scales
    q_dev, s_dev = qb.to(dev), torch.from_numpy(s).to(dev)
    gs = a.size // s.size
    group = _block_flat_index(a.shape, spec, ms, dev) // gs
    return (q_dev.float() * s_dev[group]).to(leaf.dtype)


def place_for_serving(params: Any, specs: Any, ms, device,
                      weight_dtype: str = "bfloat16",
                      group_size: int = 128, skip_paths=(),
                      comm_cfg=None) -> Tuple[Any, Optional[dict]]:
    """``params`` (whole leaves; tensors on the host or the card) placed on
    ``device`` as this rank's blocks under ``specs`` -> ``(tree, stats)``:
    exact blocks, or int8 codes and scales cut from the whole leaf's
    (``weight_dtype="int8"``, B9 on CUDA; leaves named in ``skip_paths``,
    with ndim < 2 or not floating stay exact), or the int8 wire's
    dequantized blocks (``comm_cfg.quantized_serving``; ``stats`` then has
    the JAX package's placement counts, else None)."""
    from deepspeed_tpu_torch.ops.quant import quantize

    wire = comm_cfg is not None and comm_cfg.quantized_serving
    stats = None
    if wire:
        stats = {"leaves_quantized": 0, "leaves_exact": 0,
                 "bytes_on_wire_int8": 0, "bytes_on_wire_f32": 0,
                 "max_rel_err": 0.0,
                 "serving_rtol": float(comm_cfg.serving_rtol)}
    skip = set(skip_paths)

    def one(name, leaf, spec):
        if _is_qt(leaf):
            return shard_quantized(QuantizedTensor(
                q=leaf.q.to(device), scale=leaf.scale.to(device)), spec, ms)
        leaf = torch.as_tensor(leaf)
        if weight_dtype == "int8" and name not in skip \
                and leaf.dim() >= 2 and leaf.is_floating_point():
            whole = leaf.to(device)
            q, scale, _ = quantize(whole, bits=8,
                                   num_groups=_pick_groups(whole,
                                                           group_size))
            del whole
            return shard_quantized(QuantizedTensor(
                q=q, scale=scale.reshape(leaf.shape[:-1] + (-1,))), spec, ms)
        if wire and leaf.is_floating_point() \
                and leaf.numel() >= WIRE_MIN_ELEMS:
            return _wire_place(leaf, spec, ms, device,
                               float(comm_cfg.serving_rtol), stats, name)
        if wire:
            stats["leaves_exact"] += 1
        return zero.local_shard(leaf, spec, ms).to(device).contiguous()

    out = _walk(params, specs, one, "")
    if stats is not None:
        i8 = stats["bytes_on_wire_int8"]
        stats["compression_ratio"] = round(
            stats["bytes_on_wire_f32"] / i8, 4) if i8 else 0.0
        stats["max_rel_err"] = round(stats["max_rel_err"], 8)
    return out, stats


def _walk(params, specs, fn, name):
    if isinstance(params, dict):
        return {k: _walk(v, None if specs is None else specs.get(k), fn,
                         str(k)) for k, v in params.items()}
    if isinstance(params, (list, tuple)) and not _is_qt(params):
        return type(params)(_walk(v, None if specs is None else specs[i],
                                  fn, "") for i, v in enumerate(params))
    return fn(name, params, zero._norm_spec(specs))
