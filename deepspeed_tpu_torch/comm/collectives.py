"""Hierarchical (two-level) and quantized collectives (port of
``deepspeed_tpu/comm/collectives.py``; ref: ZeRO++ hpZ / qgZ,
arXiv:2306.10209).

The ``data`` axis is factored into ``(inter, intra)`` sub-groups, built as
process groups of the axis's ranks:

* **intra group**: the ``hierarchy_size`` ranks of one node (axis positions
  ``n k .. n k + k - 1``): fast links, cheap bytes;
* **inter group**: the same intra position on every node (``j, k + j,
  2 k + j, ...``): the slow tier every eliminated hop pays for.

:func:`hierarchical_all_reduce` is the gradient all-reduce as intra
reduce-scatter, inter reduce-scatter, inter gather, intra gather, every hop
on the int8 wire (``codec="exact"``: the same schedule in f32).
:func:`hpz_weight_gather` is qwZ's weight gather whose inter hop carries
``inter`` int8 rows instead of ``world``, bit for bit the flat gather's
result (one quantization, before any hop).  :func:`bucketed_reduce` runs
the reduction a fixed-size bucket at a time; buckets aligned to ``world x
codec unit`` put the same codes on the wire as one buffer.  The wire's
codes come from the port's ``ops/quant.quantize`` (B9 on a CUDA tensor).
The engine reaches this module through ``comm_compress.make_reduce_fn``
(qgZ) and ``make_weight_gather`` (qwZ, hpZ).

Codecs (``CommConfig.codec``): ``blockwise`` (4096-element blocks),
``group`` (the flat 512-element grid), ``exact`` (f32, bit-exact bypass).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import torch
import torch.distributed as dist

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch._tree import tree_leaves, tree_unflatten_like
from deepspeed_tpu_torch.mesh import detect_hierarchy_size
from deepspeed_tpu_torch.ops.quant import (
    BLOCK_ELEMS, dequantize, quantize, quantized_all_gather,
    quantized_reduce_scatter)

__all__ = [
    "Hierarchy", "resolve_hierarchy", "codec_unit",
    "hierarchical_all_reduce", "hierarchical_all_reduce_tree",
    "hpz_weight_gather", "bucketed_reduce", "bucket_elems_for",
]

# the flat grid (comm_compress._GROUP), kept as a codec
_GROUP_UNIT = 512

_CODEC_UNITS = {"blockwise": BLOCK_ELEMS, "group": _GROUP_UNIT, "exact": 1}


def codec_unit(codec: str) -> int:
    """Elements per quantization scale for a wire codec."""
    try:
        return _CODEC_UNITS[codec]
    except KeyError:
        raise ValueError(
            f"unknown wire codec {codec!r} (one of {sorted(_CODEC_UNITS)})")


# ------------------------------------------------------------ hierarchy
@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """The (inter, intra) factoring of the data axis.  ``intra == 1`` or
    ``inter == 1`` is the flat schedule, which every entry point below
    takes.  ``intra_group`` / ``inter_group`` are this rank's process
    groups (None on the flat schedule)."""

    world: int
    intra: int
    intra_group: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)
    inter_group: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    def __post_init__(self):
        if self.world <= 0:
            raise ValueError(f"world must be positive, got {self.world}")
        if self.intra <= 0:
            raise ValueError(
                f"hierarchy_size must be positive, got {self.intra}")
        if self.world % self.intra:
            raise ValueError(
                f"hierarchy_size {self.intra} does not divide the data-"
                f"parallel world {self.world}: pick a divisor (nodes "
                "must be uniform)")

    @property
    def inter(self) -> int:
        return self.world // self.intra

    @property
    def flat(self) -> bool:
        return self.intra == 1 or self.inter == 1

    @functools.cached_property
    def intra_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """Node n = contiguous axis positions [n k, (n + 1) k)."""
        k = self.intra
        return tuple(tuple(range(n * k, (n + 1) * k))
                     for n in range(self.inter))

    @functools.cached_property
    def inter_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """Intra position j across all nodes: [j, k + j, 2 k + j, ...]."""
        k = self.intra
        return tuple(tuple(j + n * k for n in range(self.inter))
                     for j in range(k))

    def with_groups(self, ms) -> "Hierarchy":
        """This hierarchy with this rank's intra and inter process groups
        over ``ms``'s data axis.  Every rank of the axis must call it (each
        group is created by all of them, in one order)."""
        if self.flat or ms is None or ms.device_mesh is None:
            return self
        ranks = list(ms.axis_ranks("data"))
        me = ms.rank_in("data")

        def build(sets):
            mine = None
            for s in sets:
                g = dist.new_group([ranks[p] for p in s])
                if me in s:
                    mine = g
            return mine

        return dataclasses.replace(self, intra_group=build(self.intra_groups),
                                   inter_group=build(self.inter_groups))


def resolve_hierarchy(world: int, hierarchy_size: int = 0,
                      ms=None) -> Hierarchy:
    """``CommConfig.hierarchy_size`` -> a validated :class:`Hierarchy`
    with its process groups over ``ms``.  0 auto-detects the ranks per node
    (:func:`~deepspeed_tpu_torch.mesh.detect_hierarchy_size`; flat when
    that does not divide the world); an explicit non-divisor raises."""
    if hierarchy_size == 0:
        k = detect_hierarchy_size()
        h = Hierarchy(world, 1 if k <= 1 or world % k else k)
    else:
        h = Hierarchy(world, hierarchy_size)
    return h.with_groups(ms)


# ------------------------------------------------- hierarchical all-reduce
def _pad_flat(flat: torch.Tensor, unit: int) -> torch.Tensor:
    n = flat.shape[0]
    pn = -(-n // unit) * unit
    if pn == n:
        return flat
    return torch.cat([flat, flat.new_zeros(pn - n)])


def hierarchical_all_reduce(flat: torch.Tensor, axis_name: str,
                            h: Hierarchy, *, bits: int = 8,
                            codec: str = "blockwise") -> torch.Tensor:
    """Two-level all-reduce (the mean over the axis) of a flat buffer
    whose size is a multiple of ``world x codec unit``: intra quantized
    reduce-scatter (all-to-all), inter quantized reduce-scatter, inter
    int8 gather, intra int8 gather; only the middle two hops cross nodes.
    The flat schedule is one quantized reduce-scatter and one gather."""
    U = codec_unit(codec)
    W, k, m = h.world, h.intra, h.inter
    n = flat.shape[0]
    if n % (W * U):
        raise ValueError(
            f"buffer of {n} elements is not aligned to world*unit = "
            f"{W}*{U}: pad before calling")
    if h.flat:
        if codec == "exact":
            red = comm.reduce_scatter(flat, axis_name, op=comm.ReduceOp.AVG)
            return comm.all_gather(red, axis_name)
        red = quantized_reduce_scatter(
            flat, axis_name, bits=bits, groups_per_shard=n // (W * U))
        return quantized_all_gather(
            red, axis_name, bits=bits, num_groups=red.shape[0] // U
        ).reshape(-1)
    intra, inter = h.intra_group, h.inter_group
    if codec == "exact":
        red = comm.reduce_scatter(flat, axis_name, op=comm.ReduceOp.AVG,
                                  group=intra)
        red = comm.reduce_scatter(red, axis_name, op=comm.ReduceOp.AVG,
                                  group=inter)
        red = comm.all_gather(red, axis_name, group=inter)
        return comm.all_gather(red, axis_name, group=intra)
    # 1) intra reduce-scatter: [n] -> [n/k], the node's mean
    red = quantized_reduce_scatter(
        flat, axis_name, bits=bits, groups_per_shard=n // (k * U),
        group=intra, group_size=k)
    # 2) inter reduce-scatter: [n/k] -> [n/(k m)], the global mean
    red = quantized_reduce_scatter(
        red, axis_name, bits=bits, groups_per_shard=n // (k * m * U),
        group=inter, group_size=m)
    # 3) inter int8 gather: back to the intra shard [n/k]
    red = quantized_all_gather(
        red, axis_name, bits=bits, num_groups=red.shape[0] // U,
        group=inter).reshape(-1)
    # 4) intra int8 gather: the whole [n] on every rank
    return quantized_all_gather(
        red, axis_name, bits=bits, num_groups=red.shape[0] // U,
        group=intra).reshape(-1)


# ------------------------------------------------------- bucketed overlap
def bucket_elems_for(bucket_mb: float, world: int, codec: str) -> int:
    """Bucket size in elements, rounded up to ``world x codec unit`` so
    each bucket's quantization grid is the whole buffer's (bucketing ships
    the same codes).  0 -> 0 (one buffer)."""
    if bucket_mb <= 0:
        return 0
    unit = world * codec_unit(codec)
    raw = max(1, int(bucket_mb * (1 << 20)) // 4)      # f32 elements
    return -(-raw // unit) * unit


def bucketed_reduce(flat: torch.Tensor, reduce_1d, bucket_elems: int
                    ) -> torch.Tensor:
    """``reduce_1d`` (an aligned all-reduce of a 1-D buffer) a bucket at a
    time (the reference's NCCL-bucket idiom).  ``flat`` is padded to whole
    buckets inside and cut back on return."""
    if bucket_elems <= 0 or flat.shape[0] <= bucket_elems:
        return reduce_1d(flat)
    padded = _pad_flat(flat, bucket_elems)
    out = torch.cat([reduce_1d(b) for b in padded.split(bucket_elems)])
    return out[:flat.shape[0]]


# ------------------------------------------------- tree-level entry point
def hierarchical_all_reduce_tree(grads, axis_name: str, h: Hierarchy, *,
                                 bits: int = 8, codec: str = "blockwise",
                                 bucket_elems: int = 0):
    """The gradient tree raveled into one f32 buffer, (bucketed,) reduced
    by :func:`hierarchical_all_reduce`, and cut back into leaves of their
    own dtypes."""
    leaves = tree_leaves(grads)
    if not leaves:
        return grads
    flat = torch.cat([l.float().reshape(-1) for l in leaves])
    padded = _pad_flat(flat, h.world * codec_unit(codec))
    reduce_1d = functools.partial(hierarchical_all_reduce,
                                  axis_name=axis_name, h=h, bits=bits,
                                  codec=codec)
    red = bucketed_reduce(padded, reduce_1d, bucket_elems)
    out, off = [], 0
    for l in leaves:
        out.append(red[off:off + l.numel()].reshape(l.shape).to(l.dtype))
        off += l.numel()
    return tree_unflatten_like(grads, out)


# --------------------------------------------------- hpZ weight gather
def hpz_weight_gather(row: torch.Tensor, axis_name: str, h: Hierarchy, *,
                      bits: int = 8, num_groups: int = 1) -> torch.Tensor:
    """qwZ's gather through the hierarchy: quantize once, gather the int8
    codes over the inter group (this payload is hpZ's secondary shard),
    gather that over the intra group, dequantize and put the rows in rank
    order -> ``[world, ...]``.  Bit for bit ``quantized_all_gather(row)``,
    the flat schedule: the codes and scales are made before any hop, on
    one grid."""
    if h.flat:
        return quantized_all_gather(row, axis_name, bits=bits,
                                    num_groups=num_groups)
    q, s, _ = quantize(row, bits=bits, num_groups=num_groups)
    qg = comm.all_gather(q, axis_name, tiled=False, group=h.inter_group)
    sg = comm.all_gather(s, axis_name, tiled=False, group=h.inter_group)
    qk = comm.all_gather(qg, axis_name, tiled=False, group=h.intra_group)
    sk = comm.all_gather(sg, axis_name, tiled=False, group=h.intra_group)
    # [k, m, ...] indexed [intra j][node n] -> dequantize -> [m, k, ...]
    deq = dequantize(qk, sk, bits=bits).transpose(0, 1)
    # rank r = n k + j lands at position r of the leading dim
    return deq.reshape((h.world,) + tuple(row.shape))
