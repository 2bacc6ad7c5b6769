"""ZeRO redundancy elimination over ranks (port of ``deepspeed_tpu/
zero.py``; ref: deepspeed/runtime/zero/stage_1_and_2.py, stage3.py,
partition_parameters.py).

========  ======================  ==================  =====================
stage     optimizer state         gradients           parameters
========  ======================  ==================  =====================
0         replicated              all-reduced         replicated
1         sharded over data       all-reduced         replicated
2         sharded over data       reduce-scattered    replicated
3         sharded over data       reduce-scattered    sharded (gathered)
========  ======================  ==================  =====================

The JAX package states each column as a per-leaf sharding and lets XLA
place the collectives; the port keeps its placements (each leaf keeps its
shape and splits its largest dim that the data axis divides, else stays
whole on every rank) and issues the collectives itself: a rank's shard of
a leaf is the slice ``[r c, (r + 1) c)`` of that dim, ``c = size / W``.

A placement here is a spec tuple (an axis name or None a dim, the port's
``PartitionSpec``); :func:`shard_dim` gives the dim the engine splits.
Model-parallel placements compose as in the JAX package: ``param_specs``
(a tree of specs over ``model`` / ``pipe`` / ``expert``, or a callable
``leaf -> spec``) cuts each leaf to this rank's block
(:func:`local_shard`), and ZeRO layers the data axis onto a dim the spec
leaves free.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch._tree import tree_leaves, tree_unflatten_like
from deepspeed_tpu_torch.topology import (FusedSpec, MeshSpec, Spec,
                                          ZERO_AXES, _pick_dim, fused_parts,
                                          shard_leaf_spec)

logger = logging.getLogger(__name__)

SpecTree = Union[None, Callable, Any]


def _norm_spec(spec) -> Spec:
    """A leaf's spec as a tuple (None: replicated), trailing Nones kept
    as given."""
    if spec is None:
        return ()
    if not isinstance(spec, (tuple, list)):
        raise TypeError(f"a placement spec is a tuple of axis names or "
                        f"None a dim, got {spec!r}")
    return spec if isinstance(spec, FusedSpec) else tuple(spec)


def _spec_walk(params, specs, fn, out) -> None:
    """``fn(leaf, spec)`` for each leaf of ``params`` in tree order, the
    spec read from the same place of ``specs`` (a tree of specs, a
    callable ``leaf -> spec`` or None).  A QuantizedTensor is one leaf."""
    from deepspeed_tpu_torch.inference.quantized import _is_qt

    if params is None:
        return
    if isinstance(params, dict):
        for k in sorted(params):
            sub = specs if specs is None or callable(specs) else specs[k]
            _spec_walk(params[k], sub, fn, out)
    elif isinstance(params, (list, tuple)) and not _is_qt(params):
        for i, v in enumerate(params):
            sub = specs if specs is None or callable(specs) else specs[i]
            _spec_walk(v, sub, fn, out)
    else:
        spec = specs(params) if callable(specs) else specs
        out.append(fn(params, _norm_spec(spec)))


def spec_leaves(params: Any, param_specs: SpecTree = None) -> List[Spec]:
    """The spec of each leaf of ``params`` in :func:`tree_leaves` order (a
    QuantizedTensor counts once)."""
    out: list = []
    _spec_walk(params, param_specs, lambda _, sp: sp, out)
    return out


def resolve_specs(params: Any, param_specs: SpecTree = None) -> Any:
    """Normalize ``param_specs`` (None | callable ``leaf -> spec`` | a tree
    of specs shaped like ``params``) to a tree of spec tuples shaped like
    ``params``, ``()`` (replicated) where a spec is None (JAX's
    ``resolve_specs``)."""
    if params is None:
        return param_specs
    return tree_unflatten_like(params, spec_leaves(params, param_specs))


def _axis_entries(entry) -> tuple:
    """The axis names of one spec entry (a name, a tuple of them, None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> tuple:
    """Every axis name a spec places a dim over."""
    return tuple(a for e in spec for a in _axis_entries(e))


def _entry_index(entry, ms: MeshSpec) -> Tuple[int, int]:
    """(ways, this rank's index) of the axes of one spec entry, major to
    minor, as JAX lays a tuple entry."""
    ways, idx = 1, 0
    for a in _axis_entries(entry):
        ways, idx = ways * ms.size(a), idx * ms.size(a) + ms.rank_in(a)
    return ways, idx


def _split_runs(n: int, ways: int, idx: int, parts: int):
    """(start, length) of the runs of a dim of ``n`` that rank ``idx`` of
    ``ways`` holds: one contiguous run, or its slice of each of ``parts``
    equal parts (a :class:`~deepspeed_tpu_torch.topology.FusedSpec`)."""
    part = n // parts
    c = part // ways
    return [(p * part + idx * c, c) for p in range(parts)]


def local_shard(full, spec: Spec, ms: MeshSpec):
    """This rank's block of a whole leaf under its model-parallel spec
    (every named axis but ``data``, which is ZeRO's): a view, or a copy
    where a fused spec's split dim takes a slice of each part."""
    t = full
    parts = fused_parts(spec)
    for d, entry in enumerate(spec):
        if entry is None or "data" in _axis_entries(entry):
            continue
        ways, idx = _entry_index(entry, ms)
        if ways > 1:
            runs = _split_runs(t.shape[d], ways, idx, parts)
            t = t.narrow(d, *runs[0]) if parts == 1 else torch.cat(
                [t.narrow(d, *r) for r in runs], d)
    return t


def gather_local(t: torch.Tensor, spec: Spec, ms: MeshSpec) -> torch.Tensor:
    """The whole leaf from every rank's :func:`local_shard` (each named
    axis all-gathered along its dim, minor axis first; a fused spec's
    parts put back in the leaf's order)."""
    parts = fused_parts(spec)
    for d, entry in enumerate(spec):
        if entry is None or "data" in _axis_entries(entry):
            continue
        for a in reversed(_axis_entries(entry)):
            if ms.size(a) > 1:
                t = comm.all_gather(t.contiguous(), a, axis=d)
        ways = _entry_index(entry, ms)[0]
        if parts > 1 and ways > 1:
            # [rank][part][c] -> [part][rank][c]
            shape = t.shape
            c = shape[d] // (ways * parts)
            t = t.reshape(*shape[:d], ways, parts, c, *shape[d + 1:]) \
                .transpose(d, d + 1).reshape(shape).contiguous()
    return t


def _zero_axis_size(ms: MeshSpec) -> int:
    n = 1
    for a in ZERO_AXES:
        n *= ms.size(a)
    return n


def _zero_spec(leaf, base: Spec, ms: MeshSpec) -> Spec:
    """Layer the data axis onto ``base`` for one leaf."""
    shape = tuple(getattr(leaf, "shape", ()))
    if not shape:
        return ()
    base = tuple(base or ())
    taken = list(base)[:len(shape)] + [None] * max(0, len(shape) - len(base))
    return shard_leaf_spec(shape, "data", ms.size("data"), taken=taken)


def param_shardings(params: Any, ms: MeshSpec, stage: int,
                    param_specs: SpecTree = None) -> Any:
    """Placements of the master params (stage 3 adds the data axis)."""
    shard = stage >= 3 and _zero_axis_size(ms) > 1
    out: list = []
    _spec_walk(params, param_specs,
               lambda p, sp: _zero_spec(p, sp, ms) if shard else sp, out)
    return tree_unflatten_like(params, out)


def shard_dim(shape: Sequence[int], world: int,
              spec: Spec = ()) -> Optional[int]:
    """The dim ZeRO splits a leaf of (whole) ``shape`` along over
    ``world`` ranks, or None (scalar, or nothing divides: the leaf stays
    whole), among the dims its model-parallel ``spec`` leaves free.  It is
    the dim of :func:`_zero_spec`; at ``world`` 1, where JAX's spec is
    replicated, it is the dim the same rule picks (the largest), so a
    one-rank run moves the same collectives as a wide one."""
    if not len(shape):
        return None
    taken = list(spec)[:len(shape)] + [None] * max(0, len(shape) - len(spec))
    return _pick_dim(tuple(shape), world, taken)


def take_shard(full: torch.Tensor, dim: Optional[int], rank: int,
               world: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``full`` along ``dim`` (a view; the whole
    tensor for a leaf that stays whole)."""
    if dim is None:
        return full
    c = full.shape[dim] // world
    return full.narrow(dim, rank * c, c)


def gather_shard(shard: torch.Tensor, dim: Optional[int], out=None,
                 axis: str = "data") -> torch.Tensor:
    """All-gather every rank's ``shard`` along ``dim`` into the whole leaf
    (``out`` when given, contiguous).  A leaf that stays whole is
    returned as it is."""
    if dim is None:
        if out is not None and out is not shard:
            out.copy_(shard)
            return out
        return shard
    if dim == 0 and out is not None:
        g, n = comm._resolve(axis)
        if not comm._host_staged(g, shard):
            with comm.comms_logger().record("all_gather",
                                            comm._nbytes(shard)):
                if g is None:
                    out.copy_(shard)
                else:
                    torch.distributed.all_gather_into_tensor(
                        out, shard.contiguous(), group=g)
            return out
    full = comm.all_gather(shard, axis, axis=dim)
    if out is None:
        return full.contiguous()
    out.copy_(full)
    return out


def grad_constraint(grads: List[torch.Tensor], dims: List[Optional[int]],
                    op=comm.ReduceOp.AVG,
                    axis: str = "data") -> List[torch.Tensor]:
    """Stage >= 2: each whole local gradient reduce-scattered (``op``: SUM
    or AVG) to this rank's shard along its dim; a leaf that stays whole is
    all-reduced (ref: stage_1_and_2.py ``reduce_scatter_gradients``)."""
    out = []
    for g, d in zip(grads, dims):
        if d is None:
            out.append(comm.all_reduce_(g, axis, op))
        else:
            out.append(comm.reduce_scatter(g, axis, axis=d, op=op)
                       .contiguous())
    return out


def estimate_memory(num_params: int, dp_world: int, stage: int,
                    offload_optimizer: bool = False,
                    compute_bytes: int = 2, master_bytes: int = 4,
                    activation_bytes: int = 0) -> dict:
    """Per-device memory plan for a ZeRO stage (ref:
    deepspeed/runtime/zero/stage3.py estimate_zero3_model_states_mem_needs*
    / stage_1_and_2.py estimate_zero2_model_states_mem_needs*).

    Returns bytes per device for each state class plus the total.  The
    model: bf16 compute copy (replicated below stage 3, sharded at 3),
    f32 master + two Adam moments (sharded from stage 1; on host when
    ``offload_optimizer``), grads in compute dtype (sharded from stage 2).

    That is the reference's layout, not what ``TrainingEngine`` holds.  At
    stages 1 and 2 the engine keeps the whole f32 master on every rank (as
    the JAX engine does: its params gain the data axis only at stage 3)
    beside the compute copy, and at every stage it accumulates whole f32
    grads before the exchange.  So at stages 1-2 a rank holds about
    ``4 n`` (master) + ``8 n / W`` (moments) + ``compute_bytes n`` +
    ``4 n`` (grads), more than this plan says; at stage 3 the grads are
    the ``4 n`` the plan lacks.
    """
    if not 0 <= stage <= 3:
        raise ValueError(f"stage must be 0..3, got {stage}")
    if offload_optimizer and stage == 0:
        logger.warning(
            "offload_optimizer at ZeRO stage 0 keeps the full replicated "
            "optimizer state on every host; use stage >= 1 to shard it")
    n, w = num_params, max(dp_world, 1)
    shard = lambda b: b // w
    opt = 3 * master_bytes * n                      # master + m + v
    plan = {
        "compute_params": shard(compute_bytes * n) if stage >= 3
        else compute_bytes * n,
        "gradients": shard(compute_bytes * n) if stage >= 2
        else compute_bytes * n,
        "optimizer_states": 0 if offload_optimizer
        else (shard(opt) if stage >= 1 else opt),
        "host_optimizer_states": (shard(opt) if stage >= 1 else opt)
        if offload_optimizer else 0,
        "activations": activation_bytes,
    }
    plan["device_total"] = (plan["compute_params"] + plan["gradients"]
                            + plan["optimizer_states"]
                            + plan["activations"])
    return plan


def draw_on_host(init_fn: Callable[[], Any]) -> Any:
    """Run an init thunk with the CPU as the default device of its
    factory calls."""
    with torch.device("cpu"):
        return init_fn()


def place_leaves(leaves: list, dims: List[Optional[int]], rank: int,
                 world: int, device=None,
                 dtype: Optional[torch.dtype] = None,
                 specs: Optional[List[Spec]] = None,
                 ms: Optional[MeshSpec] = None) -> list:
    """Each leaf (a tensor or an array) cut to this rank's model-parallel
    block under its spec (``specs`` over ``ms``; none by default), then to
    its slice along its ZeRO dim (whole where the dim is None), floats
    cast to ``dtype``, copied to ``device`` contiguous.  ``leaves`` is
    consumed: each entry is dropped once placed, so a host tree drawn for
    the purpose is freed leaf by leaf."""
    out = []
    for i, d in enumerate(dims):
        t = torch.as_tensor(leaves[i])
        leaves[i] = None
        if specs is not None:
            t = local_shard(t, specs[i], ms)
        t = take_shard(t, d, rank, world)
        dt = dtype if dtype is not None and t.is_floating_point() \
            else t.dtype
        out.append(t.to(device=device, dtype=dt, copy=True).contiguous())
        del t
    return out


def sharded_init(init_fn: Callable[[], Any], ms: MeshSpec, stage: int,
                 param_specs: SpecTree = None, device=None,
                 dtype: Optional[torch.dtype] = None) -> Any:
    """A parameter tree straight into this rank's placement (ref:
    partition_parameters.py ``zero.Init``): ``init_fn`` draws the tree on
    the host (:func:`draw_on_host`), then each leaf in turn is cut to this
    rank's model-parallel block (``param_specs``) and ZeRO slice (stage 3;
    whole below it), cast to ``dtype`` (floats) and moved to ``device``,
    and the host leaf dropped, so the full tree never sits on the card.
    ``TrainingEngine`` does this for a thunk ``params``."""
    world, rank = ms.size("data"), ms.rank_in("data")
    tree = draw_on_host(init_fn)
    specs = spec_leaves(tree, param_specs)
    leaves = tree_leaves(tree)
    skeleton = tree_unflatten_like(tree, [0] * len(leaves))
    del tree
    dims = [shard_dim(tuple(torch.as_tensor(l).shape), world, sp)
            if stage >= 3 else None for l, sp in zip(leaves, specs)]
    return tree_unflatten_like(
        skeleton, place_leaves(leaves, dims, rank, world, device, dtype,
                               specs, ms))


def unshard_params(shards: Any, dims: List[Optional[int]],
                   axis: str = "data") -> Any:
    """The whole leaves of a stage-3 tree, gathered one leaf at a time
    (ref: partition_parameters.py GatheredParameters)."""
    leaves = tree_leaves(shards)
    return tree_unflatten_like(
        shards, [gather_shard(s, d, axis=axis) for s, d in zip(leaves, dims)])
