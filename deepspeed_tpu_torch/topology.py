"""Process-group topology (port of ``deepspeed_tpu/topology.py``; ref:
deepspeed/utils/groups.py).

The JAX package names every parallel flavour an axis of one device mesh;
the port builds the same named axes over ``torch.distributed``'s
``DeviceMesh``, one rank a GPU, in JAX's axis order (outer to inner)
``("pipe", "data", "expert", "seq", "model")``.  Each axis's process group
is what the JAX package's collectives name by the axis: ``group("data")``
is the group ZeRO reduces over.

A process that joined no process group (one rank, no launcher) gets a mesh
of size 1 with no groups: its collectives are the identity on the one rank
(:mod:`deepspeed_tpu_torch.comm`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch.distributed as dist

AXES = ("pipe", "data", "expert", "seq", "model")
# ZeRO shards params, grads and optimizer state over the data-parallel axes.
ZERO_AXES = ("data",)
# The batch dim is split over every token-replicating axis.
BATCH_AXES = ("data", "expert")

# a placement spec: one entry a dim, an axis name or None, trailing Nones
# dropped (the port's stand-in for JAX's PartitionSpec; () is replicated)
Spec = Tuple[Optional[str], ...]


class FusedSpec(tuple):
    """A placement spec (equal to the plain tuple, JAX's ``PartitionSpec``)
    of a leaf whose split dim concatenates ``parts`` equal tensors, as a
    fused q|k|v projection does.  A rank's block is its slice of each part,
    concatenated (``[q_r | k_r | v_r]``), not one contiguous run of the
    dim, so it holds whole heads of each: the placement
    (:func:`~deepspeed_tpu_torch.zero.local_shard`) cuts it so and the
    gather (:func:`~deepspeed_tpu_torch.zero.gather_local`) restores the
    leaf's order."""

    def __new__(cls, spec, parts: int):
        self = super().__new__(cls, spec)
        self.parts = int(parts)
        return self

    def __getnewargs__(self):
        return (tuple(self), self.parts)

    def __repr__(self):
        return f"FusedSpec({tuple(self)!r}, parts={self.parts})"


def fused_parts(spec) -> int:
    """The parts a spec's split dim concatenates (1 for a plain spec)."""
    return getattr(spec, "parts", 1)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Resolved axis sizes and the live ``DeviceMesh`` (None for one
    process without a process group)."""

    sizes: Dict[str, int]
    device_mesh: Any = None

    @classmethod
    def build(cls, sizes: Dict[str, int],
              device_type: Optional[str] = None) -> "MeshSpec":
        """A mesh of ``sizes`` (missing axes 1) over every rank of the
        default process group; ``device_type`` defaults to ``"cuda"`` under
        ``nccl`` and ``"cpu"`` otherwise."""
        from deepspeed_tpu_torch.mesh import make_mesh

        full = {a: int(sizes.get(a, 1)) for a in AXES}
        if not dist.is_initialized():
            total = 1
            for v in full.values():
                total *= v
            if total != 1:
                raise ValueError(
                    f"mesh {full} needs {total} ranks, but this process "
                    "joined no process group: launch it with python -m "
                    "deepspeed_tpu_torch.launcher and call comm."
                    "init_distributed() first")
            return cls(sizes=full)
        return cls(sizes=full, device_mesh=make_mesh(full, device_type))

    # ------------------------------------------------------------ accessors
    def size(self, axis: str) -> int:
        return self.sizes[axis]

    @property
    def dp_world(self) -> int:
        return self.size("data") * self.size("expert")

    def batch_index(self) -> int:
        """This rank's block of the global batch dim, which is split over
        :data:`BATCH_AXES` major to minor (JAX's ``batch_spec``)."""
        idx = 0
        for a in BATCH_AXES:
            idx = idx * self.size(a) + self.rank_in(a)
        return idx

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (None without a
        process group)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def rank_in(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def axis_ranks(self, axis: str) -> Sequence[int]:
        """The global ranks along ``axis`` through this rank, in axis
        order."""
        if self.device_mesh is None:
            return [0]
        m = self.device_mesh.mesh
        i = AXES.index(axis)
        coord = list(self.device_mesh.get_coordinate())
        coord[i] = slice(None)
        return [int(r) for r in m[tuple(coord)].reshape(-1).tolist()]


# Ambient mesh registry: the engine publishes its MeshSpec here so the
# collectives (and later model code) resolve axis names without threading
# the mesh through every call (the analogue of the reference's global
# process groups in deepspeed/utils/groups.py).
_CURRENT_MESH: Optional[MeshSpec] = None


def set_current_mesh(ms: Optional[MeshSpec]) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = ms


def current_mesh() -> Optional[MeshSpec]:
    return _CURRENT_MESH


def default_mesh(n_devices: Optional[int] = None) -> MeshSpec:
    """Every rank on the data axis (pure DP / ZeRO).  ``n_devices``, when
    given, must equal the world size: a rank cannot sit out a mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"default_mesh({n_devices}) on {world} ranks: "
                         "every rank is one device of the mesh")
    return MeshSpec.build({"data": world})


def _pick_dim(shape: Sequence[int], axis_size: int,
              taken: Sequence[Optional[str]]) -> Optional[int]:
    """The largest free dim of ``shape`` that ``axis_size`` divides (the
    first of equal sizes), or None."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if taken[i] is None and shape[i] % axis_size == 0 \
                and shape[i] >= axis_size:
            return i
    return None


def _trim(taken) -> Spec:
    taken = list(taken)
    while taken and taken[-1] is None:
        taken.pop()
    return tuple(taken)


def shard_leaf_spec(shape: Sequence[int], axis_name: str, axis_size: int,
                    taken: Sequence[Optional[str]] = ()) -> Spec:
    """A spec sharding one divisible dim of ``shape`` over ``axis_name``;
    replicated if nothing divides (JAX's rule: each array keeps its shape
    and its largest divisible dim is split, instead of the reference's
    flat 1-D partition, ref: deepspeed/runtime/zero/partition_parameters.py).
    """
    if axis_size <= 1:
        return _trim(taken)
    taken = list(taken) + [None] * (len(shape) - len(taken))
    i = _pick_dim(shape, axis_size, taken)
    if i is not None:
        taken[i] = axis_name
    return _trim(taken)
