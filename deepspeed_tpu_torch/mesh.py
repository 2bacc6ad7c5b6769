"""Mesh helpers (port of ``deepspeed_tpu/mesh.py``).

``make_mesh`` builds the named-axis ``DeviceMesh`` over the ranks of the
default process group, and ``detect_hierarchy_size`` gives the ranks per node that the two-level
collectives (:mod:`deepspeed_tpu_torch.comm.collectives`) group by.

The JAX module's ``shard_map``, ``host_device_count`` and ``install`` have
no counterpart here.  A JAX program is one process driving every chip, so
it needs ``shard_map`` to write per-device code and virtual host devices to
test it; an SPMD torch program is already one process a device, each
running its own shard, and it is tested with real ranks (gloo on the CPU).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch.distributed as dist


def make_mesh(axis_sizes: Dict[str, int], device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``{axis: size}`` in dict order over every rank of
    the default process group (global rank order, row-major, as JAX lays
    its devices).  ``device_type`` defaults to the backend's: ``"cuda"``
    under nccl, ``"cpu"`` under gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    names = tuple(axis_sizes)
    shape = tuple(int(axis_sizes[a]) for a in names)
    total = 1
    for v in shape:
        total *= v
    world = dist.get_world_size()
    if total != world:
        raise ValueError(
            f"mesh {dict(axis_sizes)} needs {total} ranks, have {world}")
    if device_type is None or dist.get_backend() == "gloo":
        # a gloo group's mesh is a CPU mesh, also when its ranks compute
        # on a GPU they share (the collectives stage CUDA tensors)
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def detect_hierarchy_size() -> int:
    """Ranks per node, for two-level collectives: the launcher's
    ``LOCAL_WORLD_SIZE`` when the ranks span more than one node, else 1 (a
    flat axis: one node has no slow tier to spare, so callers read 1 as
    "hierarchy off" rather than guess a split with no physical meaning)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    if local <= 0 or local >= world or world % local:
        return 1
    return local
