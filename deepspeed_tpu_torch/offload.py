"""Offload tiers: host memory and NVMe (port of ``deepspeed_tpu/offload.py``;
ref: deepspeed/runtime/zero/offload_config.py + runtime/swap_tensor/).

The JAX package places offloaded state with ``pinned_host`` memory-kind
shardings; the port has no memory kinds.  Its host tier is page-locked host
memory that the :class:`~deepspeed_tpu_torch.engine.TrainingEngine` keeps
the named state in at every ZeRO stage (whole leaves at stage 0, each
rank's shards from stage 1), each leaf or shard visiting the card for its
update (:func:`offload_placement` says which state an engine's config
places there).  Where the JAX package keeps the state on the device for a
backend without ``pinned_host`` memory, the port does not fall back: on
CUDA the state is page-locked (``cudaHostRegister``) or the build
raises.  The NVMe tier is :class:`NvmeSwapper`: a tree's leaves streamed
to one flat file each through the port's aio pool (:mod:`~deepspeed_tpu_
torch.io.aio`), as ``swap_tensor/partitioned_param_swapper.py`` swaps.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from deepspeed_tpu_torch._tree import (tree_leaves_with_keystr,
                                       tree_unflatten_like)


def offload_placement(config) -> Dict[str, bool]:
    """Which state the config's unscheduled offload blocks place in host
    memory: ``{"master": ..., "optimizer": ...}`` (the optimizer block
    takes the moments and the f32 master, the param block the master, as
    whole leaves at stage 0 and this rank's shards from stage 1; any
    device but ``none`` counts, as the JAX package maps both ``cpu`` and
    ``nvme`` onto host memory there)."""
    def on_host(block):
        return bool(block) and block.get("device", "cpu") not in (None,
                                                                  "none")

    z = config.zero
    opt = on_host(z.offload_optimizer)
    return {"optimizer": opt, "master": opt or on_host(z.offload_param)}


class NvmeSwapper:
    """Leaf-wise tree <-> NVMe streaming (ref: swap_tensor/
    partitioned_param_swapper.py AsyncPartitionedParameterSwapper).

    Each leaf is one flat file of its raw bytes (``ndarray.tofile``'s
    layout) under ``swap_dir``, named by the prefix and the leaf's
    ``keystr`` path; writes and reads go through the aio pool and overlap
    with compute until :meth:`wait`.  Leaves are numpy arrays or CPU
    tensors (bfloat16 too)."""

    def __init__(self, swap_dir: str, n_threads: int = 8):
        from deepspeed_tpu_torch.io.aio import AioHandle

        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        self.aio = AioHandle(n_threads=n_threads)
        self._meta: Dict[str, tuple] = {}
        self._bufs: Dict[str, Any] = {}
        self._fds: list = []

    def _path(self, name: str) -> str:
        return os.path.join(self.swap_dir, name.replace("/", "_") + ".bin")

    def _open(self, name: str, write: bool) -> int:
        fd = self.aio.open(self._path(name), write=write)
        self._fds.append(fd)
        return fd

    def swap_out(self, tree: Any, prefix: str = "state") -> None:
        """Write every leaf (asynchronously; :meth:`wait` fences)."""
        for path, leaf in tree_leaves_with_keystr(tree):
            name = prefix + path
            arr = (leaf.detach().to("cpu").contiguous()
                   if isinstance(leaf, torch.Tensor)
                   else np.ascontiguousarray(np.asarray(leaf)))
            self._meta[name] = (tuple(arr.shape), arr.dtype)
            self._bufs[name] = arr           # alive until wait()
            self.aio.pwrite(self._open(name, True), arr, 0)

    def swap_in(self, tree_like: Any, prefix: str = "state") -> Any:
        """Read the leaves back into a new tree shaped like
        ``tree_like``."""
        bufs = []
        for path, leaf in tree_leaves_with_keystr(tree_like):
            name = prefix + path
            shape, dtype = self._meta.get(
                name, (tuple(leaf.shape), leaf.dtype))
            buf = (torch.empty(shape, dtype=dtype)
                   if isinstance(dtype, torch.dtype)
                   else np.empty(shape, dtype))
            self.aio.pread(self._open(name, False), buf, 0)
            bufs.append(buf)
        self.wait()
        return tree_unflatten_like(tree_like, bufs)

    def wait(self) -> None:
        errs = self.aio.wait()
        self._bufs.clear()
        fds, self._fds = self._fds, []
        for fd in fds:
            self.aio.close(fd)
        if errs:
            raise IOError(f"{errs} NVMe swap operations failed")
